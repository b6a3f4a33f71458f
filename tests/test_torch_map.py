"""PyTorch port of the map world vs the JAX package: ``sim/map.py``, the
iTTC half of ``sim/safety.py`` and ``TrackEnv``'s occupancy-map arguments.

- The distance field: the JAX package computes it with its native exact
  transform (``native/edt.cpp``), the port with scipy's; both are exact, so
  the fields agree to 1e-5 m (measured: equal to the last f32 place).
- Sampling, tracing and clearances run in f64 on one field handed to both
  packages: 1e-12 (the tracer's 64 steps each add a rounding; measured
  ~1e-14). In f32, 99% of the rays agree to 1e-4 m and every ray to
  1 cm: a ray grazing a wall takes many short steps and has not converged
  after 64, so the f32 rounding of each step (XLA fuses multiply-adds
  where PyTorch rounds twice) moves where it stops (measured: 11 of 8,192
  rays over 1e-4 m, 5.1 mm at most).
- The map codec (PNG/PGM and the flat yaml keys) is held against Pillow and
  PyYAML, which this machine has and the card's does not: files either
  writes load equal in the other, every PNG filter type included.
- The iTTC check: the cases of ``tests/test_safety.py:44-103`` through both
  packages, exactly.
- The env in a map world: scans in the observation, the iTTC stop, the map
  and footprint collisions, in f64 to 1e-10.
"""

import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from irbfn_tpu.dynamics import f1tenth_params as jf1tenth
from irbfn_tpu.sim import TrackEnv as JEnv
from irbfn_tpu.sim import map as jmap
from irbfn_tpu.sim import observation_factory as jfactory
from irbfn_tpu.sim import safety as jsafety
from irbfn_tpu.sim import track as jtrack
from irbfn_tpu_torch.dynamics import f1tenth_params
from irbfn_tpu_torch.sim import TrackEnv, observation_factory
from irbfn_tpu_torch.sim import map as tmap
from irbfn_tpu_torch.sim import safety as tsafety
from irbfn_tpu_torch.sim import track as ttrack
from tests.test_safety import _side_distances_oracle, _ttc_oracle

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)
TOL_FIELD = 1e-5  # two exact transforms, one f32 cast each
TOL_RAYS_F32 = 1e-4  # 99% of the rays
TOL_RAYS_F32_ANY = 1e-2  # every ray
CSV = "data/Oschersleben_raceline_feasible.csv"


def _room_free(n=200, wall=4):
    free = np.zeros((n, n), bool)
    free[wall:-wall, wall:-wall] = True
    free[90:110, 60:140] = False  # a block in the middle
    return free


def _jmap_from(omap: tmap.OccupancyMap, dt=jnp.float64):
    """The port's map handed to the JAX package in ``dt``."""
    return jmap.OccupancyMap(*[jnp.asarray(t.numpy(), dt) for t in omap])


def _tmap_as(omap: tmap.OccupancyMap, dt):
    return tmap.OccupancyMap(*[t.to(dt) for t in omap])


@pytest.fixture(scope="module")
def oval():
    jt = jtrack.oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    tt = ttrack.oval_track(30.0, 15.0, n_samples=512, speed=3.0, device="cpu")
    return jt, tt, jmap.rasterize_track(jt, half_width=2.0), \
        tmap.rasterize_track(tt, half_width=2.0)


def test_torch_distance_field_matches_jax():
    free = _room_free()
    j = jmap.from_bitmap(free, 0.05, (-5.0, -5.0, 0.3))
    t = tmap.from_bitmap(free, 0.05, (-5.0, -5.0, 0.3), device="cpu")
    np.testing.assert_allclose(t.dist.numpy(), np.asarray(j.dist), rtol=0,
                               atol=TOL_FIELD)
    for a, b in zip(t[1:], j[1:]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_rasterize_track_matches_jax(oval):
    _, _, j, t = oval
    assert t.dist.shape == j.dist.shape
    np.testing.assert_array_equal(t.dist.numpy() > 0, np.asarray(j.dist) > 0)
    np.testing.assert_allclose(t.dist.numpy(), np.asarray(j.dist), rtol=0,
                               atol=TOL_FIELD)
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _points(rng, omap, n):
    """Points across the map and 5 m past its edges."""
    h, w = omap.dist.shape
    r = float(omap.resolution)
    x0, y0 = float(omap.origin_x), float(omap.origin_y)
    return (rng.uniform(x0 - 5, x0 + w * r + 5, n),
            rng.uniform(y0 - 5, y0 + h * r + 5, n))


def test_torch_sampling_and_clearances_f64(oval):
    _, _, _, t = oval
    t64 = _tmap_as(t, torch.float64)
    j64 = _jmap_from(t)
    rng = np.random.default_rng(0)
    x, y = _points(rng, t, 500)
    th = rng.uniform(-np.pi, np.pi, 500)
    tx, ty, tth = map(torch.from_numpy, (x, y, th))
    np.testing.assert_allclose(tmap.distance_at(t64, tx, ty).numpy(),
                               np.asarray(jmap.distance_at(j64, x, y)), **TOL)
    assert float(tmap.distance_at(t64, 1e3, 0.0)) == 0.0
    np.testing.assert_allclose(
        tmap.map_clearance(t64, tx, ty, 0.15).numpy(),
        np.asarray(jmap.map_clearance(j64, x, y, 0.15)), **TOL)
    np.testing.assert_allclose(
        tmap.footprint_clearance(t64, tx, ty, tth).numpy(),
        np.asarray(jmap.footprint_clearance(j64, x, y, th)), **TOL)


def _ray_poses(rng, track, n):
    s = rng.uniform(0.0, float(track.raceline.length), n)
    x, y, th = track.frenet_to_cartesian(
        torch.from_numpy(s), torch.from_numpy(rng.uniform(-1.8, 1.8, n)),
        torch.from_numpy(rng.uniform(-np.pi, np.pi, n)))
    return x.numpy(), y.numpy(), th.numpy()


@pytest.mark.parametrize("spec", [jmap.ScanSpec(),
                                  jmap.ScanSpec(n_beams=9, fov=np.pi / 2,
                                                max_range=15.0, n_iters=40)])
def test_torch_trace_rays_matches_jax(oval, spec):
    _, tt, _, t = oval
    tspec = tmap.ScanSpec(*spec)
    x, y, th = _ray_poses(np.random.default_rng(1), tt, 128)
    got = tmap.trace_rays(_tmap_as(t, torch.float64), torch.from_numpy(x),
                          torch.from_numpy(y), torch.from_numpy(th), tspec)
    want = jmap.trace_rays(_jmap_from(t), x, y, th, spec)
    assert got.shape == (128, spec.n_beams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # f32, as the env traces: both packages in f32 on the f32 field
    x32, y32, th32 = (a.astype(np.float32) for a in (x, y, th))
    with jax.enable_x64(False):
        want32 = np.asarray(jmap.trace_rays(_jmap_from(t, jnp.float32), x32,
                                            y32, th32, spec))
    got32 = tmap.trace_rays(t, *map(torch.from_numpy, (x32, y32, th32)),
                            tspec)
    assert got32.dtype == torch.float32
    err = np.abs(got32.numpy() - want32)
    assert np.quantile(err, 0.99) <= TOL_RAYS_F32, np.quantile(err, 0.99)
    assert err.max() <= TOL_RAYS_F32_ANY, err.max()


def test_torch_trace_rays_analytic_square_room():
    """tests/test_map.py's closed form: beam ranges in an empty square
    room, to 2.5 cells."""
    res, n, wall = 0.02, 400, 15
    free = np.zeros((n, n), bool)
    free[wall:-wall, wall:-wall] = True
    omap = tmap.from_bitmap(free, res, (-4.0, -4.0, 0.0), device="cpu")
    spec = tmap.ScanSpec(n_beams=9, fov=np.pi / 2, max_range=15.0)
    ranges = tmap.trace_rays(omap, 0.0, 0.0, 0.0, spec).numpy()
    angles = np.linspace(-np.pi / 4, np.pi / 4, 9)
    expected = 3.7 / np.maximum(np.abs(np.cos(angles)),
                                np.abs(np.sin(angles)))
    np.testing.assert_allclose(ranges, expected, atol=2.5 * res)


# ----------------------------------------------------------------- codec

def _pillow_png(img: np.ndarray, mode: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _png_with_filters(grey: np.ndarray, filters) -> bytes:
    """A grey 8-bit PNG whose row r uses filter ``filters[r % len]``
    (the encoder side of every filter type, for the decoder's test)."""
    h, w = grey.shape
    rows, prev = [], np.zeros(w, np.int64)
    for r in range(h):
        cur = grey[r].astype(np.int64)
        f = filters[r % len(filters)]
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            out = cur - pred
        rows.append(bytes([f]) + (out % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


IMAGES = ["L", "LA", "RGB", "RGBA", "PGM", "filters"]


@pytest.mark.parametrize("kind", IMAGES)
def test_torch_image_reader_matches_pillow(kind, tmp_path):
    rng = np.random.default_rng(3)
    h, w = 37, 53
    path = tmp_path / "img"
    if kind == "filters":
        grey = rng.integers(0, 256, (h, w)).astype(np.uint8)
        path.write_bytes(_png_with_filters(grey, [0, 1, 2, 3, 4]))
    elif kind == "PGM":
        grey = rng.integers(0, 256, (h, w)).astype(np.uint8)
        Image.fromarray(grey, "L").save(path, format="PPM")
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[kind]
        pix = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
        path.write_bytes(_pillow_png(pix[..., 0] if ch == 1 else pix, kind))
    want = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(tmap.read_image(str(path)), want)


def test_torch_png_writer_loads_in_pillow(tmp_path):
    grey = np.random.default_rng(4).integers(0, 256, (41, 29)).astype(
        np.uint8)
    tmap.write_png(str(tmp_path / "g.png"), grey)
    img = Image.open(tmp_path / "g.png")
    assert img.mode == "L"
    np.testing.assert_array_equal(np.asarray(img), grey)


@pytest.mark.parametrize("mode", ["I;16", "P", "1"])
def test_torch_image_reader_refuses_other_formats(mode, tmp_path):
    img = Image.new(mode, (8, 8))
    img.save(tmp_path / "x.png")
    with pytest.raises(ValueError, match="unsupported PNG"):
        tmap.read_image(str(tmp_path / "x.png"))


def test_torch_map_yaml_both_directions(tmp_path):
    """A map written by the JAX package (PyYAML block lists, Pillow's PNG)
    loads in the port as in JAX; one the port writes loads in JAX."""
    free = _room_free()
    res, origin = 0.05, (-5.0, -5.25, 0.0)
    jpath = str(tmp_path / "jax_map.yaml")
    jmap.save_map_yaml(free, res, origin, jpath)
    want = jmap.load_map_yaml(jpath)
    got = tmap.load_map_yaml(jpath, device="cpu")
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               rtol=0, atol=TOL_FIELD)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tpath = str(tmp_path / "torch_map.yaml")
    tmap.save_map_yaml(free, res, origin, tpath)
    back = jmap.load_map_yaml(tpath)
    np.testing.assert_allclose(np.asarray(back.dist), np.asarray(want.dist),
                               rtol=0, atol=0)
    import yaml

    with open(tpath) as f:
        spec = yaml.safe_load(f)
    assert spec["origin"] == list(origin) and spec["resolution"] == res
    assert tmap.read_map_yaml(jpath)["origin"] == ["-5.0", "-5.25", "0.0"]


def test_torch_map_yaml_negate_and_flow_lists(tmp_path):
    free = _room_free(64, 3)
    img = np.where(free, 0, 255).astype(np.uint8)[::-1]  # negated file
    Image.fromarray(img).save(tmp_path / "neg.png")
    (tmp_path / "neg.yaml").write_text(
        "image: 'neg.png'   # a comment\nresolution: 0.1\n"
        "origin: [-1.5, 2.0, 0.0]\nnegate: 1\noccupied_thresh: 0.65\n"
        "free_thresh: 0.196\n")
    got = tmap.load_map_yaml(str(tmp_path / "neg.yaml"), device="cpu")
    want = jmap.load_map_yaml(str(tmp_path / "neg.yaml"))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               rtol=0, atol=TOL_FIELD)
    assert (got.dist.numpy() > 0).sum() == free.sum()
    (tmp_path / "bad.yaml").write_text("image: a.png\nresolution:\n"
                                       "  nested: 1\norigin: [0, 0, 0]\n")
    with pytest.raises(ValueError, match="flat"):
        tmap.read_map_yaml(str(tmp_path / "bad.yaml"))


@pytest.mark.parametrize("which", ["raceline", "centerline"])
def test_torch_raceline_from_csv_bit_equal(which, tmp_path):
    path = CSV
    if which == "centerline":
        t = np.linspace(0, 2 * np.pi, 90, endpoint=False)
        xy = np.stack([12 * np.cos(t), 7 * np.sin(t), np.full_like(t, 1.1),
                       np.full_like(t, 0.9)], -1)
        path = str(tmp_path / "c.csv")
        np.savetxt(path, np.vstack([xy, xy[:1]]), delimiter=",",
                   header="x_m,y_m,w_tr_right_m,w_tr_left_m")
    j = jmap.raceline_from_csv(path)
    t = tmap.raceline_from_csv(path, device="cpu")
    for a, b in zip(t, j):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_load_track_bundle_matches_jax(oval, tmp_path):
    jt, _, jm, _ = oval
    bundle = tmp_path / "ovl"
    bundle.mkdir()
    jmap.save_map_yaml(np.asarray(jm.dist) > 0, float(jm.resolution),
                       (float(jm.origin_x), float(jm.origin_y), 0.0),
                       str(bundle / "ovl_map.yaml"))
    import shutil

    shutil.copy(CSV, bundle / "ovl_raceline.csv")
    jtr, jom = jmap.load_track_bundle(str(bundle))
    ttr, tom = tmap.load_track_bundle(str(bundle), device="cpu")
    for a, b in zip(ttr.raceline, jtr.raceline):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tom.dist.numpy(), np.asarray(jom.dist),
                               rtol=0, atol=TOL_FIELD)
    with pytest.raises(FileNotFoundError):
        tmap.load_track_bundle(str(bundle), name="other", device="cpu")


# ---------------------------------------------------------------- safety

def test_torch_beam_geometry_matches_jax_and_the_reference():
    for n_beams, fov in ((54, 4.7), (64, 4.7), (3, 0.2)):
        j = jsafety.beam_geometry(n_beams, fov)
        t = tsafety.beam_geometry(n_beams, fov, dtype=torch.float64,
                                  device="cpu")
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    _, _, side = tsafety.beam_geometry(54, 4.7, dtype=torch.float64,
                                       device="cpu")
    np.testing.assert_allclose(
        side.numpy(), _side_distances_oracle(54, 4.7, 0.31, 0.3302),
        rtol=1e-5)


def test_torch_ttc_matches_jax_and_the_reference_loop():
    rng = np.random.default_rng(0)
    _, cos, side = tsafety.beam_geometry(32, 4.7, dtype=torch.float64,
                                         device="cpu")
    scans = side.numpy() + rng.uniform(-0.02, 3.0, size=(64, 32))
    vels = rng.uniform(-4.0, 8.0, size=64)
    vels[:4] = 0.0
    got = tsafety.ttc_in_collision(torch.from_numpy(scans),
                                   torch.from_numpy(vels), cos, side, 0.1)
    jcos, jside = (jnp.asarray(a.numpy()) for a in (cos, side))
    want = jsafety.ttc_in_collision(jnp.asarray(scans), jnp.asarray(vels),
                                    jcos, jside, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [
        _ttc_oracle(scans[i], vels[i], cos.numpy(), side.numpy(), 0.1)
        for i in range(64)])
    # head-on at a wall: collision iff (range - nose) / v < thresh
    _, c3, s3 = tsafety.beam_geometry(3, 0.2, width=0.3, lf=0.15, lr=0.15,
                                      dtype=torch.float64, device="cpu")
    scan = torch.tensor([10.0, float(s3[1]) + 0.05, 10.0],
                        dtype=torch.float64)
    assert bool(tsafety.ttc_in_collision(scan, 10.0, c3, s3, 0.01))
    assert not bool(tsafety.ttc_in_collision(scan, 1.0, c3, s3, 0.01))
    assert not bool(tsafety.ttc_in_collision(torch.zeros(3), 0.0, c3, s3,
                                             0.01))


# ------------------------------------------------------------- map world

def _room_envs(**kw):
    free = np.zeros((200, 200), bool)
    free[4:-4, 4:-4] = True
    origin = (-5.0, -5.0, 0.0)
    tm = tmap.from_bitmap(free, 0.05, origin, torch.float64, "cpu")
    jm = _jmap_from(tm)
    jt = jtrack.oval_track(n_samples=128, speed=3.0)
    tt = ttrack.oval_track(n_samples=128, speed=3.0, device="cpu")
    jkw = {k: (jmap.ScanSpec(*v) if k == "scan_spec" else v)
           for k, v in kw.items()}
    return (JEnv(jt, jf1tenth(dtype=jnp.float64), occ_map=jm, **jkw),
            TrackEnv(tt, f1tenth_params(dtype=torch.float64, device="cpu"),
                     occ_map=tm, **kw))


def _sim_pair(jenv, tenv, x0):
    js = jenv.reset(batch_shape=(len(x0),), speed0=0.5)
    js = js._replace(x=jnp.asarray(x0), done=jnp.zeros(len(x0), bool))
    ts = tenv.reset(batch_shape=(len(x0),), speed0=0.5)
    ts = ts._replace(x=torch.from_numpy(x0),
                     done=torch.zeros(len(x0), dtype=torch.bool))
    return js, ts


def test_torch_env_scan_and_ttc_stop_match_jax():
    """tests/test_map.py's head-on case through both packages: a car driving
    at the east wall is stopped by iTTC before impact, a slow car in the
    middle is not; scans ride in the observations and the StepRecord."""
    spec = tmap.ScanSpec(n_beams=32)
    jenv, tenv = _room_envs(scan_spec=spec, enable_ttc=True, ttc_thresh=0.1)
    x0 = np.array([[3.0, 0.0, 0.0, 6.0, 0.0, 0.0, 0.0],
                   [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]])
    js, ts = _sim_pair(jenv, tenv, x0)
    act = np.zeros((2, 2))
    hit = None
    for k in range(30):
        jo, to = jenv.observe(js), tenv.observe(ts)
        np.testing.assert_allclose(to.scan.numpy(), np.asarray(jo.scan),
                                   rtol=1e-10, atol=1e-10)
        js = jenv.step(js, jnp.asarray(act), jo.scan)
        ts = tenv.step(ts, torch.from_numpy(act), to.scan)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        if bool(ts.done[0]) and hit is None:
            hit = k
    assert hit is not None and not bool(ts.done[1])
    assert float(ts.x[0, 3]) == 0.0 and float(ts.x[0, 0]) < 4.8
    # the step traces the scan itself when none is passed
    js2, ts2 = _sim_pair(jenv, tenv, x0)
    for _ in range(8):
        js2 = jenv.step(js2, jnp.asarray(act))
        ts2 = tenv.step(ts2, torch.from_numpy(act))
    np.testing.assert_array_equal(ts2.done.numpy(), np.asarray(js2.done))
    _, traj = tenv.rollout(ts, lambda o: torch.zeros(o.ey.shape + (2,),
                                                     dtype=torch.float64), 3)
    assert traj.obs.scan.shape == (3, 2, 32)


@pytest.mark.parametrize("footprint", [None, (0.58, 0.31)])
def test_torch_env_map_collision_matches_jax(footprint):
    """Steering into the wall ends the episode in both packages at the
    same step: the disc (car_radius) and the rectangle footprint."""
    jenv, tenv = _room_envs(car_radius=0.15, car_footprint=footprint)
    x0 = np.array([[3.0, 0.0, 0.0, 3.0, 0.0, 0.0, 0.0],
                   [-0.5, 3.0, 0.0, 2.0, 1.4, 0.0, 0.0]])
    js, ts = _sim_pair(jenv, tenv, x0)
    act = np.array([[0.0, 0.0], [1.0, 0.0]])
    ends = []
    for _ in range(40):
        js = jenv.step(js, jnp.asarray(act))
        ts = tenv.step(ts, torch.from_numpy(act))
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=1e-10, atol=1e-10)
        ends.append(ts.done.numpy().copy())
    assert np.stack(ends)[-1].all() and not np.stack(ends)[0].any()
    with pytest.raises(ValueError, match="require an occ_map"):
        TrackEnv(tenv.track, tenv.params, scan_spec=tmap.ScanSpec())


def test_torch_observation_factory_matches_jax():
    jenv, tenv = _room_envs(scan_spec=tmap.ScanSpec(n_beams=8))
    x0 = np.array([[1.0, 0.5, 0.1, 2.0, 0.3, 0.2, 0.05]])
    js, ts = _sim_pair(jenv, tenv, x0)
    jo, to = jenv.observe(js), tenv.observe(ts)
    for obs_type, kw in (("original", {}), ("kinematic_state", {}),
                         ("dynamic_state", {}),
                         ("frenet_dynamic_state", dict(sim=True)),
                         ("features", dict(features=["ey", "scan"]))):
        jkw = {k: (js if k == "sim" else v) for k, v in kw.items()}
        tkw = {k: (ts if k == "sim" else v) for k, v in kw.items()}
        jd = jfactory(jo, obs_type, **jkw)
        td = observation_factory(to, obs_type, **tkw)
        assert list(td) == list(jd), obs_type
        for k in td:
            np.testing.assert_allclose(np.asarray(td[k]), np.asarray(jd[k]),
                                       rtol=1e-12, atol=1e-12, err_msg=k)
    with pytest.raises(ValueError, match="features list"):
        observation_factory(to, "features")
    with pytest.raises(ValueError, match="Invalid observation type"):
        observation_factory(to, "nope")
    with pytest.raises(KeyError):
        observation_factory(to, features=["lap_time"])
