"""PyTorch port of the corridor lidar (``sim/lidar.py``) vs the JAX
package.

Seeded poses go through both packages' ``scan`` on the same raceline
points (the JAX oval's, decimated as ``make_scanner`` does).

- f64 to 1e-10.
- f32: every beam within 1e-5 m, except that a beam may take its first
  outside sample one sample later or earlier where that sample's f32
  distance ties the half width (a range one sample spacing, 0.16 m, apart):
  at most 0.1% of beams (the JAX package's own batched-vs-single test
  holds 1e-6 on one pose).
- The poses of ``scripts/export_torch_ckpt.py --sim_golden`` (the 1,000
  that ``chip_smoke.py`` scans on the card) against the stored JAX scans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.sim import lidar as JL
from irbfn_tpu.sim import oval_track as joval_track
from irbfn_tpu_torch.sim import lidar as PL
from irbfn_tpu_torch.sim import oval_track

torch.set_num_threads(1)
GOLDEN = "irbfn_tpu_torch/assets/sim_golden.npz"
TOL64 = dict(rtol=1e-10, atol=1e-10)
TOL32_M = 1e-5
MAX_TIE_SHARE = 1e-3


def _assert_scans32(rt, rj, spec):
    d = np.abs(rt - rj)
    step = spec.max_range / (spec.n_samples - 1)
    ties = d > TOL32_M
    assert ties.mean() <= MAX_TIE_SHARE, ties.mean()
    np.testing.assert_allclose(d[ties], step, rtol=1e-4)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("lidar")}


def _poses(rng, n):
    return np.stack([rng.uniform(-16, 16, n), rng.uniform(-9, 9, n),
                     rng.uniform(-3, 3, n)], axis=-1)


@pytest.mark.parametrize("spec", [PL.LidarSpec(),
                                  PL.LidarSpec(n_beams=17, fov=3.0,
                                               max_range=6.0, n_samples=40)])
def test_torch_scan_matches_jax(spec):
    pts = np.array(joval_track(n_samples=256).raceline.points)[::4]
    pose = _poses(np.random.default_rng(0), 40)
    jspec = JL.LidarSpec(*spec)
    rj = np.asarray(JL.scan(jnp.asarray(pts, jnp.float64), 2.0,
                            *(jnp.asarray(pose[:, i]) for i in range(3)),
                            jspec))
    rt = PL.scan(torch.as_tensor(pts, dtype=torch.float64), 2.0,
                 *(torch.as_tensor(pose[:, i]) for i in range(3)), spec)
    assert rt.shape == (40, spec.n_beams) and rt.dtype == torch.float64
    np.testing.assert_allclose(rt.numpy(), rj, **TOL64)
    with jax.enable_x64(False):
        rj32 = np.asarray(JL.scan(jnp.asarray(pts, jnp.float32), 2.0,
                                  *(jnp.asarray(pose[:, i], jnp.float32)
                                    for i in range(3)), jspec))
    rt32 = PL.scan(torch.as_tensor(pts, dtype=torch.float32), 2.0,
                   *(torch.as_tensor(pose[:, i], dtype=torch.float32)
                     for i in range(3)), spec)
    _assert_scans32(rt32.numpy(), rj32, spec)


def test_torch_scan_golden(golden):
    """32 of the golden's 1,000 poses, in both precisions."""
    n = 32
    pts, pose = golden["lidar_points"], golden["lidar_pose"][:n]
    for dt, name in ((torch.float64, "lidar_f64"), (torch.float32,
                                                    "lidar_f32")):
        rt = PL.scan(torch.as_tensor(pts, dtype=dt), 2.0,
                     *(torch.as_tensor(pose[:, i], dtype=dt)
                       for i in range(3))).numpy()
        if dt == torch.float64:
            np.testing.assert_allclose(rt, golden[name][:n], **TOL64)
        else:
            _assert_scans32(rt, golden[name][:n], PL.LidarSpec())


def test_torch_scan_chunks_give_the_same_ranges(monkeypatch):
    """Poses in chunks of one give the one-chunk result bit for bit."""
    pts = oval_track(n_samples=128, device="cpu").raceline.points
    pose = torch.as_tensor(_poses(np.random.default_rng(1), 6),
                           dtype=torch.float32)
    spec = PL.LidarSpec(n_beams=16, n_samples=32)
    whole = PL.scan(pts, 2.0, *pose.T, spec)
    monkeypatch.setattr(PL, "CHUNK_ELEMENTS", 1)
    np.testing.assert_array_equal(PL.scan(pts, 2.0, *pose.T, spec).numpy(),
                                  whole.numpy())


def test_torch_scanner_on_centerline_sees_walls():
    """The JAX package's own check: side beams see the wall at ~half width,
    the forward beam sees farther; a batch row equals its single pose."""
    track = oval_track(length=30.0, width=15.0, n_samples=256, device="cpu")
    spec = PL.LidarSpec(n_beams=32, max_range=8.0, n_samples=96)
    scanner = PL.make_scanner(track, half_width=2.0, spec=spec)
    rl = track.raceline
    r = scanner(rl.xs[0], rl.ys[0], rl.yaws[0]).numpy()
    assert r.shape == (32,)
    angles = np.linspace(-2.35, 2.35, 32)
    side = np.argmin(np.abs(angles - np.pi / 2))
    assert abs(r[side] - 2.0) < 0.5
    assert r[np.argmin(np.abs(angles))] > r[side]
    both = scanner(rl.xs[[0, 30]], rl.ys[[0, 30]], rl.yaws[[0, 30]])
    np.testing.assert_allclose(both[0].numpy(), r, atol=1e-6)


def test_torch_min_clearance_matches_jax():
    pts = np.array(joval_track(n_samples=128).raceline.points)
    xy = _poses(np.random.default_rng(2), 64)[:, :2]
    cj = np.asarray(JL.min_clearance(jnp.asarray(pts, jnp.float64), 2.0,
                                     jnp.asarray(xy[:, 0]),
                                     jnp.asarray(xy[:, 1])))
    ct = PL.min_clearance(torch.as_tensor(pts, dtype=torch.float64), 2.0,
                          torch.as_tensor(xy[:, 0]),
                          torch.as_tensor(xy[:, 1])).numpy()
    np.testing.assert_allclose(ct, cj, **TOL64)
    assert (ct > 0).any() and (ct < 0).any()
