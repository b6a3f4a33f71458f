"""The port's raceline tools (``sim/make_feasible_raceline.py``,
``sim/min_curv_raceline.py``) against the JAX package's scripts on the CPU.

The bundle is written in the test: the oval's raceline pushed 1.8 m toward
its outer wall over a bump (a pinch of 0.26 m clearance against the 0.35 m
margin), its corridor rasterized at half width 2 m, and a centerline CSV
whose width columns overstate that corridor by 0.25 m (so the
minimum-curvature line violates the true clearance at first and its boxes
are tightened). Each JAX script runs as a subprocess under
``JAX_PLATFORMS=cpu`` (their ``main()`` sets the platform themselves), at
cut sizes, all at once while the port runs the same flags with
``--device cpu``.

Tolerance: every CSV column to 1e-5 absolute. Both read the same f32
distance field, where XLA may contract a multiply-add of the bilinear read
into an FMA that PyTorch rounds twice (the last f32 place), the iterative
pushes carry that on, and the CSV rounds to 6 decimals: measured, at most
1e-6 (one unit of the printed place).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from irbfn_tpu_torch.sim import make_feasible_raceline as mf
from irbfn_tpu_torch.sim import min_curv_raceline as mc
from irbfn_tpu_torch.sim import oval_track
from irbfn_tpu_torch.sim.map import distance_at, load_map_yaml
from irbfn_tpu_torch.sim.map import rasterize_track, save_map_yaml

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_CSV = 1e-5
HALF_WIDTH = 2.0
CASES = {
    # pure EDT push: the pinch binds, the push, finishing and relaxation
    # passes all run
    "feasible_push": ("make_feasible_raceline", mf, [
        "--n_points", "400", "--push_iters", "50", "--relax_iters", "100",
        "--k_max", "0.12", "--blend_centerline", "0"]),
    # the centerline blend first (default mode)
    "feasible_blend": ("make_feasible_raceline", mf, [
        "--n_points", "300", "--push_iters", "50", "--relax_iters", "60",
        "--k_max", "0.12"]),
    "min_curv": ("min_curv_raceline", mc, [
        "--n_points", "400", "--outer", "2"]),
}


def write_pinched_oval(d, name="ovl"):
    """The bundle described above, in ``d/name``; returns its path."""
    path = os.path.join(str(d), name)
    os.makedirs(path, exist_ok=True)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device="cpu")
    omap = rasterize_track(track, half_width=HALF_WIDTH)
    save_map_yaml(omap.dist.numpy() > 0, float(omap.resolution),
                  (float(omap.origin_x), float(omap.origin_y), 0.0),
                  os.path.join(path, f"{name}_map.yaml"))
    rl = track.raceline
    c = np.stack([rl.xs.double().numpy(), rl.ys.double().numpy()], -1)
    np.savetxt(os.path.join(path, f"{name}_centerline.csv"),
               np.column_stack([c, np.full((len(c), 2), HALF_WIDTH + 0.25)]),
               delimiter=",", fmt="%.9g",
               header="x_m,y_m,w_tr_right_m,w_tr_left_m")
    s, yaw, _, length = mf.geometry(c)
    nrm = np.stack([-np.sin(yaw), np.cos(yaw)], -1)
    xy = c + (1.8 * np.exp(-0.5 * ((s - 0.3 * length) / 6.0) ** 2))[:, None] \
        * nrm
    s, yaw, k, _ = mf.geometry(xy)
    np.savetxt(os.path.join(path, f"{name}_raceline.csv"),
               np.stack([s, xy[:, 0], xy[:, 1], yaw, k,
                         np.full_like(s, 3.0)], -1),
               delimiter=";", fmt="%.9g",
               header="s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps")
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(bundle, {case: (port csv, JAX csv)}): every JAX script started at
    once, the port's runs meanwhile."""
    tmp = tmp_path_factory.mktemp("raceline")
    bundle = write_pinched_oval(tmp)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = {}
    for case, (script, _, flags) in CASES.items():
        procs[case] = subprocess.Popen(
            [sys.executable, os.path.join("scripts", f"{script}.py"),
             "--map_dir", bundle, *flags, "--out", str(tmp / f"j_{case}.csv")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for case, (_, mod, flags) in CASES.items():
        path = str(tmp / f"t_{case}.csv")
        assert mod.main(["--map_dir", bundle, *flags, "--out", path,
                         "--device", "cpu"]) == path
        out[case] = (path, str(tmp / f"j_{case}.csv"))
    for case, p in procs.items():
        _, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{case}: {stderr[-2000:]}"
    return bundle, out


def _read(path):
    with open(path) as f:
        header = f.readline()
    return header, np.loadtxt(path, delimiter=";", comments="#")


@pytest.mark.parametrize("case", sorted(CASES))
def test_csv_matches_the_jax_script(runs, case):
    _, out = runs
    th, t = _read(out[case][0])
    jh, j = _read(out[case][1])
    assert th == jh == mf.CSV_HEADER
    assert t.shape == j.shape and t.shape[1] == 6
    for col, name in enumerate(("s", "x", "y", "psi", "kappa", "vx")):
        np.testing.assert_allclose(t[:, col], j[:, col], rtol=0, atol=TOL_CSV,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_line_clears_the_margin(runs, case):
    """The written line clears the default 0.35 m margin (less 1e-3 m) on
    the map the sim collides against, and its speed stays under the
    original's."""
    bundle, out = runs
    _, t = _read(out[case][0])
    omap = load_map_yaml(os.path.join(bundle, "ovl_map.yaml"), device="cpu")
    d = distance_at(omap, torch.as_tensor(t[:, 1], dtype=torch.float32),
                    torch.as_tensor(t[:, 2], dtype=torch.float32))
    assert float(d.min()) >= 0.35 - 1e-3
    assert np.all(t[:, 5] <= 3.0 + 1e-6) and np.all(np.diff(t[:, 0]) > 0)


def test_port_reads_the_map_on_its_device(runs):
    """The clearance and its gradient come from one batched ``distance_at``
    over the point and its four neighbours: equal to five separate reads."""
    bundle, _ = runs
    omap = load_map_yaml(os.path.join(bundle, "ovl_map.yaml"), device="cpu")
    xy = np.random.default_rng(0).uniform([-20, -12], [20, 12], (64, 2))
    d, g = mf.edt_clearance_and_grad(omap, xy)
    x = torch.as_tensor(xy[:, 0], dtype=torch.float32)
    y = torch.as_tensor(xy[:, 1], dtype=torch.float32)
    np.testing.assert_array_equal(d, distance_at(omap, x, y).numpy())
    d_at = functools.partial(distance_at, omap)
    gx = (d_at(x + 0.05, y) - d_at(x - 0.05, y)) / 0.1
    gy = (d_at(x, y + 0.05) - d_at(x, y - 0.05)) / 0.1
    ref = torch.stack([gx, gy], -1).numpy()
    ref = ref / np.maximum(np.linalg.norm(ref, axis=-1, keepdims=True), 1e-9)
    np.testing.assert_array_equal(g, ref)
    assert d.dtype == np.float32 and g.dtype == np.float32


def test_box_qp_active_set_is_exact():
    """The active-set box QP against a dense KKT check on a small random
    SPD problem: bounds respected, gradient sign right on the active set,
    zero on the free set."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(12, 12))
    P = a @ a.T + 12 * np.eye(12)
    q = 10 * rng.normal(size=12)
    lo, hi = -np.ones(12), np.ones(12)
    x, conv = mc.solve_box_qp_active_set(P, q, lo, hi)
    g = P @ x + q
    assert conv
    assert np.all(x >= lo) and np.all(x <= hi)
    free = (x > lo + 1e-9) & (x < hi - 1e-9)
    np.testing.assert_allclose(g[free], 0.0, atol=1e-9)
    assert np.all(g[x <= lo + 1e-9] >= -1e-9)
    assert np.all(g[x >= hi - 1e-9] <= 1e-9)
