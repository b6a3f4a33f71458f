"""PyTorch port of the multi-agent simulator (``sim/multi_agent.py``) vs the
JAX package.

Seeded batches of four cars scattered around a point (some overlapping, any
heading; ``scripts/export_torch_ckpt.py --sim_golden``) go through both
packages.

- f64: footprints, ray distances and the agent-aware scans to 1e-10; the
  rect (SAT) and disc flags identical.
- f32 against the stored JAX scans to 1e-4 m (a ray's hit distance is a
  quotient of f32 cross products: ~1e-6 relative at 30 m); flags identical
  on every agent all of whose pairs are at least 1e-4 from a tie of the
  separating-axis test (``dist <= r1 + r2`` with the two sides equal in
  f32), and the agents nearer a tie are counted, not compared.
- The env (reset, substepped RK4, collision freezing, lidar with iTTC in
  open space, observe) stepped in both packages in f64 to 1e-10, the Frenet
  observations to 1e-6: the raceline is f32 in both packages, and values
  derived from its geometry differ in the f32 last place
  (``tests/test_torch_sim.py``).

The beam angles are f32 in both packages, and their f32 linspaces differ in
the last place (XLA folds the division by n - 1 into other products): the
f64 comparisons hand the JAX angles to the port, the f32 ones hold 1e-4 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics.params import f1tenth_params as jparams
from irbfn_tpu.sim import multi_agent as JM
from irbfn_tpu.sim import oval_track as joval_track
from irbfn_tpu.sim.map import ScanSpec as JScanSpec
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.sim import multi_agent as PM
from irbfn_tpu_torch.sim import oval_track
from irbfn_tpu_torch.sim.map import ScanSpec, linspace

torch.set_num_threads(1)
GOLDEN = "irbfn_tpu_torch/assets/sim_golden.npz"
TOL64 = dict(rtol=1e-10, atol=1e-10)
TOL_GEOM = dict(rtol=1e-6, atol=1e-6)
TOL_SCAN32_M = 1e-4
TIE = 1e-4  # |SAT margin| below which a pair's f32 flag may go either way
N = 96  # batch rows of the golden used here


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k][:N] for k in z.files if k.startswith("ma_")}


def _angles():
    return linspace(-4.7 / 2, 4.7 / 2, 64, torch.float32, "cpu")


def test_torch_multi_agent_geometry_f64_matches_jax(golden):
    x = golden["ma_x"].astype(np.float64)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    np.testing.assert_allclose(PM.footprint_vertices(xt, 0.58, 0.31).numpy(),
                               np.asarray(JM.footprint_vertices(xj, 0.58,
                                                                0.31)),
                               **TOL64)
    angles_j = jnp.linspace(-4.7 / 2, 4.7 / 2, 64, dtype=jnp.float32)
    np.testing.assert_allclose(_angles().numpy(), np.asarray(angles_j),
                               rtol=0, atol=5e-7)
    base = np.full(x.shape[:2] + (64,), 30.0)
    sj = np.asarray(JM.ray_cast_footprints(xj, jnp.asarray(base), angles_j))
    st = PM.ray_cast_footprints(xt, torch.as_tensor(base), torch.as_tensor(
        np.array(angles_j))).numpy()
    np.testing.assert_allclose(st, sj, **TOL64)
    assert (st < 30.0).mean() > 0.05  # opponents are hit
    pj, pt = jparams(dtype=jnp.float64), f1tenth_params(
        dtype=torch.float64, device="cpu")
    for model in ("rect", "discs"):
        fj = np.asarray(JM.pairwise_collisions(xj, pj,
                                               collision_model=model))
        ft = PM.pairwise_collisions(xt, pt, collision_model=model).numpy()
        np.testing.assert_array_equal(ft, fj, err_msg=model)
        assert 0.05 < ft.mean() < 0.95
    np.testing.assert_array_equal(
        PM.pairwise_collisions(xt, pt).numpy(), golden["ma_rect_f64"])


def test_torch_multi_agent_f32_matches_golden(golden):
    x = torch.as_tensor(golden["ma_x"])
    base = torch.full(x.shape[:2] + (64,), 30.0)
    np.testing.assert_allclose(
        PM.ray_cast_footprints(x, base, _angles()).numpy(),
        golden["ma_scan_f32"], rtol=0, atol=TOL_SCAN32_M)
    p = f1tenth_params(device="cpu")
    margin = golden["ma_margin_rect"]  # (N, A, A)
    eye = np.eye(margin.shape[-1], dtype=bool)
    clear = np.all((np.abs(margin) >= TIE) | eye, axis=-1)
    assert clear.mean() > 0.95
    for model in ("rect", "discs"):
        ft = PM.pairwise_collisions(x, p, collision_model=model).numpy()
        want = golden[f"ma_{model}_f32"]
        keep = clear if model == "rect" else np.ones_like(clear)
        np.testing.assert_array_equal(ft[keep], want[keep], err_msg=model)


def test_torch_ray_segment_distance_analytic():
    """A beam along +x hits a vertical segment at x = 2; misses above it;
    a beam parallel to the segment misses."""
    va = torch.tensor([2.0, -1.0], dtype=torch.float64)
    vb = torch.tensor([2.0, 1.0], dtype=torch.float64)
    z = torch.zeros((), dtype=torch.float64)
    assert float(PM.ray_segment_distance(z, z, z, va, vb)) == pytest.approx(
        2.0)
    assert np.isinf(float(PM.ray_segment_distance(z, z + 3.0, z, va, vb)))
    assert np.isinf(float(PM.ray_segment_distance(z, z, z + np.pi / 2,
                                                  va + 5.0, vb + 5.0)))


@pytest.mark.parametrize("ttc", [False, True])
def test_torch_multi_agent_env_f64_matches_jax(ttc):
    """Three cars, two overlapping at the start (they freeze), stepped
    five times; with ``enable_ttc`` the agents' open-space scans run the
    iTTC stop."""
    spec_kw = dict(n_beams=32)
    je = JM.MultiAgentEnv(joval_track(n_samples=256, speed=3.0),
                          jparams(dtype=jnp.float64), n_agents=3,
                          scan_spec=JScanSpec(**spec_kw), enable_ttc=ttc)
    pe = PM.MultiAgentEnv(oval_track(n_samples=256, speed=3.0, device="cpu"),
                          f1tenth_params(dtype=torch.float64, device="cpu"),
                          n_agents=3, scan_spec=ScanSpec(**spec_kw),
                          enable_ttc=ttc)
    pe._angles = torch.as_tensor(np.array(je._angles))  # module docstring
    s0 = np.array([0.0, 0.15, 3.0])
    sj = je.reset(s0=jnp.asarray(s0), speed0=2.0)
    st = pe.reset(s0=torch.as_tensor(s0), speed0=2.0)
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = rng.uniform([-2, -1], [4, 1], (3, 2))
        oj, ot = je.observe(sj), pe.observe(st)
        for k in ("s", "ey", "epsi", "opponent_offsets", "collided",
                  "scan"):
            tol = TOL_GEOM if k in ("s", "ey", "epsi") else TOL64
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                       **tol, err_msg=k)
        sj = je.step(sj, jnp.asarray(a))
        st = pe.step(st, torch.as_tensor(a))
        np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), **TOL64)
        np.testing.assert_array_equal(st.collided.numpy(),
                                      np.asarray(sj.collided))
        np.testing.assert_allclose(st.t.numpy(), np.asarray(sj.t), **TOL64)
    assert bool(st.collided[0]) and bool(st.collided[1])
