"""The port's profiling tools (``utils/profiling.py``, ``ops/fma_ceiling.py``)
on the CPU, against the JAX package's helpers and scripts.

- ``time_fn`` and ``throughput`` return the keys of the JAX package's
  (``irbfn_tpu/utils/profiling.py``); ``trace`` writes a trace and
  ``debug_nans`` raises on a backward that makes a NaN.
- ``--parts trajgen``: the goals are ``scripts/profile_throughput.py``'s
  draws, and its paths' outputs at B=16 (and 500) are the JAX package's
  ``solve_g1_lattice`` and ``sample_path(..., n_points=9)`` in f32, at
  ``tests/test_torch_clothoid.py``'s f32 tolerances: k0..k3 1e-6 absolute
  and relative, the length 3e-5; on the 9-point path x, y and theta 3e-5
  (a point moves as far as the length's error, and theta by |kappa| <= 1
  times it) and kappa 1e-6 (measured: 6.2e-6, 1.4e-6 and 3e-7).
- The plain FMA chain returns a finite rate, and the chain agrees with its
  closed form; ``count_ops`` tallies by its rule.
- ``--reps`` and ``--trace_dir`` parse with ``scripts/profile_nmpc.py``'s
  meanings (``--parts nmpc`` needs the card), and ``traced_solve`` writes
  the trace of a solve on the CPU at a tiny batch.
- The device time sums kernels only: the device-side copies of the port's
  spans (user annotations) are left out, so a family's device time cannot
  exceed its wall time once ``profile_family`` turns the spans on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics.spiral import sample_path as j_sample_path
from irbfn_tpu.solvers import solve_g1_lattice as j_solve_g1_lattice
from irbfn_tpu.utils import profiling as jprof
from irbfn_tpu_torch.ops import fma_ceiling
from irbfn_tpu_torch.utils import profiling as tprof
from irbfn_tpu_torch.utils import spans

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "irbfn_tpu_torch", "assets")
TOL_PARAMS = np.array([1e-6, 1e-6, 1e-6, 1e-6, 3e-5])  # k0..k3, length
TOL_PATH = np.array([3e-5, 3e-5, 3e-5, 1e-6])  # x, y, theta, kappa


def test_time_fn_and_throughput_keys_are_the_jax_package_s():
    j = jprof.time_fn(lambda x: x * 2.0, jnp.ones(4), warmup=1, iters=3)
    t = tprof.time_fn(lambda x: x * 2.0, torch.ones(4), warmup=1, iters=3)
    assert set(t) == set(j) and t["iters"] == 3
    assert 0 < t["p10_s"] <= t["median_s"] <= t["p90_s"]
    jt = jprof.throughput(lambda x: x * 2.0, jnp.ones(4), items=4, iters=3)
    tt = tprof.throughput(lambda x: x * 2.0, torch.ones(4), items=4, iters=3,
                          sync="fetch")
    assert set(tt) == set(jt)
    assert tt["items_per_s"] == pytest.approx(4 / tt["median_s"])


def test_trace_and_debug_nans(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sin().sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any("sin" in e.key for e in prof.key_averages())
    x = torch.tensor([0.0], requires_grad=True)
    with tprof.debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    torch.sqrt(x * 0.0 - 1.0).sum().backward()  # off again


def test_trajgen_goals_are_the_jax_script_s_draws():
    rng = np.random.default_rng(0)
    ref = np.column_stack([
        rng.uniform(8, 20, 500), rng.uniform(-4, 4, 500),
        rng.uniform(-0.8, 0.8, 500)]).astype(np.float32)
    np.testing.assert_array_equal(tprof.trajgen_goals(500), ref)


@pytest.mark.parametrize("batch", [16, 500])
def test_trajgen_paths_match_the_jax_script_s(batch):
    g = tprof.trajgen_goals(batch)
    paths = tprof.trajgen_paths("cpu")
    t_params = paths["clothoid_solver"](torch.as_tensor(g)).numpy()
    t_path = paths["solve_plus_integrate"](torch.as_tensor(g)).numpy()
    with jax.enable_x64(False):
        j_params = np.asarray(j_solve_g1_lattice(jnp.asarray(g)))
        j_path = np.asarray(j_sample_path(j_solve_g1_lattice(jnp.asarray(g)),
                                          n_points=9))
    assert t_params.dtype == j_params.dtype == np.float32
    assert t_path.shape == j_path.shape == (batch, 9, 4)
    for c, tol in enumerate(TOL_PARAMS):
        np.testing.assert_allclose(t_params[:, c], j_params[:, c], rtol=1e-6,
                                   atol=tol, err_msg=f"param {c}")
    for c, tol in enumerate(TOL_PATH):
        np.testing.assert_allclose(t_path[..., c], j_path[..., c], rtol=0,
                                   atol=tol, err_msg=f"path column {c}")


def test_trajgen_main_on_the_cpu(capsys):
    rec = tprof.main(["--parts", "trajgen", "--device", "cpu", "--batch",
                      "16", "--c2", "2", "--config_f",
                      os.path.join(ASSETS, "clothoid_pr.json"), "--ckpt",
                      os.path.join(ASSETS, "clothoid_pr.npz")])
    assert set(rec) == {f"trajgen_{n}_16" for n in (
        "clothoid_solver", "solve_plus_integrate", "net_forward")}
    assert all(np.isfinite(v) and v > 0 for v in rec.values())
    out = capsys.readouterr().out
    assert "not a device time" in out and "B=16:" in out


def test_parts_and_device_are_checked():
    with pytest.raises(SystemExit):
        tprof.main(["--parts", "nope", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tprof.main(["--parts", "nmpc", "--device", "cpu"])


def test_nmpc_flags_parse():
    args = tprof.build_parser().parse_args(
        ["--parts", "nmpc", "--nmpc_batches", "1000", "--reps", "4",
         "--trace_dir", "tr"])
    assert (args.reps, args.trace_dir, args.nmpc_batches) == (4, "tr", "1000")
    args = tprof.build_parser().parse_args([])
    assert args.reps == 32 and args.trace_dir is None  # profile_nmpc.py's
    assert "--nmpc_batches" in tprof.build_parser().format_help()


def test_traced_solve_writes_a_trace_on_the_cpu(tmp_path):
    import dataclasses

    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.parallel.gen_nmpc_table_frenet import wide_rows
    from irbfn_tpu_torch.solvers.nmpc import NMPCConfig

    rows = torch.as_tensor(wide_rows(4, 0))
    cfg = dataclasses.replace(NMPCConfig(), gn_iters=1, al_outer=1)
    prof, wall = tprof.traced_solve(rows, fullscale_params(device="cpu"),
                                    cfg, str(tmp_path / "tr"))
    assert wall > 0.0
    with open(tmp_path / "tr" / "trace.json") as f:
        text = f.read()
    assert '"traceEvents"' in text and "aten::" in text
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


class _Row:
    def __init__(self, key, device_us, on_device=True, **flags):
        self.key = key
        self.self_device_time_total = device_us
        self.device_type = (torch.autograd.DeviceType.CUDA if on_device
                            else torch.autograd.DeviceType.CPU)
        self.__dict__.update(flags)


class _Profile:
    def __init__(self, rows):
        self.rows = rows

    def key_averages(self):
        return self.rows


def test_device_time_leaves_the_spans_annotations_out():
    """A family of 100 us of kernels under spans that cover them: the
    annotations' device rows (flagged, or, where a torch build lacks the
    flag, named by a layer of ``utils/spans.py``) add nothing."""
    prof = _Profile([
        _Row("admm_solve_kernel_family", 80.0),
        _Row("Memcpy HtoD (Pinned -> Device)", 20.0),
        _Row("lattice.family", 100.0, is_user_annotation=True),
        _Row("lattice.solve", 80.0),  # no flag on this build
        _Row("ops.admm", 80.0, is_user_annotation=False),
        _Row("aten::copy_", 20.0, on_device=False),
    ])
    assert [e.key for e in tprof._kernels(prof)] == [
        "admm_solve_kernel_family", "Memcpy HtoD (Pinned -> Device)"]
    assert tprof._device_ms(prof) == pytest.approx(0.1)


def test_the_spans_are_user_annotations_in_a_profile():
    """On this torch build the profiler flags the spans' rows as user
    annotations, the first of ``_kernels``' two tests."""
    from torch.profiler import ProfilerActivity, profile

    spans.enable(True)
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span(spans.FAMILY):
                with spans.span("lattice.solve", 0):
                    torch.ones(4).sum()
    finally:
        spans.enable(False)
        spans.reset()
    rows = {e.key: e for e in prof.key_averages()}
    for name in (spans.FAMILY, "lattice.solve"):
        assert rows[name].is_user_annotation
    assert not rows["aten::sum"].is_user_annotation


def test_plain_fma_chain_rate_is_finite():
    c = tprof.measure_ceilings("cpu", n=1 << 14, repeats=1,
                               hbm_bytes=1 << 20, iters=2)
    assert np.isfinite(c["fma_flops"]) and c["fma_flops"] > 0
    assert np.isfinite(c["hbm_bytes_per_s"]) and c["hbm_bytes_per_s"] > 0
    assert c["n"] == 1 << 14 and c["hbm_bytes"] == 1 << 20


def test_fma_chain_plain_version():
    """On a CPU tensor the wrapper takes the plain version, which is the
    chain's closed form y = a^n x + b (a^n - 1) / (a - 1) in the f32
    constants, to n steps of two roundings of half an ulp of |y| <= 2;
    other devices raise."""
    x = torch.linspace(-2.0, 2.0, 257)
    y = fma_ceiling.fma_chain(x, repeats=2)
    assert torch.equal(y, fma_ceiling.fma_chain_reference(x, 2))
    n = 2 * fma_ceiling.STEPS
    a, b = (float(np.float32(c)) for c in (fma_ceiling.A, fma_ceiling.B))
    ref = a ** n * x.double() + b * (a ** n - 1) / (a - 1)
    np.testing.assert_allclose(y.double().numpy(), ref.numpy(), rtol=0,
                               atol=n * np.finfo(np.float32).eps * 2.0)
    assert spans.counters().get("ops.fma.launches", 0) == 0
    with pytest.raises(ValueError):
        fma_ceiling.fma_chain(torch.ones(3, device="meta"))


def test_count_ops_rule():
    a, b = torch.ones(4, 5), torch.ones(5, 6)
    assert tprof.count_ops(torch.mm, a, b)[1] == 2 * 4 * 6 * 5
    assert tprof.count_ops(torch.bmm, a[None].expand(3, 4, 5),
                           b[None].expand(3, 5, 6))[1] == 3 * 2 * 4 * 6 * 5
    assert tprof.count_ops(torch.sin, a)[1] == 20
    assert tprof.count_ops(torch.sum, a)[1] == 20
    assert tprof.count_ops(lambda t: t.view(20).t().clone(), a)[1] == 0
    out, n = tprof.count_ops(lambda t: (t * 2.0 + 1.0).sum(), a)
    assert float(out) == 60.0 and n == 20 + 20 + 20


def test_newton_iteration_ops_grow_with_the_rows():
    """The NMPC iteration's tally is per row: twice the rows, twice the
    operations, up to the few that do not scale (the identity, bounds)."""
    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.parallel.gen_nmpc_table_frenet import wide_rows
    from irbfn_tpu_torch.solvers import NMPCConfig

    p, cfg = fullscale_params(device="cpu"), NMPCConfig()
    n32 = tprof.newton_iteration_ops(torch.as_tensor(wide_rows(32, 0)), p,
                                     cfg)
    n64 = tprof.newton_iteration_ops(torch.as_tensor(wide_rows(64, 0)), p,
                                     cfg)
    assert n32 > 100_000 * 32
    assert abs(n64 - 2 * n32) < 1e-3 * n64
