"""The nine committed runs that only the JAX package could read until
``scripts/export_torch_ckpt.py --zoo`` exported them: the model zoo
(``arch_wcrbf_pr``, ``arch_wcrbf_shared``, ``wide_deeper``, ``wide_mlp``),
the constraint-centre net (``frenet_wide_cc``, K = 499), the learned-gate
cluster net (``frenet_wide_cluster``, R = 500, K = 10) and the 3-arm
learned bank (``bank_pr_mu{0.60,0.80,1.00}``).

- Each ``irbfn_tpu_torch/assets/<run>.npz``, loaded by the port in f64,
  gives the forward of the JAX package's ``load_model`` of
  ``configs/<run>.yaml`` + ``ckpts/<run>`` to 1e-8
  (``tests/test_torch_checkpoint.py``'s tolerance: a stale asset fails),
  and its JSON is the YAML's config.
- The port's f64 forward and ``plan_batch`` match ``<run>_golden.npz`` on
  its 256 rows, and the cluster net's gate logits on the golden's rows:
  the forward to 1e-10; the plan to 1e-9, since the raceline is f32 in
  both packages and its lookups agree to the f32 last place
  (``tests/test_torch_planner.py``'s f64 tolerance).
- The three bank arms through ``eval_adaptive --nets`` at 20 steps on the
  bundle written back from ``bank_pr_golden.npz`` match the JAX script's
  run on the same files, as ``tests/test_torch_eval_closed_loop.py`` holds
  the ``bank6`` arms.
- The plain RBF version at K = 499 on the kernel's padded layout (K
  rounded up to 512: zero centers, zero width, zero head weight, so a
  padded column's basis is phi(0) = 1 times a zero weight) gives flax's
  forward, in the default and the partial mode.
"""

import functools
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.train import load_config as jload_config
from irbfn_tpu.train import load_model as jload_model
from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
from irbfn_tpu_torch.sim import oval_track
from irbfn_tpu_torch.train import input_bounds_from_config, load_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A = os.path.join(ROOT, "irbfn_tpu_torch", "assets")
with open(os.path.join(A, "zoo.json")) as _f:
    MANIFEST = json.load(_f)  # the exporter's list, which chip_smoke reads
ZOO = tuple(MANIFEST["runs"])
TOL_ASSET = 1e-8
TOL_GOLDEN_FORWARD = 1e-10
TOL_GOLDEN_PLAN = 1e-9
TOL_LOOP = 1e-4  # the adaptive run's rewards, f32 lap progress


@functools.lru_cache(maxsize=None)
def _jax_run(run):
    """One JAX load of a run per process: (model, f64 variables, config)."""
    model, variables, config = jload_model(
        os.path.join(ROOT, "configs", f"{run}.yaml"),
        os.path.join(ROOT, "ckpts", run))
    return (model, jax.tree.map(lambda a: np.asarray(a, np.float64),
                                variables), config)


def _port(run):
    model, config = load_model(os.path.join(A, f"{run}.json"),
                               os.path.join(A, f"{run}.npz"),
                               dtype=torch.float64, device="cpu")
    return model.eval(), config


def _golden(run):
    with np.load(os.path.join(A, f"{run}_golden.npz")) as z:
        return {k: z[k] for k in z.files}


def _split(out):
    """(controls, gate logits or None) of a forward."""
    return out if isinstance(out, tuple) else (out, None)


@pytest.mark.parametrize("run", ZOO)
def test_asset_forward_equals_the_jax_load(run):
    jmodel, variables, config = _jax_run(run)
    with open(os.path.join(A, f"{run}.json")) as f:
        assert json.load(f) == config == jload_config(
            os.path.join(ROOT, "configs", f"{run}.yaml"))
    model, _ = _port(run)
    assert type(model).__name__ == config["model_class"]
    x = _golden(run)["x"].astype(np.float64)
    ref, ref_logits = _split(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out, logits = _split(model(torch.from_numpy(x)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0.0,
                               atol=TOL_ASSET)
    if ref_logits is not None:  # the cluster net's gate
        assert logits.shape == (x.shape[0], config["num_regions"])
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0.0, atol=TOL_ASSET)


@pytest.mark.parametrize("run", ZOO)
def test_port_matches_the_golden(run):
    g = _golden(run)
    model, config = _port(run)
    assert g["x"].shape == (256, 8) and g["plan_in"].shape == (256, 7)
    with torch.no_grad():
        out, logits = _split(model(torch.from_numpy(g["x"].astype(
            np.float64))))
    np.testing.assert_allclose(out.numpy(), g["forward_f64"], rtol=0.0,
                               atol=TOL_GOLDEN_FORWARD)
    assert (logits is None) == ("logits_f64" not in g)
    if logits is not None:
        n = g["logits_f64"].shape[0]
        np.testing.assert_allclose(logits[:n].numpy(), g["logits_f64"],
                                   rtol=0.0, atol=TOL_GOLDEN_FORWARD)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device="cpu")
    planner = IRBFNFrenetPlanner(
        model, track, dtype=torch.float64,
        input_bounds=input_bounds_from_config(config))
    res = planner.plan_batch(*torch.from_numpy(
        g["plan_in"].astype(np.float64)).T)
    keys = [k for k in g if k.startswith("plan_") and k != "plan_in"]
    assert sorted(keys) == ["plan_accel", "plan_steer_vel"]
    for k in keys:
        np.testing.assert_allclose(getattr(res, k[5:]).numpy(), g[k],
                                   rtol=0.0, atol=TOL_GOLDEN_PLAN, err_msg=k)
    # the six single nets carry the 1000-lane sweep that the card runs,
    # with the step count it was made at
    has_loop = not run.startswith("bank_pr")
    assert ("loop_done" in g) == ("n_steps" in g) == has_loop
    if has_loop:
        assert {g[f"loop_{k}"].shape for k in ("done", "laps", "s",
                                                "ey_mean")} == {(1000,)}
        assert int(g["n_steps"]) == 200


def test_the_manifest_names_the_nine_runs_and_the_bank():
    assert sorted(ZOO) == sorted(
        ["arch_wcrbf_pr", "arch_wcrbf_shared", "bank_pr_mu0.60",
         "bank_pr_mu0.80", "bank_pr_mu1.00", "frenet_wide_cc",
         "frenet_wide_cluster", "wide_deeper", "wide_mlp"])
    with np.load(os.path.join(A, MANIFEST["bank"])) as z:
        arms = [str(n) for n in z["nets"]]
    assert arms == ["bank_pr_mu0.60", "bank_pr_mu0.80", "bank_pr_mu1.00"]
    assert set(arms) <= set(ZOO)


def _bundle(g, d):
    """The bank golden's bundle, written back byte for byte."""
    os.makedirs(d)
    for k in g:
        if k.startswith("bundle_"):
            with open(os.path.join(d, k[len("bundle_"):]), "wb") as f:
                f.write(g[k].tobytes())
    return d


def test_bank_pr_through_eval_adaptive_matches_the_jax_script(tmp_path):
    import importlib.util

    from irbfn_tpu_torch.sim import eval_adaptive

    with np.load(os.path.join(A, MANIFEST["bank"])) as z:
        g = {k: z[k] for k in z.files}
    bundle = _bundle(g, str(tmp_path / "ovl"))
    assert sorted(os.listdir(bundle)) == ["ovl_map.png", "ovl_map.yaml",
                                          "ovl_raceline.csv"]
    mus = [str(n)[len("bank_pr_mu"):] for n in g["nets"]]
    common = ["--arm_mus", "0.6", "0.8", "1.0", "--map_dir", bundle,
              "--mus", "0.6", "1.0", "--css", "5.0", "--episodes", "2",
              "--n_steps", "20", "--baseline_rounds", "1", "--noise_scale",
              "0", "--json_out"]
    jarms = ["--nets"] + [f"configs/bank_pr_mu{m}.yaml:ckpts/bank_pr_mu{m}"
                          for m in mus]
    tarms = ["--nets"] + [f"{A}/bank_pr_mu{m}.json:{A}/bank_pr_mu{m}.npz"
                          for m in mus]
    spec = importlib.util.spec_from_file_location(
        "eval_adaptive_script", os.path.join(ROOT, "scripts",
                                             "eval_adaptive.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with jax.enable_x64(False), mock.patch.object(
            sys, "argv", ["eval_adaptive.py"] + common
            + [str(tmp_path / "j.json")] + jarms):
        mod.main()
    res = eval_adaptive.main(["--device", "cpu"] + common
                             + [str(tmp_path / "t.json")] + tarms)
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    assert set(res) == set(ref) and res["mode"] == ref["mode"] == "learned"
    np.testing.assert_allclose(res["speed_scales"], ref["speed_scales"],
                               rtol=1e-12)
    np.testing.assert_allclose(res["fixed_rewards"], ref["fixed_rewards"],
                               rtol=0, atol=TOL_LOOP)
    pulls, rewards = np.asarray(res["pulls"]), np.asarray(res["rewards"])
    assert pulls.shape == (2, 2) and ((pulls >= 0) & (pulls < 3)).all()
    # a pulled arm's reward is that arm's fixed baseline (no start noise)
    fixed = np.asarray(res["fixed_rewards"])
    np.testing.assert_allclose(rewards, fixed[pulls, np.arange(2)],
                               rtol=0, atol=1e-6)


def test_plain_rbf_on_the_padded_layout_at_k499_is_flax():
    from irbfn_tpu_torch.ops import rbf

    jmodel, variables, _ = _jax_run("frenet_wide_cc")
    model, _ = _port("frenet_wide_cc")
    model.requires_grad_(False)
    ops = rbf.wcrbf_params_to_kernel(model)
    R, K, F = ops.centers.shape
    assert K == 499 and ops.c_packed.shape == (R, 9, 512)
    FP = ops.c_packed.shape[1] - 1
    pad = rbf.RBFOperands(
        ops.c_packed[:, :F].transpose(1, 2).contiguous(),
        ops.c_packed[:, FP].contiguous(), ops.lb, ops.ub, ops.delta,
        ops.w_packed.transpose(1, 2).contiguous(), ops.b, ops.basis)
    assert float(pad.inv_sigs[:, K:].abs().max()) == 0.0
    assert float(pad.w[:, K:].abs().max()) == 0.0
    x = _golden("frenet_wide_cc")["x"].astype(np.float64)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    xs = torch.from_numpy(x) * model.input_scale
    for operands in (ops, pad):
        out = rbf.wcrbf_forward_reference(xs, operands)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0.0,
                                   atol=TOL_ASSET)
        part = rbf.wcrbf_forward_reference(xs, operands, partial=True)
        np.testing.assert_allclose(
            rbf.finish_partial(part, operands).numpy(), ref, rtol=0.0,
            atol=TOL_ASSET)


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("head_mode,flops", [
    # B R K (3F + 6 + 2O) + 8 B R F
    ("per_region", 1024 * 16 * 512 * (24 + 6 + 20) + 8 * 1024 * 16 * 8),
    # B R K (3F + 6 + 2) + 2 B K O + 8 B R F: the regions' gated basis is
    # summed before the one head product
    ("shared", 1024 * 16 * 512 * (24 + 6 + 2) + 2 * 1024 * 512 * 10
     + 8 * 1024 * 16 * 8)])
def test_chip_smoke_bound_counts_a_shared_head_once(head_mode, flops):
    from irbfn_tpu_torch.ops import rbf

    R, K, F, O = 16, 512, 8, 10
    heads = (R,) if head_mode == "per_region" else ()
    ops = rbf.RBFOperands(torch.zeros(R, K, F), torch.zeros(R, K),
                          torch.zeros(R, F), torch.zeros(R, F),
                          torch.zeros(F), torch.zeros(*heads, K, O),
                          torch.zeros(*heads, O), "gaussian")
    assert ops.per_region == (head_mode == "per_region")
    assert _smoke()._rbf_flops(1024, ops) == flops


def test_chip_smoke_reads_the_zoo_from_the_manifest():
    zoo, loops, bank = _smoke()._zoo_runs()
    assert zoo == ZOO and bank == os.path.join(A, "bank_pr_golden.npz")
    assert loops == tuple(r for r in ZOO if not r.startswith("bank_pr"))
    assert set(loops) == set(_smoke().TOL_ZOO_LOOP)


@pytest.mark.parametrize("broken,failed", [
    ({}, []),
    ({"n_done": 1}, ["done"]),
    ({"n_laps": 11}, ["laps"]),
    ({"lap_step": 2}, ["laps apart"]),
    ({"ey_mm": 10.5}, ["per-lane |ey|"]),
    ({"d_sweep_mm": 0.2}, ["sweep"])])
def test_zoo_loop_verdict_names_each_broken_limit(broken, failed):
    smoke = _smoke()
    g = _golden("frenet_wide_cc")  # held to phase 5's limits
    laps = g["loop_laps"].copy()
    laps[:broken.get("n_laps", 0)] += 1
    if "lap_step" in broken:
        laps[0] += broken["lap_step"]
    done = g["loop_done"].copy()
    done[:broken.get("n_done", 0)] ^= True
    d_ey = np.zeros(done.size)
    d_ey[0] = broken.get("ey_mm", 0.0)  # frenet_wide_cc: held at the max
    r = dict(ey=g["loop_ey_mean"], done=done, laps=laps, d_ey_mm=d_ey,
             n_done=int((done != g["loop_done"]).sum()),
             n_laps=int((laps != g["loop_laps"]).sum()),
             d_sweep_mm=broken.get("d_sweep_mm", 0.0))
    r, text, got = smoke.zoo_loop_verdict("frenet_wide_cc", r, g)
    assert got == failed, text
