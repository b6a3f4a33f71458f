"""The port's oracle generator (``solvers/gen_test_oracles.py``) against the
JAX package's ``scripts/gen_test_oracles.py`` and its committed outputs
(``tests/oracles/*.npz``), on the CPU in f64.

- ``nmpc_fixture_rows`` is the JAX script's, bit for bit.
- The perturbation gold, derived by the port, against the committed
  ``nmpc_pert_gold.npz`` (the JAX script's output, so no JAX compile):
  ``u_star`` to 1e-6 (the port's f64 solve is 1.4e-10 from it, measured),
  ``f_star`` and every candidate's cost to 1e-8 relative, the same draws,
  and no improving candidate.
- The SLSQP derivation on 3 rows against ``nmpc_frenet_slsqp.npz`` at
  ``tests/test_nmpc_oracle.py``'s live-SLSQP tolerances (objective 1e-8
  relative, controls 1e-6), on rows the stored oracle marks feasible.
- The module writes under ``--out_dir`` and never into ``tests/oracles/``.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from irbfn_tpu_torch.solvers import gen_test_oracles as gen
from irbfn_tpu_torch.solvers.oracle import load_oracle
from scripts.gen_test_oracles import nmpc_fixture_rows as jax_fixture_rows

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLES = os.path.join(ROOT, "tests", "oracles")
N_SLSQP = 3


def _digests():
    return {f: hashlib.sha256(open(os.path.join(ORACLES, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(ORACLES))}


@pytest.fixture(scope="module")
def derived(tmp_path_factory):
    """``main`` at a cut SLSQP size on the CPU; the stored oracles' bytes
    before and after."""
    before = _digests()
    out = tmp_path_factory.mktemp("oracles")
    paths = gen.main(["--device", "cpu", "--out_dir", str(out),
                      "--n_rows", str(N_SLSQP)])
    return paths, before, _digests()


def test_fixture_rows_are_the_jax_script_s():
    np.testing.assert_array_equal(gen.nmpc_fixture_rows(), jax_fixture_rows())
    np.testing.assert_array_equal(gen.nmpc_fixture_rows(7, 3),
                                  jax_fixture_rows(7, 3))


def test_perturbation_gold_matches_the_committed_one(derived):
    paths, _, _ = derived
    got = np.load(paths["pert"])
    ref = np.load(os.path.join(ORACLES, "nmpc_pert_gold.npz"))
    assert set(got.files) == set(ref.files)
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    assert int(got["seed"]) == int(ref["seed"])
    assert int(got["n_cand"]) == int(ref["n_cand"])
    np.testing.assert_allclose(got["u_star"], ref["u_star"], rtol=0,
                               atol=1e-6)
    # the same draws around (nearly) the same solution
    np.testing.assert_allclose(got["cands"], ref["cands"], rtol=0, atol=1e-6)
    for k in ("f_star", "f_cand"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-8, err_msg=k)
    for k in ("v_star", "v_cand"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    improving = ((got["v_cand"] <= got["v_star"][:, None] + 1e-6)
                 & (got["f_cand"] < got["f_star"][:, None] - 1e-6))
    assert not improving.any()


def test_perturbation_proof_refuses_a_suboptimal_solution(monkeypatch):
    """The proof is live: a solver whose answer is off by 0.05 in every
    control is caught by its own candidates."""
    real = gen.solve_lattice_point

    def off(*a, **kw):
        sol = real(*a, **kw)
        return sol._replace(accel=sol.accel + 0.05,
                            steer_vel=sol.steer_vel + 0.05)

    monkeypatch.setattr(gen, "solve_lattice_point", off)
    with pytest.raises(RuntimeError, match="NOT optimal"):
        gen.derive_perturbation_gold("cpu")


def test_slsqp_oracle_matches_the_committed_one(derived):
    paths, _, _ = derived
    rows, live = load_oracle(paths["slsqp"])
    ref_rows, ref = load_oracle(os.path.join(ORACLES,
                                             "nmpc_frenet_slsqp.npz"))
    np.testing.assert_array_equal(rows, ref_rows[:N_SLSQP])
    feas = ref.feasible[:N_SLSQP]
    assert feas.any()
    np.testing.assert_array_equal(live.feasible, feas)
    np.testing.assert_allclose(live.objective[feas], ref.objective[:N_SLSQP]
                               [feas], rtol=1e-8)
    np.testing.assert_allclose(live.u[feas], ref.u[:N_SLSQP][feas],
                               atol=1e-6)
    z = np.load(paths["slsqp"])
    assert int(z["meta_seed"]) == gen.ORACLE_SEED


def test_never_writes_the_stored_oracles(derived):
    paths, before, after = derived
    assert before == after
    for p in paths.values():
        assert os.path.dirname(os.path.abspath(p)) != ORACLES
    assert gen.parse_args([]).out_dir == os.path.join("torch_runs",
                                                      "oracles")
