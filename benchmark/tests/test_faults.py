"""Each fault a cell can have, planted in the program under a run that
skips the look for a card, turns ``correct`` false; the control (the
reference in the next precision down, in the program's place) fails a
number too, and the program as it is passes."""

import pytest
import torch

from benchmark import harness
from benchmark.drivers import goal_lattice
from benchmark.tests.conftest import SMALL

SWEEP, LATTICE = "frenet_wide_pr1.sweep", "goal_mpc_pr.lattice"
SIZES = {SWEEP: "closed_loop", LATTICE: "goal_lattice"}


def _run(name, **kw):
    return harness.run_cell(name, 2**32 + 9, 0.3, False, SMALL[SIZES[name]],
                            device="cpu", **kw)


@pytest.mark.parametrize("name", [SWEEP, LATTICE])
def test_program_passes_and_control_fails(name):
    line, out = _run(name, control=True)
    assert line["correct"], line["checks"]
    limits = {k: v["limit"] for k, v in line["checks"].items()}
    ctl = out.layer["control"]
    assert any(ctl[k] > limits[k] for k in limits), ctl


def _sweep_fault(monkeypatch, fault):
    from irbfn_tpu_torch.planning.planner import IRBFNFrenetPlanner
    from irbfn_tpu_torch.sim.env import TrackEnv

    step, plan = TrackEnv.step, IRBFNFrenetPlanner.plan_batch
    if fault == "state_unchanged":
        monkeypatch.setattr(TrackEnv, "step", lambda self, sim, a, scan=None:
                            sim)
    elif fault == "half_the_batch":
        def half(self, sim, a, scan=None):
            new = step(self, sim, a, scan)
            keep = torch.arange(sim.x.shape[0]) >= sim.x.shape[0] // 2
            return new._replace(x=torch.where(keep[:, None], sim.x, new.x))
        monkeypatch.setattr(TrackEnv, "step", half)
    else:  # an answer altered where it is produced
        def altered(self, *args):
            res = plan(self, *args)
            return res._replace(accel=res.accel + 0.05)
        monkeypatch.setattr(IRBFNFrenetPlanner, "plan_batch", altered)


def _lattice_fault(monkeypatch, fault):
    from irbfn_tpu_torch.solvers import goal_mpc

    admm = goal_mpc.admm_solve
    if fault == "state_unchanged":
        monkeypatch.setattr(goal_mpc, "admm_solve",
                            lambda *a, **k: admm(*a, **{**k, "iters": 0}))
    elif fault == "half_the_batch":
        def half(q, *a, **k):
            x, rp, rd = admm(q[:, : q.shape[1] // 2].contiguous(), *a, **k)
            pad = q.shape[1] - x.shape[1]
            return (torch.cat([x, x[:, :1].expand(-1, pad, -1)], 1),
                    torch.cat([rp, rp[:, :1].expand(-1, pad)], 1),
                    torch.cat([rd, rd[:, :1].expand(-1, pad)], 1))
        monkeypatch.setattr(goal_mpc, "admm_solve", half)
    else:
        solve = goal_mpc._solve_families

        def altered(*a, **k):
            sol = solve(*a, **k)
            return sol._replace(speed=sol.speed + 0.01)
        monkeypatch.setattr(goal_mpc, "_solve_families", altered)


FAULTS = ["state_unchanged", "half_the_batch", "answer_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_sweep_fault_is_caught(monkeypatch, fault):
    _sweep_fault(monkeypatch, fault)
    line, _ = _run(SWEEP)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_lattice_fault_is_caught(monkeypatch, fault):
    _lattice_fault(monkeypatch, fault)
    line, _ = _run(LATTICE)
    assert not line["correct"], line["checks"]


def _rank_without_exchange(cell):
    """A rank of the sharded lattice whose gather returns its own block in
    every rank's place: the exchange between cards left out."""
    from irbfn_tpu_torch.parallel import datagen

    def local(t, sizes, group):
        n = sizes[0]
        if t.shape[0] < n:
            t = torch.cat([t, t[-1:].expand((n - t.shape[0],)
                                            + t.shape[1:])])
        return torch.cat([t[:m] for m in sizes])

    datagen._gather_rows = local
    return goal_lattice._rank(cell)


@pytest.mark.parametrize("exchange", [True, False])
def test_four_ranks(exchange):
    """The 4-card cell's path on four CPU processes (gloo): as it is it
    passes; with the exchange left out it fails."""
    from irbfn_tpu_torch.parallel.launch import spawn

    manifest = harness.load_manifest()
    cell = harness.resolve(manifest, "goal_mpc_pr.lattice_4chip", 2**31 + 1,
                           0.3, False, SMALL["goal_lattice"], "cpu")
    fn = goal_lattice._rank if exchange else _rank_without_exchange
    ranks = spawn(fn, 4, "cpu", cell)
    line = harness.result_line(manifest, cell,
                               goal_lattice._outcome(cell, ranks))
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"mesh_solves_per_s", "setup_s"}
    assert line["correct"] is exchange, line["checks"]
