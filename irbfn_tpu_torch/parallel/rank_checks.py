"""What each rank of a spawned group computes when the sharded paths are
held against the one-device ones.

``launch.spawn(run_jobs, world, device, jobs)`` runs a list of jobs on
every rank and returns each rank's results; the parity tests (gloo, on the
CPU) and ``chip_smoke.py`` (NCCL, where several cards are visible) compare
them with the unsharded results. A job is a tuple:

- ``("mesh", expert)``: the mesh's shape, this rank's coordinates, the ranks
  of its two groups and its rows of an 8-row batch;
- ``("forward", case, expert)``: the sharded model's output through the fused
  op (the kernel's partial mode on the card, its plain version on the CPU)
  and through the module path, with this rank's region range;
- ``("step", case, data, expert)``: one DP x EP train step: the global loss,
  this rank's gradients after the all_reduce (its shard of the sharded
  ones) and the clip's global norm;
- ``("epochs", case, data, expert, batch_size, epochs)``: ``train_epochs``
  on the mesh over the case's rows as a table (seed 0): the mean loss of
  the last epoch and this rank's parameters after it;
- ``("goal_lattice", v_car, goals, iters, batch_per_device)``: the sharded
  goal family and, on the same rank, ``solve_goal_lattice``;
- ``("clothoid_lattice", goals, batch_per_device)``: the G1 clothoid solve
  of a lattice through ``solve_lattice_sharded`` (a solver that returns one
  tensor) and through ``solve_lattice``;
  both with what each call moved of the ``lattice.`` counters (``moved``).

A case is a dict: ``config`` (the checkpoint config of the model),
``state`` (its numpy ``state_dict``), ``x``, ``y`` and ``extra`` (numpy;
``extra`` None or integer cluster labels), ``dtype`` ("float32" or
"float64") and ``loss`` (a loss name of ``train/trainer.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from irbfn_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                           data_sharding, make_mesh,
                                           shard_params)
from irbfn_tpu_torch.utils import spans


def _device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _model(case, device):
    from irbfn_tpu_torch.models import from_config

    dtype = getattr(torch, case["dtype"])
    model = from_config(case["config"], dtype=dtype, device=device)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=dtype)
                           for k, v in case["state"].items()})
    return model


def _np(t):
    if isinstance(t, tuple):  # ClusterWCRBFNet: (y, logits)
        t = t[0]
    return t.detach().cpu().numpy()


def _mesh_job(meshes, expert):
    try:
        mesh = meshes(expert)
    except ValueError as e:
        return {"error": str(e)}
    rows = data_sharding(mesh)(torch.arange(8))
    return {"shape": dict(mesh.shape), "rank": mesh.rank,
            "data_rank": mesh.data_rank, "expert_rank": mesh.expert_rank,
            "data_group": dist.get_process_group_ranks(
                mesh.group(DATA_AXIS)),
            "expert_group": dist.get_process_group_ranks(
                mesh.group(EXPERT_AXIS)),
            "rows": rows.numpy()}


def _forward_job(meshes, case, expert):
    mesh = meshes(expert)
    device = mesh.device
    model = shard_params(_model(case, device), mesh)
    x = torch.as_tensor(case["x"], dtype=getattr(torch, case["dtype"]),
                        device=device)
    with torch.no_grad():
        fused = model(x)
    with torch.enable_grad():
        module = model(x)
    return {"fused": _np(fused), "module": _np(module),
            "range": model.region_range(),
            "centers": tuple(model.centers.shape)}


def _trainer(meshes, case, data, expert):
    """(mesh, sharded model, its trainer, the mesh step, the case's rows)"""
    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.train import trainer as T

    mesh = meshes(expert)
    device = mesh.device
    if mesh.shape[DATA_AXIS] != data:
        raise ValueError(f"a {data} x {expert} mesh needs {data * expert} "
                         f"ranks, not {mesh.size}")
    dtype = getattr(torch, case["dtype"])
    model = shard_params(_model(case, device), mesh)
    dyn = fullscale_params(dtype=dtype, device=device).to_vector()
    step = T.make_train_step(getattr(T, case["loss"]), dyn, mesh=mesh)
    rows = [torch.as_tensor(case[k], device=device)
            for k in ("x", "y", "extra") if case.get(k) is not None]
    rows = [a.to(dtype) if a.is_floating_point() else a for a in rows]
    return mesh, model, T.create_trainer(model, lr=1e-3), step, rows


def _step_job(meshes, case, data, expert):
    mesh, model, trainer, step, args = _trainer(meshes, case, data, expert)
    norms = []
    apply = trainer.apply_gradients
    trainer.apply_gradients = lambda m=None: norms.append(apply(m))
    shard = data_sharding(mesh)
    m = step(trainer, *(shard(a) for a in args))
    return {"loss": float(m.loss), "parts": [float(a) for a in m[1:]
                                             if a is not None],
            "grads": {n: p.grad.detach().cpu().numpy()
                      for n, p in model.named_parameters()},
            "norm": float(norms[0]), "range": model.region_range()}


def _epochs_job(meshes, case, data, expert, batch_size, epochs):
    from irbfn_tpu_torch.train.trainer import train_epochs

    mesh, model, trainer, step, rows = _trainer(meshes, case, data, expert)
    _, mean = train_epochs(trainer, step, rows[0], rows[1], batch_size,
                           epochs, seed=0,
                           extra=rows[2] if len(rows) > 2 else None,
                           mesh=mesh)
    return {"mean": mean, "range": model.region_range(),
            "params": {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}}


def _lattice_calls(**calls) -> dict:
    """Each call's result by name, and under ``moved`` what each call moved
    of the ``lattice.`` counters."""
    out = {"moved": {}}
    for name, call in calls.items():
        before = spans.counters()
        out[name] = call()
        out["moved"][name] = spans.since(before, "lattice.")
    return out


def _goal_lattice_job(meshes, v_car, goals, iters, batch_per_device):
    from irbfn_tpu_torch.solvers.goal_mpc import (solve_goal_lattice,
                                                  solve_goal_lattice_sharded)

    mesh = meshes(1)
    kw = dict(iters=iters, batch_per_device=batch_per_device)
    return _lattice_calls(
        sharded=lambda: solve_goal_lattice_sharded(v_car, goals, mesh=mesh,
                                                   **kw),
        direct=lambda: solve_goal_lattice(v_car, goals, device=mesh.device,
                                          **kw))


def _clothoid_lattice_job(meshes, goals, batch_per_device):
    from irbfn_tpu_torch.parallel.datagen import (solve_lattice,
                                                  solve_lattice_sharded)
    from irbfn_tpu_torch.solvers.clothoid import solve_g1_lattice

    mesh = meshes(1)
    return _lattice_calls(
        sharded=lambda: solve_lattice_sharded(
            solve_g1_lattice, goals, mesh=mesh,
            batch_per_device=batch_per_device),
        direct=lambda: solve_lattice(
            lambda r: {"p": solve_g1_lattice(r)}, goals,
            batch_per_device=batch_per_device, device=mesh.device)["p"])


JOBS = {"mesh": _mesh_job, "forward": _forward_job, "step": _step_job,
        "epochs": _epochs_job, "goal_lattice": _goal_lattice_job,
        "clothoid_lattice": _clothoid_lattice_job}


def run_jobs(jobs) -> list:
    """Run each job (module docstring) on this rank; their results in
    order. A mesh's groups are made once, by the first job that asks for
    its expert count."""
    made = {}

    def meshes(expert):
        if expert not in made:
            made[expert] = make_mesh(expert=expert, device=_device())
        return made[expert]

    return [JOBS[job[0]](meshes, *job[1:]) for job in jobs]
