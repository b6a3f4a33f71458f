"""Entry points of a compile check and a multi-device dry run, on the card.

Counterpart of the repository's ``__graft_entry__.py`` for the port:

- ``entry(device=None)``: the flagship WCRBF net's forward and its example
  arguments at B = 1024; called as ``forward(*args)`` it runs the fused op
  (``rbf_forward.cu`` on the card).
- ``dryrun_multichip(n_devices, workload="full", device=None)``: the DP x EP
  train step on an ``n_devices`` mesh (expert 2 when n is even, else 1),
  then the sharded goal-MPC family and the sharded Frenet NMPC lattice on
  the data axis. On CUDA it runs ``n_devices`` NCCL ranks, one per card,
  and raises when fewer cards are visible: it never moves to the CPU.
  ``device="cpu"`` runs ``n_devices`` gloo ranks on the host instead.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device


def _flagship(num_regions: int = 8, num_kernels: int = 128, device=None,
              dtype=torch.float32, seed: int = 0):
    """The flagship: a Frenet WCRBFNet at the reference's production scale
    (8 inputs, 10 control outputs, gaussian kernels), its 8 regions split
    along ey (2) x vx (2) x epsi (2); weights drawn from ``seed``."""
    from irbfn_tpu_torch.models import WCRBFNet

    splits = {0: 2, 2: 2, 6: 2}
    ranges = {
        0: (-2.0, 2.0), 1: (-0.4189, 0.4189), 2: (1.0, 7.0), 3: (-1.0, 1.0),
        4: (3.0, 7.0), 5: (-2.6, 2.6), 6: (-1.0, 1.0), 7: (-0.1, 0.1),
    }
    activation_idx = list(splits)
    lower_bounds, upper_bounds = [], []
    for d in activation_idx:
        lo, hi = ranges[d]
        edges = np.linspace(lo, hi, splits[d] + 1)
        lower_bounds.append(list(edges[:-1]))
        upper_bounds.append(list(edges[1:]))
    dimension_ranges = [list(t) for t in itertools.product(
        *[range(splits[d]) for d in activation_idx])]
    if len(dimension_ranges) != num_regions:
        raise ValueError(f"the flagship's split has {len(dimension_ranges)} "
                         f"regions, not {num_regions}")
    return WCRBFNet(
        in_features=8, out_features=10, num_kernels=num_kernels,
        basis_func="gaussian", num_regions=num_regions,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        dimension_ranges=dimension_ranges, activation_idx=activation_idx,
        delta=[15.0, 100.0, 10.0], dtype=dtype, device=device, seed=seed)


def entry(device=None):
    """The flagship's forward and its example arguments: ``forward(model,
    x)`` at B = 1024 on ``device`` (None: the card), without autograd, so
    that it runs the fused op."""
    device = resolve_device(device)
    model = _flagship(device=device).eval()
    x = torch.ones((1024, 8), dtype=torch.float32, device=device)

    def forward(model, x):
        with torch.no_grad():
            return model(x)

    return forward, (model, x)


def _dryrun_rank(n_devices: int, workload: str, device_type: str) -> dict:
    """One rank of the dry run (``launch.spawn`` starts ``n_devices``)."""
    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.parallel.datagen import (TableSolution,
                                                  solve_lattice_sharded)
    from irbfn_tpu_torch.parallel.mesh import (data_sharding, make_mesh,
                                               shard_params)
    from irbfn_tpu_torch.solvers import NMPCConfig, solve_lattice_point
    from irbfn_tpu_torch.solvers.goal_mpc import solve_goal_lattice_sharded
    from irbfn_tpu_torch.train.trainer import (create_trainer,
                                               frenet_fullint_loss,
                                               make_train_step)

    expert = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, expert=expert, device=device_type)
    device = mesh.device
    batch = 8 * n_devices
    trainer = create_trainer(shard_params(
        _flagship(num_kernels=16, device=device), mesh), lr=1e-3)
    dyn = fullscale_params(dtype=torch.float32, device=device).to_vector()
    step = make_train_step(frenet_fullint_loss, dyn, mesh=mesh)
    shard = data_sharding(mesh)
    xs = torch.linspace(-0.5, 0.5, batch * 8, dtype=torch.float32,
                        device=device).reshape(batch, 8)
    ys = torch.full((batch, 10), 0.5, dtype=torch.float32, device=device)
    loss = float(step(trainer, shard(xs), shard(ys)).loss)
    if not np.isfinite(loss):
        raise RuntimeError("the training step gave a non-finite loss")
    out = dict(mesh=dict(mesh.shape), loss=loss)
    if workload == "train_step":
        return out

    # the goal-MPC family on the data axis: goals split, family operands
    # each rank's own
    flat = make_mesh(n_devices, expert=1, device=device)
    G = 4 * n_devices
    goals = np.stack([np.linspace(0.5, 3.0, G), np.linspace(0.0, 2.0, G),
                      np.full(G, 3.0), np.linspace(-0.5, 0.5, G)],
                     axis=1).astype(np.float32)
    goal = solve_goal_lattice_sharded(3.0, goals, iters=200, mesh=flat,
                                      batch_per_device=4)
    if not np.isfinite(goal["speed"]).all():
        raise RuntimeError("the goal-MPC dry run gave non-finite speeds")

    # the Frenet NMPC lattice on the data axis, at a budget of 2 x 1
    cfg = NMPCConfig(gn_iters=2, al_outer=1)

    def nmpc_solve(r, pv):
        return TableSolution.from_solution(solve_lattice_point(r, pv, cfg),
                                           include_onehot=True)._asdict()

    n_rows = 2 * n_devices
    lat = np.zeros((n_rows, 8), np.float32)
    lat[:, 2] = np.linspace(3.0, 5.0, n_rows)  # vx_car
    lat[:, 4] = np.linspace(3.0, 5.0, n_rows)  # vx_goal
    lat[:, 7] = np.linspace(-0.05, 0.05, n_rows)  # curv
    nmpc = solve_lattice_sharded(
        nmpc_solve, lat, mesh=flat, batch_per_device=2,
        args=(fullscale_params(dtype=torch.float32, device=device),))
    if not np.isfinite(nmpc["accel"]).all():
        raise RuntimeError("the Frenet NMPC lattice dry run gave non-finite "
                           "controls")
    return dict(out, goal_mpc_conv=float(goal["converged"].mean()),
                nmpc_lattice_rows=int(nmpc["accel"].shape[0]))


def dryrun_multichip(n_devices: int, workload: str = "full",
                     device=None) -> dict:
    """The sharded training step on an ``n_devices`` mesh (DP x EP: the
    batch on ``data``, the WCRBF regions on ``expert``), then, unless
    ``workload="train_step"``, the sharded goal-MPC family and the sharded
    Frenet NMPC lattice. ``device`` None is the card: ``n_devices`` NCCL
    ranks, and a ValueError naming both counts when fewer cards are
    visible; ``"cpu"``: ``n_devices`` gloo ranks. Prints one line and
    returns rank 0's summary."""
    from irbfn_tpu_torch.parallel.launch import spawn

    device = resolve_device(device)
    res = spawn(_dryrun_rank, int(n_devices), device, int(n_devices),
                workload, device.type)[0]
    line = (f"dryrun_multichip ok: mesh={res['mesh']}, "
            f"loss={res['loss']:.6f}")
    if workload == "train_step":
        line += " (train_step only)"
    else:
        line += (f", goal_mpc_conv={res['goal_mpc_conv']:.2f}, "
                 f"nmpc_lattice_rows={res['nmpc_lattice_rows']}")
    print(line, flush=True)
    return res
