"""Training loop and losses for the WCRBF model family.

Port of ``irbfn_tpu/train/trainer.py``:

- ``pred`` loss: L1 between predicted and oracle control sequences;
- ``oneint`` loss: L1 between one-step-integrated states under predicted vs
  oracle controls, weighted x100;
- ``fullint`` loss: L1 between full 5-step rollouts;
- ``cluster`` loss: softmax cross-entropy on the gate logits;
- gradient clipping by global norm, then Adam, optionally with a cosine
  decay of the learning rate to lr/10;
- mirror augmentation of the Frenet and the cartesian table;
- the DP x EP step over a (data, expert) mesh (``parallel/mesh.py``): each
  data rank takes its contiguous rows of a batch, each expert rank holds its
  regions of the core, and the gradients are those of the global mean loss.

A loss is ``loss_fn(model, x, y, [extra,] dyn_params) -> (loss, parts)``
and differentiates through the model's module path
(``models/wcrbf.py:WCRBFNet.forward``: autograd is recording and the
parameters require gradients, so no kernel is launched). ``dyn_params`` is
the 13-float vehicle vector (``VehicleParams.to_vector()``) or a
``VehicleParams``.

The optimizer matches the JAX package's chain (clip by global norm, then
Adam on the schedule) step for step: PyTorch's Adam has the same bias
correction and the same ``eps = 1e-8`` outside the square root, the
schedule is read at the count of steps already taken (0 for the first),
and the clip comes before the step. The clip is the JAX package's rule
(``clip_by_global_norm_`` below) and not ``clip_grad_norm_``, which divides
by ``norm + 1e-6``: with it, five clipped f64 steps at lr 1e-2 ended 7e-8
away from the JAX package's weights.

The mesh step writes out what XLA inserts for JAX's sharded step. Every rank
back-propagates its own loss over ``mesh.size``. The expert ``all_reduce``
of the forward sums the gradients of its output over the expert group in
its backward (``models/wcrbf.py:expert_sum``), so the expert ranks' equal
losses are counted once each; a rank's gradient is then its share of the
gradient of the global mean loss. The shares are summed over the ranks that
hold the parameter: over the whole world for a replicated one (heads and
gate layers, whose rows each expert rank touches for its own regions only),
over the data axis for a sharded one (``centers``, ``log_sigs``). The clip
reads the norm of the whole parameter set: the sharded parameters' squared
norms summed over the expert group, the replicated ones counted once.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.frenet import frenet_onestep, integrate_frenet
from irbfn_tpu_torch.dynamics.single_track import integrate_st
from irbfn_tpu_torch.dynamics.spiral import integrate_endpoint_gl
from irbfn_tpu_torch.models.wcrbf import overlapping_segments
from irbfn_tpu_torch.sim.track import wrap_angle
from irbfn_tpu_torch.utils import prng


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, sharded=None,
                         group=None) -> torch.Tensor:
    """Scale the gradients of ``params`` in place so that their global
    2-norm is at most ``max_norm``: unchanged when the norm is below it,
    else ``g / norm * max_norm``. Returns the norm (a tensor: nothing here
    waits for the device). With an expert ``group``, ``sharded[i]`` marks
    the parameters each rank holds a shard of: their squared norms are
    summed over the group, the others counted once."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:
        flags = [f for p, f in zip(params, sharded) if p.grad is not None]
        sq = torch.stack([torch.linalg.vector_norm(g) ** 2 for g in grads])
        mask = torch.tensor(flags, device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(part, group=group)
        norm = torch.sqrt(torch.where(mask, torch.zeros_like(sq), sq).sum()
                          + part)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class Trainer:
    """A model with its Adam optimizer, the clip before each step and the
    optional cosine decay: the counterpart of the JAX package's train
    state. Parameters with ``requires_grad=False`` (frozen centers or
    widths) are left out of the optimizer."""

    def __init__(self, model, lr: float = 1e-3, max_grad_norm: float = 1.0,
                 decay_steps: Optional[int] = None):
        self.model = model
        self.max_grad_norm = float(max_grad_norm)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer = torch.optim.Adam(self.params, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = None
        if decay_steps is not None:
            # the JAX package's cosine decay schedule (alpha=0.1)
            def factor(count, n=int(decay_steps), alpha=0.1):
                cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, n) / n))
                return (1.0 - alpha) * cosine + alpha

            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, factor)
        self.step_count = 0

    def apply_gradients(self, mesh=None):
        """Clip the accumulated gradients by their global norm, then one
        Adam step (and one step of the schedule). With a ``mesh``, the
        gradients are first summed over the ranks that hold each parameter
        (module docstring). Returns the norm."""
        if mesh is None or mesh.group() is None:
            norm = clip_by_global_norm_(self.params, self.max_grad_norm)
        else:
            norm = self._reduce_and_clip(mesh)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step_count += 1
        return norm

    def _reduce_and_clip(self, mesh):
        from irbfn_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                                   SHARDED,
                                                   wcrbf_param_sharding)

        specs = wcrbf_param_sharding(mesh)(self.model)
        held = getattr(self.model, "expert_shard", None) is not None
        sharded = [held and specs[n] == SHARDED for n in self.names]
        with torch.no_grad():
            for p, s in zip(self.params, sharded):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad,
                                group=mesh.group(DATA_AXIS if s else None))
        group = (mesh.group(EXPERT_AXIS) if held
                 and mesh.shape[EXPERT_AXIS] > 1 else None)
        return clip_by_global_norm_(self.params, self.max_grad_norm,
                                    sharded, group)


def create_trainer(model, lr: float = 1e-3, max_grad_norm: float = 1.0,
                   decay_steps: Optional[int] = None) -> Trainer:
    """``decay_steps``: cosine-decay the lr to lr/10 over this many steps
    (fine-tune runs plateau at a constant lr)."""
    return Trainer(model, lr=lr, max_grad_norm=max_grad_norm,
                   decay_steps=decay_steps)


def mirror_frenet_table(inputs: np.ndarray, outputs: np.ndarray,
                        exact: bool = True):
    """Mirror augmentation. inputs (N, 8), outputs (N, 2T).

    ``exact=True`` (default) applies the dynamics' true reflection symmetry:
    every lateral quantity flips, [ey, delta, vy, wz, epsi, curv] and the
    steer-vel outputs. ``exact=False`` flips only (ey, epsi, sv), the
    reference trainer's approximation, which injects wrong-problem rows
    whenever delta/vy/wz/curv are nonzero."""
    T = outputs.shape[1] // 2
    flip = (np.array([-1, -1, 1, -1, 1, -1, -1, -1]) if exact
            else np.array([-1, 1, 1, 1, 1, 1, -1, 1]))
    in_m = inputs * flip
    out_m = np.concatenate([outputs[:, :T], -outputs[:, T:]], axis=1)
    return (np.concatenate([inputs, in_m], axis=0),
            np.concatenate([outputs, out_m], axis=0))


def region_spec_from_table(inputs: np.ndarray, splits, num_overlap: int = 1):
    """Region bounds from the unique grid values per dim, split into
    ``splits[d]`` contiguous segments, with neighbouring segments
    overlapping by ``num_overlap`` grid values: hard seams make
    independently fitted region banks disagree across the boundary, which
    shows up as control oscillation at the seam in closed loop.

    Also returns the per-dim gate sharpness ``delta`` sized to the grid:
    the tanh transition width is about half a grid step (4/step), so
    neighbouring regions blend over one cell instead of snapping."""
    lower_bounds, upper_bounds, deltas = [], [], []
    for d, n_seg in enumerate(splits):
        vals = np.sort(np.unique(inputs[:, d]))
        lo, hi = overlapping_segments(vals, n_seg, num_overlap=num_overlap)
        lower_bounds.append(lo)
        upper_bounds.append(hi)
        step = (np.median(np.diff(vals)) if len(vals) > 1 else 1.0)
        deltas.append(float(np.clip(4.0 / max(step, 1e-9), 1.0, 100.0)))
    dimension_ranges = [list(t) for t in itertools.product(
        *[range(s) for s in splits])]
    return lower_bounds, upper_bounds, dimension_ranges, deltas


def mirror_cartesian_table(inputs: np.ndarray, outputs: np.ndarray):
    """Cartesian mirror augmentation: reflect the goal and state across the
    car's x-axis. inputs (N, 7) [v, x_g, y_g, t_g, v_g, beta, angv];
    outputs (N, 2T) control block. The reflection (y, theta, beta, angv,
    steer-vel flip) is the single-track dynamics' exact symmetry."""
    T = outputs.shape[1] // 2
    flip = np.array([1, 1, -1, -1, 1, -1, -1])
    in_m = inputs * flip
    out_m = np.concatenate([outputs[:, :T], -outputs[:, T:]], axis=1)
    return (np.concatenate([inputs, in_m], axis=0),
            np.concatenate([outputs, out_m], axis=0))


def _frenet_rollout_rows(x: torch.Tensor, u_seq: torch.Tensor, dyn_params):
    """Assemble reference-ABI rows and integrate: x is the 8-dim table input
    [ey, delta, vx, vy, vx_goal, wz, epsi, curv]; u_seq is (B, 2T)."""
    # the initial Frenet state is x[:, [0, 0, 1, 2, 3, 5, 6, 7]]: the s slot
    # duplicates ey on purpose (s does not enter the low-speed model's
    # outputs of interest), kept for parity with the reference
    init = x[:, [0, 0, 1, 2, 3, 5, 6, 7]]
    rows = torch.cat([init, u_seq], dim=1)
    # eps_denom: early-epoch nets predict wild controls whose rollout can
    # cross the Frenet singularity ey*curv -> 1 on wide-grid tables; one
    # singular row NaNs the loss and poisons Adam for good. Inactive on
    # valid states.
    return integrate_frenet(rows, dyn_params, eps_denom=0.05)


def pred_l1_loss(model, x, y, dyn_params=None):
    """Plain prediction L1, the goal-MPC net's training loss."""
    loss = (model(x) - y).abs().mean()
    return loss, (loss, torch.zeros_like(loss))


def frenet_fullint_loss(model, x, y, dyn_params):
    """pred L1 + full-horizon integration L1."""
    y_pred = model(x)
    pred_loss = (y_pred - y).abs().mean()
    actual = _frenet_rollout_rows(x, y, dyn_params)
    pred = _frenet_rollout_rows(x, y_pred, dyn_params)
    int_loss = (pred - actual).abs().mean()
    return pred_loss + int_loss, (pred_loss, int_loss)


def frenet_oneint_loss(model, x, y, dyn_params, int_weight: float = 100.0):
    """pred L1 + x100 one-step integration L1; y is the (B, 2) first-step
    control pair."""
    y_pred = model(x)
    pred_loss = (y_pred - y).abs().mean()
    init = x[:, [0, 1, 2, 3, 5, 6, 7]]
    pad = torch.zeros_like(x[:, :1])
    actual = frenet_onestep(torch.cat([init, pad, y], dim=1), dyn_params)
    pred = frenet_onestep(torch.cat([init, pad, y_pred], dim=1), dyn_params)
    int_loss = (pred - actual).abs().mean()
    return (pred_loss + int_weight * int_loss,
            (pred_loss, int_weight * int_loss))


def clothoid_endpoint_loss(model, x, y, dyn_params=None,
                           end_weight: float = 4.0):
    """pred L1 + endpoint (x, y, theta) L1 through differentiable composite
    Gauss-Legendre spiral quadrature (``dynamics/spiral.py``).

    The closed-form per-region fit minimises UNIFORM param error, but
    d(endpoint)/d(curvature coef) grows ~ s^2/2, so long arcs need far
    tighter curvature fits than short ones; fine-tuning on the endpoint
    applies exactly that reweighting. ``dyn_params`` is unused (the losses
    share one signature)."""
    del dyn_params
    y_pred = model(x)
    pred_loss = (y_pred - y).abs().mean()
    end = integrate_endpoint_gl(y_pred)
    end_loss = ((end[..., 0] - x[..., 0]).abs()
                + (end[..., 1] - x[..., 1]).abs()
                + wrap_angle(end[..., 2] - x[..., 2]).abs()).mean()
    return pred_loss + end_weight * end_loss, (pred_loss, end_loss)


def cluster_fullint_loss(model, x, y, cluster_ids, dyn_params):
    """fullint + softmax CE on the gate logits. ``cluster_ids`` are INTEGER
    labels ``(B,)``, not one-hots: 8 bytes a row where a dense (B, 500)
    one-hot is 2 KB."""
    y_pred, logits = model(x)
    pred_loss = (y_pred - y).abs().mean()
    actual = _frenet_rollout_rows(x, y, dyn_params)
    pred = _frenet_rollout_rows(x, y_pred, dyn_params)
    int_loss = (pred - actual).abs().mean()
    cl_loss = torch.nn.functional.cross_entropy(logits, cluster_ids.long())
    return pred_loss + int_loss + cl_loss, (pred_loss, int_loss, cl_loss)


def cartesian_fullint_loss(model, x, y, dyn_params):
    """Cartesian-table analogue: inputs are
    [v, x_g, y_g, t_g, v_g, beta, angv]; the rollout starts from the origin
    at speed v and compares the trajectories under predicted vs oracle
    controls."""
    y_pred = model(x)
    pred_loss = (y_pred - y).abs().mean()
    zeros = torch.zeros_like(x[:, 0])
    init = torch.stack([zeros, zeros, zeros, x[:, 0], zeros, x[:, 6],
                        x[:, 5]], dim=-1)
    actual = integrate_st(torch.cat([init, y], dim=1), dyn_params)
    pred = integrate_st(torch.cat([init, y_pred], dim=1), dyn_params)
    int_loss = (pred - actual).abs().mean()
    return pred_loss + int_loss, (pred_loss, int_loss)


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    pred_loss: torch.Tensor
    int_loss: torch.Tensor
    cluster_loss: Optional[torch.Tensor] = None


def make_train_step(loss_fn: Callable, dyn_params, mesh=None):
    """Build a train step ``(trainer, x, y, *extra) -> StepMetrics``: the
    loss and its gradient through the model's module path, the clip, one
    Adam step. The metrics are detached tensors on the model's device:
    reading one as a float waits for the device.

    With a ``mesh``, the step runs DP x EP on every rank of it: ``x``, ``y``
    and ``extra`` are this rank's rows of the batch
    (``parallel.mesh.data_sharding(mesh)``), the model is sharded
    (``shard_params``) or whole, and the gradients and metrics are those of
    the global mean loss (module docstring)."""

    def step(trainer: Trainer, x, y, *extra) -> StepMetrics:
        trainer.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, aux = loss_fn(trainer.model, x, y, *extra, dyn_params)
        if mesh is None:
            loss.backward()
            trainer.apply_gradients()
        else:
            (loss / mesh.size).backward()
            trainer.apply_gradients(mesh)
            loss, aux = _data_mean([loss, *aux], mesh)
        aux = [a.detach() for a in aux]
        return StepMetrics(loss.detach(), aux[0], aux[1],
                           aux[2] if len(aux) > 2 else None)

    return step


def _data_mean(values, mesh):
    """Each rank's mean over its rows -> the mean over the whole batch
    (the ranks of the data axis hold equal shares); (first, rest)."""
    from irbfn_tpu_torch.parallel.mesh import DATA_AXIS

    v = torch.stack([a.detach() for a in values])
    group = mesh.group(DATA_AXIS)
    if group is not None:
        dist.all_reduce(v, group=group)
        v = v / mesh.shape[DATA_AXIS]
    return v[0], list(v[1:])


def key_seed(key) -> int:
    """The numpy seed the JAX package's ``train_epochs(..., rng=key)``
    shuffles with: the key's last 32-bit word (``key_data(key)[-1]``); for
    ``PRNGKey(s)`` it is ``s``."""
    return int(prng.key_data(key)[-1])


def train_epochs(trainer: Trainer, step_fn, inputs, outputs,
                 batch_size: int, epochs: int, seed: int, extra=None,
                 log_fn=None, checkpoint_fn=None,
                 checkpoint_every: int = 100, log_every: int = 25,
                 device=None, max_steps: Optional[int] = None, mesh=None):
    """Permutation mini-batch epochs.

    The table goes to the device ONCE (tensors already there are used as
    they are; ``device=None`` is the model's device) and each batch is a
    gather there, driven by a host-drawn permutation
    (``np.random.default_rng(seed).permutation``, the JAX package's draws
    for a key whose last word is ``seed``: ``key_seed``). ``log_fn(step, metrics)`` fires every
    ``log_every`` steps: turning a metric into a float waits for the device,
    so a step does not. ``checkpoint_fn(trainer, epoch)`` fires every
    ``checkpoint_every`` epochs and after the last. ``max_steps`` ends the
    run after that many steps in all (the last epoch is then partial).
    With a ``mesh`` (and a ``step_fn`` made for it), every rank draws the
    same batches and hands its own rows of each to the step
    (``data_sharding``); the batch size must divide by the data axis.

    Returns ``(trainer, mean loss of the last epoch)``.
    """
    if device is None:
        device = next(trainer.model.parameters()).device
    device = resolve_device(device)
    inputs = torch.as_tensor(inputs).to(device)
    outputs = torch.as_tensor(outputs).to(device)
    extra = None if extra is None else torch.as_tensor(extra).to(device)
    n = inputs.shape[0]
    batch_size = min(batch_size, n)  # tables smaller than one batch
    steps = max(1, n // batch_size)
    place = lambda idx: idx  # noqa: E731
    if mesh is not None:
        from irbfn_tpu_torch.parallel.mesh import data_sharding

        place = data_sharding(mesh)  # raises on a batch it cannot split
    np_rng = np.random.default_rng(int(seed))
    losses = []
    done = 0
    for e in range(epochs):
        if max_steps is not None and done >= max_steps:
            break
        perms = np_rng.permutation(n)[: steps * batch_size]
        perms = torch.as_tensor(perms.reshape(steps, batch_size))
        if device.type == "cuda":
            perms = perms.pin_memory()
        perms = perms.to(device, non_blocking=True)
        losses = []
        for b in range(steps):
            if max_steps is not None and done >= max_steps:
                break
            done += 1
            idx = place(perms[b])
            args = (inputs[idx], outputs[idx])
            if extra is not None:
                args += (extra[idx],)
            metrics = step_fn(trainer, *args)
            losses.append(metrics.loss)
            if log_fn is not None and (b % log_every == 0
                                       or b == steps - 1):
                log_fn(e * steps + b, metrics)
        if checkpoint_fn is not None and e % checkpoint_every == 0:
            checkpoint_fn(trainer, e)
    if checkpoint_fn is not None:
        checkpoint_fn(trainer, epochs - 1)
    return trainer, float(torch.stack(losses).mean())
