"""The (data, expert) device mesh over ``torch.distributed``.

Port of ``irbfn_tpu/parallel/mesh.py``. Two axes:

- ``data``: data parallelism over lattice rows and batch rows;
- ``expert``: the region axis of the WCRBF cores, sharded: the
  region-partitioned net is a hard-gated mixture of experts.

JAX inserts the collectives from sharding annotations. Here they are
written out where they run, on plain tensors: the ``all_gather`` of the
lattice chunks (``parallel/datagen.py:solve_lattice_sharded``), the
``all_reduce`` of the regions' partial sums over the expert group
(``models/wcrbf.py:expert_sum``) and the ``all_reduce`` of the gradients
(``train/trainer.py:Trainer.apply_gradients``). The groups come from
``torch.distributed.device_mesh.init_device_mesh``; nothing is a DTensor.

The backend follows the device: NCCL for the card, one process per card;
gloo for the CPU. ``launch.spawn`` starts the ranks, or ``torchrun`` does.
With no process group, ``make_mesh()`` is a world of one: the one-device
case, with no collective at all.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.models.wcrbf import ExpertShard

DATA_AXIS = "data"
EXPERT_AXIS = "expert"
# the specs of ``wcrbf_param_sharding``, as JAX's PartitionSpecs read
SHARDED = (EXPERT_AXIS,)
REPLICATED = ()


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, expert) mesh of ``size`` ranks: rank
    r sits at (r // expert, r % expert), as JAX's ``make_mesh`` reshapes
    its devices."""

    device: torch.device  # this rank's device
    shape: dict  # {DATA_AXIS: D, EXPERT_AXIS: E}
    rank: int
    device_mesh: object = None  # the DeviceMesh; None for a world of one

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[EXPERT_AXIS]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape[EXPERT_AXIS]

    @property
    def expert_rank(self) -> int:
        return self.rank % self.shape[EXPERT_AXIS]

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` through this rank (None: every
        rank); None for a world of one."""
        if self.device_mesh is None:
            return None
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)


def make_mesh(world: Optional[int] = None, expert: int = 1,
              device=None) -> Mesh:
    """A (data, expert) mesh over the ranks of the process group, or a
    world of one when none is initialised. ``expert`` divides the world;
    the rest is the data axis. ``device``: this rank's device (None: the
    card, the one ``torch.cuda.set_device`` chose)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size() if dist.is_initialized() else 1
    if world is not None and int(world) != n:
        raise ValueError(f"a mesh of {world} ranks needs a process group of "
                         f"{world}; this one has {n}")
    if n % expert != 0:
        raise ValueError(f"expert axis {expert} must divide device count {n}")
    shape = {DATA_AXIS: n // expert, EXPERT_AXIS: expert}
    if not dist.is_initialized():
        return Mesh(device, shape, 0)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (n // expert, expert),
                          mesh_dim_names=(DATA_AXIS, EXPERT_AXIS))
    return Mesh(device, shape, dist.get_rank(), dm)


def data_sharding(mesh: Mesh):
    """``P(DATA_AXIS)``: a function giving this rank's contiguous slice of
    a ``(B, ...)`` array, rows ``[i B/D, (i+1) B/D)`` for data rank i of D.
    B must divide evenly."""
    D, i = mesh.shape[DATA_AXIS], mesh.data_rank

    def shard(a):
        B = a.shape[0]
        if B % D:
            raise ValueError(f"a batch of {B} rows does not split evenly "
                             f"over the {D} ranks of the data axis")
        return a[i * (B // D):(i + 1) * (B // D)]

    return shard


def replicated(mesh: Mesh):
    """``P()``: every rank holds the whole array."""
    del mesh
    return lambda a: a


def wcrbf_param_sharding(mesh: Mesh):
    """The sharding rule of a WCRBF model: a function ``model -> {name:
    spec}`` over its parameters and constants. Only ``centers`` (R, K, F)
    and ``log_sigs`` (R, K) of a region core are ``SHARDED`` (split on their
    first axis over ``EXPERT_AXIS``); heads, gate layers and constants are
    ``REPLICATED``."""
    del mesh

    def apply(model: nn.Module) -> dict:
        core = isinstance(getattr(model, "centers", None), torch.Tensor)
        names = [n for n, _ in model.named_parameters()]
        names += [n for n, b in model.named_buffers() if b is not None]
        return {n: SHARDED if core and n in ("centers", "log_sigs")
                else REPLICATED for n in names}

    return apply


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A copy of ``model`` on ``mesh.device`` that holds this rank's
    R / E regions of the core (``wcrbf_param_sharding``) and sums its share
    of every output over the expert group (``models/wcrbf.py``). A model
    without a core comes back whole. On a ``Mesh`` made by hand, with no
    process group, the copy has no group to sum over: its
    ``kernel_operands()`` serve a caller who adds the ranks' partial
    forwards itself."""
    if getattr(model, "expert_shard", None) is not None:
        raise ValueError("the model is already sharded")
    specs = wcrbf_param_sharding(mesh)(model)
    model = copy.deepcopy(model).to(mesh.device)
    names = [n for n, spec in specs.items() if spec == SHARDED]
    if not names:
        return model
    E, R = mesh.shape[EXPERT_AXIS], model.num_regions
    if R % E:
        raise ValueError(f"expert axis {E} must divide the {R} regions")
    r0, r1 = mesh.expert_rank * (R // E), (mesh.expert_rank + 1) * (R // E)
    with torch.no_grad():
        for n in names:
            p = getattr(model, n)
            setattr(model, n, nn.Parameter(p[r0:r1].clone(),
                                           requires_grad=p.requires_grad))
    model.expert_shard = ExpertShard(r0, r1, mesh.group(EXPERT_AXIS),
                                     mesh.expert_rank, E)
    if hasattr(model, "_operands"):
        model._operands = (None, None)
    return model
