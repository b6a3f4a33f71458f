"""Starting the ranks of a process group.

- ``spawn(fn, world, device, *args)``: ``world`` processes on this host
  (``torch.multiprocessing.spawn``), each in a process group initialised
  from a file store, running ``fn(*args)``; gloo on the CPU with one torch
  thread per rank, NCCL on the cards, rank r on card r. Returns each rank's
  value. ``fn`` must be importable by the children: it lives in the
  package.
- ``from_environment(device)``: under ``torchrun`` (``WORLD_SIZE`` set),
  the process group from its environment for the length of a run, and
  this rank's card; ranks other than 0 print nothing.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import sys
import tempfile
import uuid

import torch
import torch.distributed as dist

from irbfn_tpu_torch._device import resolve_device


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_cards(world: int) -> None:
    """Raise unless ``world`` cards are visible: a run of ``world`` ranks on
    the card never moves to the CPU."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < world:
        raise ValueError(f"{world} ranks on CUDA need {world} cards; "
                         f"{count} visible")


def _rank_main(rank, world, device_type, run_dir):
    with open(os.path.join(run_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device_type),
                            init_method=f"file://{run_dir}/store",
                            rank=rank, world_size=world, **kw)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, device=None, *args, store_dir=None) -> list:
    """Run ``fn(*args)`` on ``world`` ranks; returns their values in rank
    order. ``store_dir``: where the file store and the values go (None: a
    new temporary directory, removed afterwards)."""
    device = resolve_device(device)
    if device.type == "cuda":
        check_cards(world)
    own = store_dir is None
    root = tempfile.mkdtemp() if own else str(store_dir)
    run = os.path.join(root, f"spawn-{uuid.uuid4().hex[:12]}")
    os.makedirs(run)
    try:
        # the call goes through a file: a spawned child reads its arguments
        # from a pipe only after its imports, so arguments over the pipe's
        # 64 KiB would start the ranks one after another
        with open(os.path.join(run, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        torch.multiprocessing.spawn(_rank_main,
                                    args=(world, device.type, run),
                                    nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(run, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(root if own else run, ignore_errors=True)


@contextlib.contextmanager
def from_environment(device=None):
    """Under ``torchrun``: initialise the process group from the
    environment (NCCL on the card, rank r on card ``LOCAL_RANK``; gloo on
    the CPU), silence the standard output of every rank but 0, and destroy
    the group at the end. Without ``WORLD_SIZE`` it does nothing. Yields
    the rank (0 without torchrun)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        yield dist.get_rank() if dist.is_initialized() else 0
        return
    device = resolve_device(device)
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend_for(device), **kw)
    rank = dist.get_rank()
    try:
        with open(os.devnull, "w") as null, contextlib.ExitStack() as stack:
            if rank != 0:
                stack.enter_context(contextlib.redirect_stdout(null))
            yield rank
            dist.barrier()
    finally:
        dist.destroy_process_group()
        sys.stdout.flush()
