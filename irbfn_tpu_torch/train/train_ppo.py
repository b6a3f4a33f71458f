"""PPO-over-lattice training: the categorical lattice-selection policy on
the batched ``TrackEnv``, with the learning curve (reward and progress per
update) written as JSON.

Port of ``scripts/train_ppo.py``, with its flags and output, plus
``--device``.

Usage: ``python -m irbfn_tpu_torch.train.train_ppo [--n_updates 60]
[--n_envs 64] [--n_steps 64] [--out torch_runs/ppo_curve.json]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.sim import TrackEnv, oval_track
from irbfn_tpu_torch.train.ppo import PPOConfig, PPOTrainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_updates", type=int, default=60)
    p.add_argument("--n_envs", type=int, default=64)
    p.add_argument("--n_steps", type=int, default=64)
    p.add_argument("--n_lattice", type=int, default=7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="torch_runs/ppo_curve.json")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def make_env(device=None) -> TrackEnv:
    """The training env: the 3 m/s oval, 0.02 s physics, 0.1 s control."""
    device = resolve_device(device)
    track = oval_track(n_samples=256, speed=3.0, device=device)
    return TrackEnv(track, f1tenth_params(dtype=torch.float32,
                                          device=device),
                    sim_dt=0.02, control_dt=0.1)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(device)
    cfg = PPOConfig(n_envs=args.n_envs, n_steps=args.n_steps)
    trainer = PPOTrainer(env, cfg, n_lattice=args.n_lattice, seed=args.seed)
    t0 = wait_clock(device)
    history = trainer.train(n_updates=args.n_updates)
    dt = wait_clock(device) - t0
    steps = args.n_updates * cfg.n_envs * cfg.n_steps
    rew = [h["reward"] for h in history]
    k = max(len(rew) // 10, 1)
    print(f"{args.n_updates} updates ({steps:,} env steps) in {dt:.1f}s "
          f"-> {steps / dt:,.0f} env steps/s")
    print(f"mean reward first-{k} {np.mean(rew[:k]):.4f} -> "
          f"last-{k} {np.mean(rew[-k:]):.4f}")
    out = {"config": {k: getattr(args, k) for k in vars(args)},
           "env_steps_per_s": steps / dt, "history": history}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"saved {args.out}")
    return out


if __name__ == "__main__":
    main()
