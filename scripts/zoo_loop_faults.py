"""Would ``chip_smoke.py``'s phase 48 catch a planner fault in the loop?

Phase 48 holds each of the zoo's six single nets, in the 1000-lane sweep,
against its JAX golden by ``TOL_ZOO_LOOP``. Five of those limits are wider
than phase 5's, since the nets' lanes part under start nudges of 1e-7 and
1e-6 in the JAX package itself. This script plants a fault in the
planner's input bounds (the clamp into the trained grid), drives each net
through the same sweep with the fault, and prints which of phase 48's
limits it breaks; ``none`` is the run without a fault. Faults:

- ``epsi_curv_swapped``: the bounds of epsi and curv trade places, as a
  wrong row order of the bounds would (epsi clamped to curv's range);
- ``vx_lo_from_vx_goal``: vx's lower bound taken from vx_goal's row;
- ``ey_hi_halved``: the upper bound of ey halved.

Runs on a CUDA card, as phase 48 does (about 15 s a sweep on an H100):

    python scripts/zoo_loop_faults.py

Each faulted line also says how far the fault moved the sweep from the
unfaulted run's, so a fault that phase 48 passes shows whether it changed
the loop at all.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def _swap(b, i, j):
    b[[i, j]] = b[[j, i]]


def _copy_lo(b, i, j):
    b[i, 0] = b[j, 0]


def _halve_hi(b, i):
    b[i, 1] *= 0.5


# the net input is [ey, delta, vx, vy, vx_goal, wz, epsi, curv]
FAULTS = {
    "none": lambda b: None,
    "epsi_curv_swapped": lambda b: _swap(b, 6, 7),
    "vx_lo_from_vx_goal": lambda b: _copy_lo(b, 2, 4),
    "ey_hi_halved": lambda b: _halve_hi(b, 0),
}


def main() -> int:
    import torch

    from irbfn_tpu_torch.train import input_bounds_from_config
    from irbfn_tpu_torch.train.checkpoints import load_config

    if not torch.cuda.is_available():
        raise SystemExit("zoo_loop_faults.py drives the sweep on a GPU")
    device = torch.device("cuda")
    golden = smoke._npz(smoke.ASSET + "_golden.npz")
    lanes = {k: golden[k] for k in ("loop_mu", "loop_cs", "loop_noise")}
    for run in smoke._zoo_runs()[1]:
        config = load_config(os.path.join(smoke.ASSETS, f"{run}.json"))
        for fault in FAULTS:
            bounds = input_bounds_from_config(config)
            FAULTS[fault](bounds)
            final, traj, _, wall, _, g = smoke.zoo_sweep(device, run, lanes,
                                                         bounds)
            r, text, failed = smoke.zoo_loop_verdict(
                run, smoke._against(final, traj, g), g)
            if fault == "none":  # the first, the others' reference
                unfaulted, moved = r, ""
            else:
                d = 1e3 * np.abs(r["ey"] - unfaulted["ey"])
                moved = (f"; vs the unfaulted run: done in "
                         f"{int((r['done'] != unfaulted['done']).sum())} "
                         f"lanes, laps in "
                         f"{int((r['laps'] != unfaulted['laps']).sum())}, "
                         f"per-lane |ey| median {np.median(d):.4f} mm, "
                         f"max {d.max():.2f} mm")
            verdict = ("phase 48 FAILS on " + ", ".join(failed) if failed
                       else "phase 48 passes")
            print(f"{run} / {fault}: {verdict}; {text}{moved}; "
                  f"{wall:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
