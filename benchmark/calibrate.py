"""Readings for the limits of ``correct``: one cell run on many seeds in
one process, the program's numbers on every seed and the control's (the
reference in the next precision down, in the program's place, on the same
states or rows) on the first ``--control`` seeds.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 ... [--control 3]

Prints one JSON line a seed: its end-to-end metrics, the program's numbers
and, where run, the control's; then the largest program reading and the
smallest control reading of each number. Needs the cards the cell asks for.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    from benchmark import harness

    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        line, out = harness.run_cell(args.workload, seed, args.seconds,
                                     False, control=i < args.control)
        prog = {k: v["value"] for k, v in line["checks"].items()}
        ctl = out.layer.get("control")
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in (ctl or {}).items():
            if k != "failed":
                upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "metrics": line["metrics"], "program": prog,
                          "control": ctl, "info": out.layer.get("info"),
                          "attempted": line["attempted"],
                          "memory_peak_bytes":
                              line["device"]["memory_peak_bytes"]}),
              flush=True)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)


if __name__ == "__main__":
    main()
