"""Run one cell of the benchmark of ``irbfn_tpu_torch`` and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The run needs as many CUDA cards as the cell
asks for, and fails without printing a result otherwise. With ``--trace 0``
the result line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the device's busy time. The last line of standard
output is the result; the numbers that decided ``correct`` are printed on
standard error too, each beside its limit, as its last lines.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from benchmark import harness

    harness.adopt_orphans()
    try:
        return _main(argv, harness)
    finally:
        harness.stop_children()


def _main(argv, harness) -> int:
    args = parse_args(argv)
    manifest = harness.load_manifest()
    cell = harness.resolve(manifest, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    cell.t_start = T_START
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); {have} "
              "visible", file=sys.stderr)
        return 2
    outcome = harness.driver(cell).run(cell)
    ended = harness.stop_children()
    if ended:
        print(f"ended {len(ended)} process(es) the run left: {ended}",
              file=sys.stderr)
    found = harness.forbidden_modules() + list(
        outcome.layer.get("forbidden_in_ranks", []))
    if found:
        print(f"forbidden modules loaded: {sorted(set(found))}",
              file=sys.stderr)
        return 3
    line = harness.result_line(manifest, cell, outcome)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
