"""Constraint-activation clustering over a generated Frenet table: rank the
unique active-constraint patterns and write the warm-start centers and the
cluster-id npz next to the table.

Port of ``scripts/cluster_constraints.py``, with its flags and prints. Host
numpy only (``train/clustering.py``).

Usage: ``python -m irbfn_tpu_torch.train.cluster_constraints --npz_path
TABLE [--top_k 499]``
"""

from __future__ import annotations

import argparse

import numpy as np

from irbfn_tpu_torch.train.clustering import (save_cluster_artifacts,
                                              unique_activation_patterns)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--top_k", type=int, default=499)
    return p.parse_args(argv)


def main(argv=None) -> tuple:
    args = parse_args(argv)
    with np.load(args.npz_path) as data:
        inputs, constraints = data["inputs"], data["constraints"]
    pats, counts, _ = unique_activation_patterns(constraints)
    print(f"{pats.shape[0]} unique activation patterns; "
          f"top 5 cover {counts[:5].sum() / counts.sum():.1%}")
    centers_path, ids_path = save_cluster_artifacts(
        args.npz_path, inputs, constraints, args.top_k)
    print(f"saved {centers_path}\nsaved {ids_path}")
    return centers_path, ids_path


if __name__ == "__main__":
    main()
