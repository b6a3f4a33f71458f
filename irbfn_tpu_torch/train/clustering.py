"""Constraint-activation-pattern clustering.

Port of ``irbfn_tpu/train/clustering.py`` (numpy only, the same code): the
solver's active-constraint one-hots (the ``lam_g`` isclose pattern saved
with each table row) are grouped into unique patterns, ranked by frequency,
and the top-k patterns become (a) RBF warm-start centers (per-cluster input
means/modes saved as ``*_top{k}mode.npz["centers"]``) and (b) integer
cluster ids for the gated ClusterWCRBFNet's cross-entropy loss
(``*_{k}_cluster_ids.npz["cluster_int_ids"]``).

Pure numpy (one-shot offline analysis over a finished table).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unique_activation_patterns(constraints: np.ndarray,
                               valid: np.ndarray | None = None):
    """Unique constraint-activation patterns ranked by frequency.

    Args:
        constraints: (N, C) 0/1 activation one-hots (-999 rows allowed).
        valid: optional bool mask; inferred from -999 sentinels otherwise.
    Returns:
        (patterns (P, C) most-frequent-first, counts (P,), inverse (N,)
        index of each row's pattern; invalid rows get -1)
    """
    if valid is None:
        valid = ~np.any(constraints == -999.0, axis=1)
    pats, inv, counts = np.unique(constraints[valid].astype(np.int8), axis=0,
                                  return_inverse=True, return_counts=True)
    order = np.argsort(-counts)
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(len(order))
    inverse = np.full(constraints.shape[0], -1, dtype=np.int64)
    inverse[valid] = rank_of[inv]
    return pats[order], counts[order], inverse


def cluster_ids(constraints: np.ndarray, top_k: int,
                valid: np.ndarray | None = None) -> np.ndarray:
    """Integer cluster id per row: pattern rank if within top_k, else the
    overflow id ``top_k`` (the net trains k+1 regions, leaving one for
    'outside top k'). Invalid rows get the overflow id too."""
    _, _, inverse = unique_activation_patterns(constraints, valid)
    ids = np.where((inverse >= 0) & (inverse < top_k), inverse, top_k)
    return ids.astype(np.int64)


def cluster_centers(inputs: np.ndarray, constraints: np.ndarray, top_k: int,
                    mode: str = "mode",
                    valid: np.ndarray | None = None) -> np.ndarray:
    """Per-cluster representative inputs -> RBF warm-start centers (K, D).

    mode="mean": per-cluster mean input; mode="mode": per-dimension most
    frequent grid value (the notebook's 'topkmode' variant).
    """
    if valid is None:
        valid = ~np.any(constraints == -999.0, axis=1)
    _, _, inverse = unique_activation_patterns(constraints, valid)
    centers = np.zeros((top_k, inputs.shape[1]))
    for k in range(top_k):
        rows = inputs[inverse == k]
        if rows.shape[0] == 0:
            continue
        if mode == "mean":
            centers[k] = rows.mean(0)
        else:
            for d in range(inputs.shape[1]):
                vals, cnts = np.unique(rows[:, d], return_counts=True)
                centers[k, d] = vals[np.argmax(cnts)]
    return centers


def save_cluster_artifacts(npz_path: str, inputs: np.ndarray,
                           constraints: np.ndarray, top_k: int) -> Tuple[str, str]:
    """Write the two artifacts with the reference's file-naming convention."""
    centers = cluster_centers(inputs, constraints, top_k, mode="mode")
    ids = cluster_ids(constraints, top_k)
    centers_path = npz_path[:-4] + f"_top{top_k}mode" + npz_path[-4:]
    ids_path = npz_path[:-4] + f"_{top_k}_cluster_ids" + npz_path[-4:]
    np.savez(centers_path, centers=centers)
    np.savez(ids_path, cluster_int_ids=ids)
    return centers_path, ids_path
