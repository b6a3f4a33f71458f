"""Plot a closed-loop robustness sweep's results: mean |ey| and mean |epsi|
against cornering stiffness, one line per mu -> ey_vs_cs_mu.pdf and
ephi_vs_cs_mu.pdf.

Port of ``scripts/plot_eval.py`` (numpy and matplotlib only). It reads the
pickle that ``python -m irbfn_tpu_torch.sim.eval_closed_loop`` writes.

Usage: ``python -m irbfn_tpu_torch.sim.plot_eval --results SWEEP.pkl
[--out_prefix torch_runs/]``
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--results", type=str, required=True)
    p.add_argument("--out_prefix", type=str, default="")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Writes the two figures; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    args = parse_args(argv)
    with open(args.results, "rb") as f:
        data = pickle.load(f)
    combos = np.asarray(data["combos"])
    ey, epsi = np.asarray(data["ey"]), np.asarray(data["epsi"])
    mus = np.unique(combos[:, 0])
    css = np.unique(combos[:, 1])
    if os.path.dirname(args.out_prefix):
        os.makedirs(os.path.dirname(args.out_prefix), exist_ok=True)
    paths = []
    for metric, name, fname in [(ey, "mean $|e_y|$ [m]", "ey_vs_cs_mu.pdf"),
                                (epsi, "mean $|e_\\psi|$ [rad]",
                                 "ephi_vs_cs_mu.pdf")]:
        fig, ax = plt.subplots(figsize=(6, 4))
        grid = metric.reshape(len(mus), len(css))
        for i, mu in enumerate(mus):
            ax.plot(css, grid[i], marker="o", label=f"$\\mu$={mu:.2f}")
        ax.set_xlabel("cornering stiffness")
        ax.set_ylabel(name)
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(args.out_prefix + fname)
        plt.close(fig)
        print(f"saved {args.out_prefix + fname}")
        paths.append(args.out_prefix + fname)
    return paths


if __name__ == "__main__":
    main()
