"""Work counted from the problems' equations and shapes, never from what
runs: a fused or reordered implementation does the same work.

Operations count a multiply, an add, a compare or a transcendental as one;
bytes count each input of a kernel read once and each output written once.
The peaks these are read against sit in ``peaks.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

F32_BYTES = 4


def rbf_forward_ops(B: int, R: int, K: int, F: int, O: int) -> int:
    """The region-blended RBF forward with per-region heads: per row, region
    and center the distance (3F), the width, basis and gate product (6) and
    the head (2O); per row and region the gate (8F)."""
    return B * R * K * (3 * F + 6 + 2 * O) + 8 * B * R * F


def rbf_forward_bytes(B: int, R: int, K: int, F: int, O: int) -> int:
    """Input rows, centers, widths, heads and biases, gate bounds and
    sharpness read once; the outputs written once."""
    return F32_BYTES * (B * F + R * K * F + R * K + R * K * O + R * O
                        + 2 * R * F + F + B * O)


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAKS["f32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


# ---------------------------------------------------------------- the loop

# one evaluation of the simulator's single-track derivative, both branches
# (dynamic 62, kinematic 12) and the select (7)
ST_DERIV_OPS = 81
# an RK4 step on 7 states: four derivatives and 7 * 10 for the stages
RK4_OPS = 4 * ST_DERIV_OPS + 70
# the planner's Euler step of the kinematic Frenet model: 28 + 7 * 2
FRENET_EULER_OPS = 42
# a projection onto one raceline segment: offset (2), dot (3), divide and
# clamp (3), projected point (4), squared distance (4), argmin compare (1)
SEGMENT_OPS = 17


def control_step_flops(B: int, R: int, K: int, F: int, O: int,
                       segments: int, substeps: int = 10,
                       horizon: int = 5) -> int:
    """One control step of the sweep at B lanes: the observation's and the
    step's projections onto every raceline segment, the planner's forward
    and its ``horizon``-step Frenet prediction, and ``substeps`` RK4 steps
    of the simulator."""
    projections = 2 * B * segments * SEGMENT_OPS
    plan = rbf_forward_ops(B, R, K, F, O) + B * horizon * FRENET_EULER_OPS
    sim = B * substeps * RK4_OPS
    return projections + plan + sim


# ------------------------------------------------------------ the QP lattice

def admm_ops_per_row_sweep(horizon: int = 8) -> int:
    """One ADMM sweep of one goal row: three products with the (m, n)
    constraint rows and the (n, n) KKT inverse, 2 (2mn + n^2), and eight
    elementwise operations on the m-vectors; n = 2T, m = 4T - 1.
    2,744 at T = 8."""
    n, m = 2 * horizon, 4 * horizon - 1
    return 2 * (2 * m * n + n * n) + 8 * m


def admm_ops(rows: int, sweeps: int, horizon: int = 8) -> int:
    return rows * sweeps * admm_ops_per_row_sweep(horizon)


def admm_bytes(rows: int, horizon: int = 8) -> int:
    """A row's linear term read, its controls and two residuals written
    (the family's matrices are a few KiB and left out)."""
    n = 2 * horizon
    return F32_BYTES * rows * (2 * n + 2)


def goal_vector_ops(rows: int, horizon: int = 8) -> int:
    """A row's linear term ``Su' W (x_free - g)``: 2 (4T) elementwise and
    (4T, 2T) multiply-adds; 1,088 at T = 8."""
    n4 = 4 * horizon
    return rows * (2 * n4 + 2 * n4 * 2 * horizon)


def lattice_family_flops(rows: int, sweeps: int, horizon: int = 8) -> int:
    """A family's counted work: its rows' linear terms and their sweeps
    (the condensing itself is a few thousand operations per family)."""
    return goal_vector_ops(rows, horizon) + admm_ops(rows, sweeps, horizon)
