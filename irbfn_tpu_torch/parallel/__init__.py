"""Lattice data generation on one device, and the table generators
(``python -m irbfn_tpu_torch.parallel.gen_goal_mpc_table``,
``gen_nmpc_table_frenet``, ``gen_nmpc_table_cartesian``,
``gen_clothoid_lut``) and ``patch_table_stragglers``."""

from irbfn_tpu_torch.parallel.datagen import (
    CLOTHOID_GRID,
    FRENET_GRID,
    GridSpec,
    TableSolution,
    build_lattice,
    controls_block,
    frenet_table,
    save_table,
    solve_lattice,
)

__all__ = ["CLOTHOID_GRID", "FRENET_GRID", "GridSpec", "TableSolution",
           "build_lattice", "controls_block", "frenet_table", "save_table",
           "solve_lattice"]
