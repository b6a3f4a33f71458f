"""Lattice data generation on one device or across a mesh, the (data,
expert) mesh itself (``parallel.mesh``, ``parallel.launch``), and the table
generators
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
    solve_lattice_sharded,
)
from irbfn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    Mesh,
    data_sharding,
    make_mesh,
    replicated,
    shard_params,
    wcrbf_param_sharding,
)

__all__ = ["CLOTHOID_GRID", "DATA_AXIS", "EXPERT_AXIS", "FRENET_GRID",
           "GridSpec", "Mesh", "TableSolution", "build_lattice",
           "controls_block", "data_sharding", "frenet_table", "make_mesh",
           "replicated", "save_table", "shard_params", "solve_lattice",
           "solve_lattice_sharded", "wcrbf_param_sharding"]
