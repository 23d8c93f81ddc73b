"""Multi-device distribution over ``torch.distributed`` (port of
``iterativesolvers_tpu/parallel``): a 1-D mesh of ranks, row-partitioned
halo operators, the sharded-panel CGS2 of distributed GMRES and the
shard-local block-Jacobi ILU(0) / IC(0) preconditioner."""

from .panel_ortho import (
    PanelLayout,
    dist_panel_ortho,
    panel_layout,
    panel_row_to_vec,
    vec_to_panel_row,
)
from .precond import ShardedBlockJacobiPreconditioner
from .sharded import (
    HaloDIAOperator,
    HaloStencilOperator,
    RowMesh,
    gather_vector,
    replicate,
    row_mesh,
    shard_vector,
)

__all__ = [
    "RowMesh",
    "row_mesh",
    "shard_vector",
    "replicate",
    "gather_vector",
    "HaloDIAOperator",
    "HaloStencilOperator",
    "PanelLayout",
    "panel_layout",
    "dist_panel_ortho",
    "vec_to_panel_row",
    "panel_row_to_vec",
    "ShardedBlockJacobiPreconditioner",
]
