"""Multi-device distribution over ``torch.distributed`` (port of
``iterativesolvers_tpu/parallel``): 1-D and ``(slice, chip)`` meshes of
ranks, row-partitioned halo, ELL and dense operators, the row-sharded DIA
and ELL matrices of ``shard_dia`` / ``shard_ell``, the sharded-panel CGS2
of distributed GMRES and the shard-local block-Jacobi ILU(0) / IC(0)
preconditioner."""

from .panel_ortho import (
    PanelLayout,
    dist_panel_ortho,
    panel_layout,
    panel_row_to_vec,
    vec_to_panel_row,
)
from .precond import ShardedBlockJacobiPreconditioner
from .sharded import (
    DenseMeshOperator,
    HaloDIAOperator,
    HaloStencilOperator,
    RowMesh,
    RowShardedELLOperator,
    SliceMesh,
    gather_vector,
    replicate,
    row_mesh,
    shard_dia,
    shard_ell,
    shard_vector,
    slice_mesh,
)

__all__ = [
    "HaloDIAOperator",
    "HaloStencilOperator",
    "RowShardedELLOperator",
    "DenseMeshOperator",
    "ShardedBlockJacobiPreconditioner",
    "dist_panel_ortho",
    "panel_layout",
    "panel_row_to_vec",
    "replicate",
    "row_mesh",
    "shard_dia",
    "shard_ell",
    "shard_vector",
    "slice_mesh",
    "vec_to_panel_row",
    "RowMesh",
    "SliceMesh",
    "gather_vector",
    "PanelLayout",
]
