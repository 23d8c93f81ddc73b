"""iterativesolvers_tpu_torch — the PyTorch / CUDA port of iterativesolvers_tpu.

The JAX package ``iterativesolvers_tpu`` is the reference; this package
follows its layout (``operators/``, ``ops/``, ``solvers/``, ``utils/``) and
module names, and imports no JAX.  Operators and fixtures are built on
``device="cuda"`` unless the caller asks for another device; solvers run on
the operator's device.  Each Pallas kernel of the reference is a hand-written
CUDA kernel here (``csrc/``, built by ``nvcc`` at first use), launched for
CUDA tensors; a CPU tensor takes the kernel's plain PyTorch version.

Ported so far: CG and restarted GMRES (with the bf16-panel GMRES-IR mode)
on the stencil and DIA operators, and the Givens, Hessenberg and
orthogonalization ops GMRES uses; MINRES, QMR, BiCGStab(l), IDR(s),
Chebyshev (with ``gershgorin_bounds`` / ``power_bound``), pipelined CG and
the power method (``powm``, ``invpowm``); the identity, diagonal, dense and
function preconditioners; the row-sharded halo operators and GMRES's
sharded-panel CGS2 route over ``torch.distributed``
(``iterativesolvers_tpu_torch.parallel``, one process per rank), with
GMRES's mesh-reduced orthogonalization where that route does not apply;
the row-panel products ``mv_rows`` (the stencil and DIA kernels once per
row) and block CG, LSQR, LSMR, LOBPCG and svdl on them, with the matrix-free
``GradientOperator``.
"""

from .operators.linear_operator import (
    AdjointOperator,
    FunctionOperator,
    LinearOperator,
    MatrixOperator,
    as_operator,
)
from .operators.preconditioners import (
    DensePreconditioner,
    DiagonalPreconditioner,
    FunctionPreconditioner,
    IdentityPreconditioner,
    Preconditioner,
    as_preconditioner,
)
from .operators.stencil import (
    GradientOperator,
    StencilOperator,
    advection_diffusion_stencil,
    laplacian,
)
from .operators.sparse import (
    DIAMatrix,
    compress_values,
    values_representable,
)
from .solvers.bicgstabl import bicgstabl, bicgstabl_iterator
from .solvers.block_cg import block_cg, block_cg_iterator
from .solvers.cg import cg, cg_iterator
from .solvers.chebyshev import chebyshev, chebyshev_iterator
from .solvers.gmres import gmres, gmres_iterator
from .solvers.idrs import idrs, idrs_iterator
from .solvers.minres import minres, minres_iterator
from .solvers.pipelined import pipelined_cg
from .solvers.lobpcg import LOBPCGResults, lobpcg, lobpcg_iterator
from .solvers.lsmr import lsmr
from .solvers.lsqr import lsqr
from .solvers.qmr import qmr, qmr_iterator
from .solvers.simple import invpowm, powm, powm_iterator
from .solvers.svdl import svdl, svdl_iterator
from .ops.givens import givens
from .ops.hessenberg import hessenberg_lstsq
from .ops.orthogonalize import ORTH_METHODS, orthogonalize_and_normalize
from .utils.dtypes import zerox
from .utils.history import ConvergenceHistory
from .utils.spectral import gershgorin_bounds, power_bound
from . import parallel
