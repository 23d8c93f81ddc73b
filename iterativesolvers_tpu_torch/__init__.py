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
function preconditioners; the row-sharded halo, ELL and dense operators
on 1-D and ``(slice, chip)`` meshes, ``shard_dia`` / ``shard_ell`` and
GMRES's sharded-panel CGS2 route over ``torch.distributed``
(``iterativesolvers_tpu_torch.parallel``, one process per rank), with
GMRES's mesh-reduced orthogonalization where that route does not apply;
the row-panel products ``mv_rows`` (the stencil and DIA kernels once per
row, on one device and on each rank) and block CG, LSQR, LSMR, LOBPCG and
svdl on them, on one device or a mesh, with the matrix-free
``GradientOperator``; the stored formats CSR, ELL, HYB and BSR with
``auto_format`` (which sends banded matrices to the DIA kernel), the native
host layer (``native``, built by g++ at first use) and the MatrixMarket
loader; the ILU(0), IC(0), red-black IC and Eisenstat-SSOR preconditioners
on ``LevelScheduledTriangular``, ``RBReducedSystem``, the stationary methods
(jacobi, gauss_seidel, sor, ssor, their iterables and ``SingularError``),
the shard-local ``parallel.ShardedBlockJacobiPreconditioner``, and
``utils/profiling.py`` (traces on ``torch.profiler``, the triad bandwidth,
roofline reports and a mesh's collective counts).

Every public name of the JAX package's ``__init__`` and ``parallel``
package is here; ``utils/compat.py`` is a JAX-only shim with no
counterpart.
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
    EisenstatSSOROperator,
    FunctionPreconditioner,
    ICPreconditioner,
    ILUPreconditioner,
    IdentityPreconditioner,
    Preconditioner,
    RedBlackICPreconditioner,
    as_preconditioner,
)
from .operators.rb_reduce import RBReducedSystem
from .operators.stencil import (
    GradientOperator,
    StencilOperator,
    advection_diffusion_stencil,
    laplacian,
)
from .operators.sparse import (
    BSRMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
    HYBMatrix,
    compress_values,
    csr_from_dense,
    dia_from_dense,
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
from .solvers.stationary import (
    SingularError,
    gauss_seidel,
    gauss_seidel_iterable,
    jacobi,
    jacobi_iterable,
    sor,
    sor_iterable,
    ssor,
    ssor_iterable,
)
from .ops.givens import givens
from .ops.hessenberg import hessenberg_lstsq
from .ops.orthogonalize import ORTH_METHODS, orthogonalize_and_normalize
from .ops.triangular import LevelScheduledTriangular
from .utils.dtypes import zerox
from .utils.history import ConvergenceHistory
from .utils.io import load_matrix_market
from .utils.spectral import gershgorin_bounds, power_bound
from . import parallel
