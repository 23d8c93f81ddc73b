"""iterativesolvers_tpu_torch — the PyTorch / CUDA port of iterativesolvers_tpu.

The JAX package ``iterativesolvers_tpu`` is the reference; this package
follows its layout (``operators/``, ``ops/``, ``solvers/``, ``utils/``) and
module names, and imports no JAX.  Operators and fixtures are built on
``device="cuda"`` unless the caller asks for another device; solvers run on
the operator's device.  Each Pallas kernel of the reference is a hand-written
CUDA kernel here (``csrc/``, built by ``nvcc`` at first use), launched for
CUDA tensors; a CPU tensor takes the kernel's plain PyTorch version.

This slice ports CG with the stencil and DIA operators.
"""

from .operators.linear_operator import (
    AdjointOperator,
    FunctionOperator,
    LinearOperator,
    MatrixOperator,
    as_operator,
)
from .operators.preconditioners import (
    DiagonalPreconditioner,
    FunctionPreconditioner,
    IdentityPreconditioner,
    Preconditioner,
    as_preconditioner,
)
from .operators.stencil import (
    StencilOperator,
    advection_diffusion_stencil,
    laplacian,
)
from .operators.sparse import (
    DIAMatrix,
    compress_values,
    values_representable,
)
from .solvers.cg import cg, cg_iterator
from .utils.dtypes import zerox
from .utils.history import ConvergenceHistory
