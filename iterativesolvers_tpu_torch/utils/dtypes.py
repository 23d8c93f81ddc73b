"""Type utilities (port of ``iterativesolvers_tpu/utils/dtypes.py``).

  * ``solve_dtype``   ~ ``Adivtype`` (src/common.jl:11): the element type of
    ``one(eltype(b)) / one(eltype(A))``.
  * ``zerox``         ~ ``zerox`` (src/common.jl:18-23): a zero-initialized
    solution vector of the promoted type.

The promoted type is torch's type promotion of the operands, so f32 problems
stay f32, and int8 / bf16 stored values with an f32 ``b`` solve in f32.
Every function takes a torch dtype, a numpy dtype or a name ("bfloat16").
"""

from __future__ import annotations

import numpy as np
import torch

_NAMES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    """The torch dtype for a torch dtype, numpy dtype/type or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _NAMES:
        return _NAMES[dtype]
    if getattr(dtype, "__name__", None) == "bfloat16" or str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def host_tensor(a) -> torch.Tensor:
    """A copy of a host array as a tensor of the same dtype.  numpy has no
    bfloat16 of its own; an ``ml_dtypes`` bfloat16 array goes through f32,
    which holds every bfloat16 value exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def solve_dtype(a_dtype, b_dtype) -> torch.dtype:
    """dtype of ``b / A`` — the natural dtype for the solution iterates."""
    return torch.promote_types(as_dtype(a_dtype), as_dtype(b_dtype))


def real_dtype(dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) dtype — used for norms/tols."""
    dt = as_dtype(dtype)
    return dt.to_real() if dt.is_complex else dt


def zerox(A, b):
    """Zero initial guess with the promoted solve dtype (src/common.jl:18-23)."""
    return torch.zeros(b.shape, dtype=solve_dtype(A.dtype, b.dtype),
                       device=b.device)


def eps(dtype) -> float:
    return float(torch.finfo(real_dtype(dtype)).eps)


def default_reltol(dtype) -> float:
    """``sqrt(eps(real(T)))`` — the reference's default reltol (src/cg.jl:121),
    the square root taken in ``real(T)`` as the JAX package takes it."""
    rt = real_dtype(dtype)
    return float(torch.tensor(eps(rt), dtype=rt).sqrt())
