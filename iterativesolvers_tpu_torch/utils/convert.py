"""Operator data carried across from the JAX package.

The port's counterpart of loading a model's weights: an operator of the JAX
package is taken apart into numpy arrays and Python tuples (for example
``np.asarray(A.diags[k])``, ``A.offsets``, ``St.terms``,
``float(St.center)``) and rebuilt here on ``device``.  Nothing of the JAX
package is imported: the caller hands over plain data.
"""

from __future__ import annotations

import numpy as np
import torch

from ..operators.sparse import DIAMatrix
from ..operators.stencil import StencilOperator

__all__ = ["dia_from_arrays", "stencil_from_arrays", "operator_from_arrays"]


def _tensor(a) -> torch.Tensor:
    """A copy of a host array as a tensor of the same dtype.  numpy has no
    bfloat16 of its own; an ``ml_dtypes`` bfloat16 array goes through f32,
    which holds every bfloat16 value exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def dia_from_arrays(diags, offsets, shape, device="cuda") -> DIAMatrix:
    """A :class:`DIAMatrix` from a sequence of 1-D host arrays (one per
    offset), the offsets and the shape.  The values keep their dtype."""
    return DIAMatrix([_tensor(d) for d in diags],
                     tuple(int(o) for o in offsets), tuple(shape),
                     device=device)


def stencil_from_arrays(n, center, terms, coeffs, dtype,
                        device="cuda") -> StencilOperator:
    """A :class:`StencilOperator` from its row count, center coefficient,
    (offset, stride, extent) terms, per-term coefficients and dtype."""
    return StencilOperator(
        int(n), _scalar(center), tuple(tuple(int(v) for v in t) for t in terms),
        tuple(_scalar(c) for c in coeffs), dtype=dtype, device=device)


def _scalar(c):
    a = np.asarray(c)
    return complex(a) if np.iscomplexobj(a) else float(a)


def operator_from_arrays(spec: dict, device="cuda"):
    """Dispatch on ``spec["kind"]``: ``"dia"`` takes the keys of
    :func:`dia_from_arrays`, ``"stencil"`` those of
    :func:`stencil_from_arrays`."""
    kind = spec.get("kind")
    args = {k: v for k, v in spec.items() if k != "kind"}
    if kind == "dia":
        return dia_from_arrays(device=device, **args)
    if kind == "stencil":
        return stencil_from_arrays(device=device, **args)
    raise ValueError(f"unknown operator kind {kind!r} (expected 'dia' or "
                     f"'stencil')")
