"""Stencil SpMV (+ fused <x, Ax>): the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the Pallas kernel ``stencil_apply``
(``iterativesolvers_tpu/ops/pallas_stencil.py:230``); the kernel is
``csrc/stencil.cu``.  It computes

    y[i] = center * x[i] + sum_t c_t * x[i + off_t]

where term ``t = (off, stride, extent)`` counts only where the grid axis it
couples stays on the grid (``pos = (i // stride) % extent`` and
``0 <= pos + off // stride < extent``) and ``0 <= i + off < n``.  With
``with_dot`` it also returns ``<x, y>`` in f32.  ``conj=True`` applies the
adjoint: offsets negated, coefficients conjugated.

x is 1-D, f32 or bf16; y comes out in x's dtype and the dot in f32.  The
coefficients are rounded to x's dtype, as the TPU kernel rounds them to the
stream dtype; the arithmetic is f32.  The products are summed in ascending
offset order, the center at offset 0, starting from 0: the order of the DIA
kernel on a DIAMatrix with sorted offsets, so a Laplacian gives the same bits
in both forms (see ``csrc/stencil.cu``).  The TPU plan had no kernel for
n < 2048 or for a block period too large for VMEM; this kernel takes every
n >= 1.

A CUDA tensor launches the kernel or raises (also past the kernel's limits:
at most ``MAX_TERMS`` terms, 32-bit row indices); a CPU tensor takes the
plain version :func:`stencil_apply_plain`, which has no such limits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["stencil_apply", "stencil_apply_plain", "stencil_sum", "MAX_TERMS"]

MAX_TERMS = 8
_THREADS = 256
_MAX_BLOCKS = 2048
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _grid(n: int) -> int:
    return max(1, min(-(-n // _THREADS), _MAX_BLOCKS))


class _Plan(NamedTuple):
    """The sum in the order it is added: ``(off, coeff, term)`` with
    ``term = (stride, extent)`` for an off-diagonal term and None for the
    center; and the kernel's arguments (ctypes arrays)."""

    order: tuple
    args: tuple


@functools.lru_cache(maxsize=64)
def _plan(center, terms, coeffs, conj, dtype) -> _Plan:
    def rnd(c):
        if conj and isinstance(c, complex):
            c = c.conjugate()
        return torch.tensor(c, dtype=dtype).item()

    eff = [(-o if conj else o, s, e, rnd(c))
           for (o, s, e), c in zip(terms, coeffs)]
    order = sorted([(0, rnd(center), None)]
                   + [(o, c, (s, e)) for (o, s, e, c) in eff],
                   key=lambda t: t[0])
    # positions in `order` of the off-diagonal terms, grouped by (stride,
    # extent), so that the kernel computes each grid position once per group
    masked = sorted((j for j, t in enumerate(order) if t[2] is not None),
                    key=lambda j: order[j][2])
    k = len(masked)
    IntK, IntS, FloatS = (ctypes.c_int * max(k, 1), ctypes.c_int * (k + 1),
                          ctypes.c_float * (k + 1))
    args = (
        k,
        IntK(*[order[j][0] for j in masked]),
        IntK(*[order[j][0] // order[j][2][0] for j in masked]),
        IntK(*[order[j][2][0] for j in masked]),
        IntK(*[order[j][2][1] for j in masked]),
        IntK(*masked),
        k + 1,
        next(j for j, t in enumerate(order) if t[2] is None),
        IntS(*[o for (o, _, _) in order]),
        FloatS(*[c for (_, c, _) in order]),
    )
    return _Plan(tuple(order), args)


def _normal(terms, coeffs):
    """Terms and coefficients as tuples (hashable: `_plan` is cached)."""
    return (tuple((int(o), int(s), int(e)) for (o, s, e) in terms),
            tuple(coeffs))


def stencil_sum(n, order, x):
    """``sum c * x[i + off]`` over ``order``, a sequence of ``(off, c,
    term)``: ``term = (stride, extent)`` counts the product only where that
    grid axis stays on the grid, None counts it everywhere; a column outside
    ``[0, n)`` reads 0.  Added in the order given, starting from 0, in x's
    dtype; x is (n,) or (n, k).  The one body of the plain stencil products:
    the kernel's (:func:`stencil_apply_plain`) and
    ``StencilOperator._apply``."""
    i = torch.arange(n, device=x.device)
    pad = max(max((abs(off) for (off, _, _) in order), default=0), 1)
    z = x.new_zeros((pad,) + tuple(x.shape[1:]))
    xp = torch.cat([z, x, z])
    y = torch.zeros_like(x)
    for off, c, term in order:
        shifted = xp[pad + off:pad + off + n]
        if term is None:
            y = y + c * shifted
            continue
        stride, extent = term
        p = (i // stride) % extent + off // stride
        valid = (p >= 0) & (p < extent)
        valid = valid if x.ndim == 1 else valid[:, None]
        y = y + torch.where(valid, c * shifted, 0.0)
    return y


def stencil_apply_plain(n, center, terms, coeffs, x, *, conj=False,
                        with_dot=False):
    """The kernel's function in plain PyTorch: the same sum order, f32
    arithmetic, y in x's dtype, dot in f32."""
    terms, coeffs = _normal(terms, coeffs)
    plan = _plan(center, terms, coeffs, bool(conj), x.dtype)
    xf = x.float()
    y = stencil_sum(n, plan.order, xf).to(x.dtype)
    if with_dot:
        return y, torch.sum(xf * y.float())
    return y


def _check(n, terms, x):
    """The function's contract, on every device."""
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"stencil kernel takes f32 or bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(s <= 0 or e <= 0 for (_, s, e) in terms):
        raise ValueError("stencil strides and extents must be positive")


def _check_kernel(n, terms):
    """The kernel's limits, checked before a launch (the plain version has
    none)."""
    if len(terms) > MAX_TERMS:
        raise ValueError(f"at most {MAX_TERMS} stencil terms, got {len(terms)}")
    span = max((abs(o) for (o, _, _) in terms), default=0)
    if n + span + _THREADS * _MAX_BLOCKS >= 2**31:
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("stencil").its_stencil_apply
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    return fn


def stencil_apply(n, center, terms, coeffs, x, *, conj=False, with_dot=False):
    """y = A x (and ``<x, Ax>`` in f32 with ``with_dot``) for the stencil
    ``(center, terms, coeffs)``; see the module docstring."""
    n = int(n)
    terms, coeffs = _normal(terms, coeffs)
    _check(n, terms, x)
    if x.device.type == "cpu":
        return stencil_apply_plain(n, center, terms, coeffs, x, conj=conj,
                                   with_dot=with_dot)
    if x.device.type != "cuda":
        raise ValueError(f"stencil kernel runs on CUDA tensors, got {x.device}")
    _check_kernel(n, terms)
    (nterms, off, step, stride, extent, bit, nsum, center_bit, sum_off,
     sum_coeff) = _plan(center, terms, coeffs, bool(conj), x.dtype).args
    grid = _grid(n)
    y = torch.empty_like(x)
    partials = torch.empty(grid if with_dot else 1, dtype=torch.float32,
                           device=x.device)
    dot = torch.empty((), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            _DTYPE_CODE[x.dtype], int(with_dot), x.data_ptr(), y.data_ptr(),
            partials.data_ptr(), dot.data_ptr(), n, grid, nterms,
            ctypes.addressof(off), ctypes.addressof(step),
            ctypes.addressof(stride), ctypes.addressof(extent),
            ctypes.addressof(bit), nsum, center_bit,
            ctypes.addressof(sum_off), ctypes.addressof(sum_coeff), stream)
    if err != 0:
        raise RuntimeError(f"stencil kernel launch failed (error {err})")
    stencil_apply.launches += 1
    return (y, dot) if with_dot else y


stencil_apply.launches = 0
