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

The kernel takes runs of ``STENCIL_RUN`` rows a thread, with 16-byte loads
and stores, and finds the grid positions by a multiply-high and a shift:
the constants of :func:`fast_divisor`, computed here in the cached plan.
Its dot is summed in an order fixed by n and the grid (``csrc/common.cuh``;
the grid is chosen as without the dot), and finished in the same launch by
the block that finishes last, which counts on a ticket: one int32 per
device and stream (``_launch.dot_ticket``), 0 between launches.  What does
not change from call to call (the grid, the terms packed for the C call,
the blocks' partial sums) is kept per stencil, n, dtype, device and, with
the dot, stream (:func:`launch_plan`), so that a call costs the host little
beside the kernel, and launches on concurrent streams share no ticket and
no partials.

A CUDA tensor launches the kernel or raises (also past the kernel's limits:
at most ``MAX_TERMS`` terms, 32-bit row indices); a CPU tensor takes the
plain version :func:`stencil_apply_plain`, which has no such limits.

The halo form (``base``, ``n_global``, ``left``, ``right``) computes one
rank's block of a product whose vector is split in row blocks over ranks
(``parallel/sharded.py`` ``HaloStencilOperator``): x is rows
``[base, base + n)`` of a vector of ``n_global`` rows, ``left`` the ``h``
rows below the block and ``right`` the ``h`` rows above it (the halo
exchange's planes, ``h`` at least every offset).  y is those rows of
``A x_global``: each row masked as its global row, a column outside
``[0, n_global)`` 0, so that what the exchange wraps around the ring's ends
is dropped.  The sum order is the one-card form's, so the blocks of the
ranks are the bits of the whole vector's product; with the dot, the block's
share of ``<x, Ax>``.  On a CUDA tensor the same kernel takes it in one
launch (its halo overload, ``csrc/stencil.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._launch import (aligned, check_out, dot_ticket, grid_for, launch,
                      library, max_rows, query, raw_stream, run_rows)

__all__ = ["stencil_apply", "stencil_apply_rows", "stencil_apply_plain",
           "stencil_sum", "sum_plan", "normal_terms", "check_kernel",
           "grouped_terms", "packed_terms", "launch_plan", "MAX_TERMS",
           "STENCIL_RUN", "fast_divisor"]

MAX_TERMS = 8
# rows a thread of the stencil kernel takes (csrc/stencil.cuh kStencilRun)
STENCIL_RUN = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fast_divisor(d: int):
    """``(mul, shr)`` with ``floor(i / d) = (i * mul) >> (32 + shr)`` for
    every ``0 <= i < 2**31`` (``mul = 0`` for ``d = 1``: the quotient is i),
    as ``csrc/common.cuh``'s ``fast_div`` computes it with a multiply-high
    and a shift: ``l = ceil(log2 d)``, ``mul = ceil(2**(31 + l) / d)``,
    ``shr = l - 1`` (Granlund and Montgomery; CUTLASS's FastDivmod).  A
    divisor of 2**31 or more gives the quotient 0."""
    if d < 1:
        raise ValueError(f"divisor {d} < 1")
    if d == 1:
        return 0, 0
    if d >= 2**31:
        return 1, 31
    lg = (d - 1).bit_length()
    return -(-(1 << (31 + lg)) // d), lg - 1


class SumPlan(NamedTuple):
    """The sum in the order it is added: ``(off, coeff, term)`` with
    ``term = (stride, extent)`` for an off-diagonal term and None for the
    center; and the kernel's arguments (ints and ctypes arrays)."""

    order: tuple
    args: tuple


@functools.lru_cache(maxsize=64)
def sum_plan(center, terms, coeffs, conj, dtype) -> SumPlan:
    """The :class:`SumPlan` of the stencil with each coefficient rounded
    to ``dtype`` (conjugated with ``conj``), offsets negated with ``conj``;
    terms and coefficients as :func:`normal_terms` gives them."""
    def rnd(c):
        if conj and isinstance(c, complex):
            c = c.conjugate()
        return torch.tensor(c, dtype=dtype).item()

    eff = [(-o if conj else o, s, e, rnd(c))
           for (o, s, e), c in zip(terms, coeffs)]
    order = sorted([(0, rnd(center), None)]
                   + [(o, c, (s, e)) for (o, s, e, c) in eff],
                   key=lambda t: t[0])
    # the off-diagonal terms, each with its position in `order` as its bit
    masked = [j for j, t in enumerate(order) if t[2] is not None]
    k = len(masked)
    IntS, FloatS = ctypes.c_int * (k + 1), ctypes.c_float * (k + 1)
    args = grouped_terms([(order[j][0],) + order[j][2] for j in masked],
                         masked) + (
        k + 1,
        next(j for j, t in enumerate(order) if t[2] is None),
        IntS(*[o for (o, _, _) in order]),
        FloatS(*[c for (_, c, _) in order]),
    )
    return SumPlan(tuple(order), args)


def grouped_terms(terms, bits):
    """The first arguments of ``stencil.cuh``'s ``pack_terms`` for
    ``terms`` (``(off, stride, extent)`` each, term j setting bit
    ``bits[j]``): nterms, then off, step, stride, extent, the fast_div
    constants of each stride and extent (smul, sshr, emul, eshr) and bit,
    as ctypes arrays of the terms grouped by (stride, extent), so that the
    kernels compute each grid position once per group."""
    group = sorted(range(len(terms)), key=lambda j: terms[j][1:])
    k = len(group)
    IntK = ctypes.c_int * max(k, 1)
    g = [terms[j] for j in group]
    magic = [v for (_, s, e) in g for d in (s, e) for v in fast_divisor(d)]
    return (k, IntK(*[o for (o, _, _) in g]),
            IntK(*[o // s for (o, s, _) in g]),
            IntK(*[s for (_, s, _) in g]), IntK(*[e for (_, _, e) in g]),
            (ctypes.c_uint * max(4 * k, 1))(*magic),
            IntK(*[bits[j] for j in group]))


def normal_terms(terms, coeffs):
    """Terms and coefficients as tuples (hashable: :func:`sum_plan` is
    cached)."""
    return (tuple((int(o), int(s), int(e)) for (o, s, e) in terms),
            tuple(coeffs))


def stencil_sum(n, order, x, halo=None):
    """``sum c * x[i + off]`` over ``order``, a sequence of ``(off, c,
    term)``: ``term = (stride, extent)`` counts the product only where that
    grid axis stays on the grid, None counts it everywhere; a column outside
    ``[0, n)`` reads 0.  Added in the order given, starting from 0, in x's
    dtype; x is (n,) or (n, k).  The one body of the plain stencil products:
    the kernel's (:func:`stencil_apply_plain`) and
    ``StencilOperator._apply``.  ``halo = (base, n_global, left, right)``:
    the halo form of the module's docstring (x 1-D)."""
    if halo is not None:
        return _halo_sum(n, order, x, *halo)
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


def _halo_sum(n, order, x, base, n_global, left, right):
    """stencil_sum's halo form: rows ``[base, base + n)`` of the product
    of the vector of ``n_global`` rows that holds ``left``, x and ``right``
    from global row ``base - h``."""
    h = left.shape[0]
    i = base + torch.arange(n, device=x.device)
    xp = torch.cat([left, x, right])
    y = torch.zeros_like(x)
    for off, c, term in order:
        j = i + off
        valid = (j >= 0) & (j < n_global)
        if term is not None:
            stride, extent = term
            p = (i // stride) % extent + off // stride
            valid = valid & (p >= 0) & (p < extent)
        y = y + torch.where(valid, c * xp[h + off:h + off + n], 0.0)
    return y


def _halo_args(n, terms, base, n_global, left, right):
    """``(base, n_global, left, right)`` of a halo-form call, checked, or
    None where the call gives none of them."""
    given = [v is not None for v in (base, n_global, left, right)]
    if not any(given):
        return None
    if not all(given):
        raise ValueError("the halo form takes base, n_global, left and right "
                         "together")
    base, n_global = int(base), int(n_global)
    if base < 0 or base + n > n_global:
        raise ValueError(f"rows [{base}, {base + n}) lie outside the "
                         f"{n_global} rows of the vector")
    h = left.shape[0]
    if left.ndim != 1 or right.ndim != 1 or right.shape[0] != h:
        raise ValueError("the halo form takes two 1-D planes of one length")
    if h < 1 or any(abs(o) > h for (o, _, _) in terms):
        raise ValueError(f"planes of {h} rows: they must hold every "
                         "offset's reach")
    return base, n_global, left, right


def stencil_apply_plain(n, center, terms, coeffs, x, *, conj=False,
                        with_dot=False, base=None, n_global=None, left=None,
                        right=None):
    """The kernel's function in plain PyTorch: the same sum order, f32
    arithmetic, y in x's dtype, dot in f32; with ``base``, ``n_global``,
    ``left`` and ``right``, the halo form (module docstring)."""
    terms, coeffs = normal_terms(terms, coeffs)
    plan = sum_plan(center, terms, coeffs, bool(conj), x.dtype)
    halo = _halo_args(n, terms, base, n_global, left, right)
    if halo is not None:
        halo = halo[:2] + (halo[2].float(), halo[3].float())
    xf = x.float()
    y = stencil_sum(n, plan.order, xf, halo).to(x.dtype)
    if with_dot:
        return y, torch.sum(xf * y.float())
    return y


def _check_x(n, x):
    """The function's contract, on every device (with _check_terms)."""
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"stencil kernel takes f32 or bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_terms(terms):
    if any(s <= 0 or e <= 0 for (_, s, e) in terms):
        raise ValueError("stencil strides and extents must be positive")


def check_kernel(n, terms):
    """The stencil kernels' limits, checked before a launch (the plain
    version has none)."""
    if len(terms) > MAX_TERMS:
        raise ValueError(f"at most {MAX_TERMS} stencil terms, got {len(terms)}")
    if any(max(s, e) >= 2**31 for (_, s, e) in terms):
        raise ValueError("stencil strides and extents must be below 2^31")
    span = max((abs(o) for (o, _, _) in terms), default=0)
    if n > max_rows(span):
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


def packed_terms(plan: SumPlan):
    """The plan's terms packed as the kernels' ``StencilTerms`` (a host
    buffer the C calls copy), once per stencil, so that a launch passes one
    pointer."""
    lib = library("stencil")
    buf = ctypes.create_string_buffer(lib.its_stencil_terms_bytes())
    args = [a if isinstance(a, int) else ctypes.addressof(a) for a in plan.args]
    if lib.its_stencil_pack_terms(buf, *args) != 0:
        raise ValueError("stencil terms the kernel does not take")
    return buf


class Launch(NamedTuple):
    """What a stencil launch needs that does not change from call to call:
    the grid, the packed terms (``buf``, by address in ``terms``), and with
    the dot the blocks' partials and the device's ticket."""

    grid: int
    terms: int
    partials: object
    ticket: int
    buf: object


def launch_plan(plan, n, with_dot, device, stream, blocks_fn, *blocks_args):
    """The Launch of ``plan`` for n rows on ``device``: as many blocks as
    the SMs hold, from the kernel's occupancy query ``blocks_fn(
    *blocks_args, &blocks)``, with the dot as without it; with the dot also
    the blocks' partials and the ticket of ``stream``, the current stream
    (made on it)."""
    grid = grid_for(query(blocks_fn, *blocks_args, device=device), device, n,
                    STENCIL_RUN)
    partials = (torch.empty(grid, dtype=torch.float32, device=device)
                if with_dot else None)
    buf = packed_terms(plan)
    ticket = dot_ticket(device, stream).data_ptr() if with_dot else None
    return Launch(grid, ctypes.addressof(buf), partials, ticket, buf)


@functools.lru_cache(maxsize=64)
def _launch_of(n, center, terms, coeffs, conj, dtype, with_dot, device,
               stream, halo=False):
    _check_terms(terms)
    check_kernel(n, terms)
    return launch_plan(sum_plan(center, terms, coeffs, conj, dtype), n,
                       with_dot, device, stream,
                       library("stencil").its_stencil_blocks_per_sm,
                       _DTYPE_CODE[dtype], int(with_dot), int(halo))


def stencil_apply(n, center, terms, coeffs, x, *, conj=False, with_dot=False,
                  out=None, base=None, n_global=None, left=None, right=None):
    """y = A x (and ``<x, Ax>`` in f32 with ``with_dot``) for the stencil
    ``(center, terms, coeffs)``; with ``base``, ``n_global``, ``left`` and
    ``right`` the halo form; see the module docstring.  ``out``, a
    contiguous tensor like x, takes y on a CUDA launch."""
    n = int(n)
    if not (type(terms) is tuple and type(coeffs) is tuple
            and all(type(t) is tuple for t in terms)):
        terms, coeffs = normal_terms(terms, coeffs)
    _check_x(n, x)
    halo = _halo_args(n, terms, base, n_global, left, right)
    if x.device.type == "cpu":
        _check_terms(terms)
        return stencil_apply_plain(n, center, terms, coeffs, x, conj=conj,
                                   with_dot=with_dot, base=base,
                                   n_global=n_global, left=left, right=right)
    if x.device.type != "cuda":
        raise ValueError(f"stencil kernel runs on CUDA tensors, got {x.device}")
    dev = x.device
    stream = raw_stream(dev)
    # the plan without the dot holds nothing of a stream's
    lp = _launch_of(n, center, terms, coeffs, bool(conj), x.dtype,
                    bool(with_dot), dev, stream if with_dot else 0,
                    halo is not None)
    y = torch.empty_like(x) if out is None else check_out(out, x)
    if with_dot:
        dot = torch.empty((), dtype=torch.float32, device=dev)
        ptrs = (lp.partials.data_ptr(), lp.ticket, dot.data_ptr())
    else:
        ptrs = (None, None, None)
    if halo is None:
        launch(library("stencil").its_stencil_apply, _DTYPE_CODE[x.dtype],
               int(with_dot), x.data_ptr(), y.data_ptr(), *ptrs, n, lp.grid,
               aligned(x, y), lp.terms, stream, device=dev, what="stencil")
    else:
        _apply_halo(n, x, y, ptrs, lp, stream, *halo)
    stencil_apply.launches += 1
    return (y, dot) if with_dot else y


stencil_apply.launches = 0


def _apply_halo(n, x, y, ptrs, lp, stream, base, n_global, left, right):
    """The halo form's launch (its_stencil_apply_halo)."""
    h = left.shape[0]
    if (left.dtype != x.dtype or right.dtype != x.dtype
            or left.device != x.device or right.device != x.device
            or not left.is_contiguous() or not right.is_contiguous()):
        raise ValueError("left and right must be contiguous planes like x")
    if n_global + h > max_rows(0):
        raise ValueError(f"n_global = {n_global} is too large for 32-bit row "
                         "indices")
    V = run_rows(x.dtype)
    hvec = aligned(left, right) and h % V == 0 and n % V == 0
    launch(library("stencil").its_stencil_apply_halo, _DTYPE_CODE[x.dtype],
           int(ptrs[0] is not None), x.data_ptr(), y.data_ptr(), *ptrs, n,
           lp.grid, aligned(x, y), lp.terms, left.data_ptr(),
           right.data_ptr(), h, base, n_global, int(hvec), stream,
           device=x.device, what="stencil")


def stencil_apply_rows(n, center, terms, coeffs, X, *, conj=False):
    """Y = rows ``A x_i`` of the (k, n) panel X (vectors as rows), in X's
    dtype.  A CUDA tensor launches the stencil kernel once per row into a
    contiguous (k, n) Y (each launch counted by :func:`stencil_apply`; the
    kernel's limits are checked before the first); a CPU tensor takes the
    plain version of the (n, k) columns ``X.T``.  Each row of Y is the same
    bits as :func:`stencil_apply` of that row on the same device (the plain
    sum is elementwise, so its layout does not change a bit)."""
    n = int(n)
    terms, coeffs = normal_terms(terms, coeffs)
    if X.ndim != 2 or X.shape[1] != n:
        raise ValueError(f"X must have shape (k, {n}), got {tuple(X.shape)}")
    if X.dtype not in _DTYPE_CODE:
        raise TypeError(f"stencil kernel takes f32 or bf16 x, got {X.dtype}")
    _check_terms(terms)
    if X.device.type == "cpu":
        return stencil_apply_plain(n, center, terms, coeffs, X.T,
                                   conj=conj).T
    if X.device.type != "cuda":
        raise ValueError(f"stencil kernel runs on CUDA tensors, got {X.device}")
    check_kernel(n, terms)
    X = X if X.stride(1) == 1 else X.contiguous()
    Y = torch.empty_like(X, memory_format=torch.contiguous_format)
    for i in range(X.shape[0]):
        stencil_apply(n, center, terms, coeffs, X[i], conj=conj, out=Y[i])
    return Y
