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
and stores, and finds the grid positions by a multiply-high and a shift: the constants of
:func:`fast_divisor`, computed here in the cached plan.  Its dot is summed
in an order fixed by n and the grid (``csrc/common.cuh``; the grid is
chosen as without the dot), and finished in the same launch by the block
that finishes last, which counts on a ticket: one int32 per device and stream
(:func:`dot_ticket`), 0 between launches.  What does not change from call to call (the grid, the
terms packed for the C call, the blocks' partial sums) is kept per stencil,
n, dtype, device and, with the dot, stream (:func:`launch_plan`), so that a
call costs the host little beside the kernel, and launches on concurrent
streams share no ticket and no partials.

A CUDA tensor launches the kernel or raises (also past the kernel's limits:
at most ``MAX_TERMS`` terms, 32-bit row indices); a CPU tensor takes the
plain version :func:`stencil_apply_plain`, which has no such limits.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["stencil_apply", "stencil_apply_rows", "stencil_apply_plain",
           "stencil_sum", "MAX_TERMS", "VEC_BYTES", "STENCIL_RUN", "run_rows",
           "fast_divisor", "dot_ticket", "grid_for"]

MAX_TERMS = 8
_THREADS = 256
# bytes of one vector load or store (csrc/common.cuh kVecBytes)
VEC_BYTES = 16
# rows a thread of the stencil kernel takes (csrc/stencil.cuh kStencilRun)
STENCIL_RUN = 8
# the kernels' indices are 32-bit: rows, windows (a run and one vector past
# it) and the grid-stride loop's run index stay below 2^31 for
# n + span + INDEX_SLACK < 2^31 (a grid of at most 2^16 blocks)
INDEX_SLACK = 2**24
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def run_rows(dtype) -> int:
    """Elements of ``dtype`` in one 16-byte vector (4 for f32, 8 for bf16,
    16 for int8): the rows a thread of the DIA kernel takes for diagonals of
    ``dtype``."""
    return VEC_BYTES // torch.empty((), dtype=dtype).element_size()


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


@functools.lru_cache(maxsize=None)
def dot_ticket(device, stream: int) -> torch.Tensor:
    """The counter of the kernels' in-launch dot on ``device``'s stream
    ``stream`` (a raw handle, :func:`raw_stream`): blocks draw tickets from
    it and the last one sets it back to 0.  One per device and stream, so
    that launches that may overlap draw from tickets of their own; kept for
    the process, since the launch plans hold its address."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_for(blocks_per_sm: int, device, n: int, rows: int) -> int:
    """Blocks of ``_THREADS`` threads for ``n`` rows in runs of ``rows``:
    as many as the SMs hold at once (``blocks_per_sm`` each), or fewer where
    n needs fewer; a grid-stride loop covers the rest."""
    runs = -(-n // rows)
    return max(1, min(-(-runs // _THREADS),
                      max(1, blocks_per_sm) * _sm_count(device)))


class _Plan(NamedTuple):
    """The sum in the order it is added: ``(off, coeff, term)`` with
    ``term = (stride, extent)`` for an off-diagonal term and None for the
    center; and the kernel's arguments (ints and ctypes arrays)."""

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
    # fast_div constants of each term's stride and extent: smul, sshr,
    # emul, eshr
    magic = [v for j in masked for d in order[j][2] for v in fast_divisor(d)]
    args = (
        k,
        IntK(*[order[j][0] for j in masked]),
        IntK(*[order[j][0] // order[j][2][0] for j in masked]),
        IntK(*[order[j][2][0] for j in masked]),
        IntK(*[order[j][2][1] for j in masked]),
        (ctypes.c_uint * max(4 * k, 1))(*magic),
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


def max_rows(span: int) -> int:
    """The largest n the stencil and DIA kernels take with offsets up to
    ``span``: 32-bit indices (``INDEX_SLACK``)."""
    return 2**31 - 1 - INDEX_SLACK - span


def _check_kernel(n, terms):
    """The kernel's limits, checked before a launch (the plain version has
    none)."""
    if len(terms) > MAX_TERMS:
        raise ValueError(f"at most {MAX_TERMS} stencil terms, got {len(terms)}")
    if any(max(s, e) >= 2**31 for (_, s, e) in terms):
        raise ValueError("stencil strides and extents must be below 2^31")
    span = max((abs(o) for (o, _, _) in terms), default=0)
    if n > max_rows(span):
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


# the plan's arguments of its_stencil_pack_terms (stencil.cuh pack_terms):
# nterms, off, step, stride, extent, magic, bit, nsum, center_bit, sum_off,
# sum_coeff
_TERMS_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("stencil")
    lib.its_stencil_apply.restype = ctypes.c_int
    lib.its_stencil_apply.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2)
    lib.its_stencil_terms_bytes.restype = ctypes.c_int
    lib.its_stencil_terms_bytes.argtypes = []
    lib.its_stencil_pack_terms.restype = ctypes.c_int
    lib.its_stencil_pack_terms.argtypes = [ctypes.c_void_p] + _TERMS_ARGTYPES
    lib.its_stencil_blocks_per_sm.restype = ctypes.c_int
    lib.its_stencil_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    return lib


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, without building a
    Stream object (a wrapper's host time counts beside a ~40 µs kernel)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device):
    """The context in which a C call launches on ``device``: none where it
    is the current device already (the common case, and the cheap one)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def blocks_per_sm(fn, *args, device) -> int:
    """``fn(*args, &blocks)`` of a kernel library on ``device``: the blocks
    of that kernel one SM holds at once."""
    blocks = ctypes.c_int(0)
    with on_device(device):
        err = fn(*args, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed (error {err})")
    return blocks.value


def packed_terms(plan: _Plan):
    """The plan's terms packed as the kernels' ``StencilTerms`` (a host
    buffer the C calls copy), once per stencil, so that a launch passes one
    pointer."""
    lib = _lib()
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
    grid = grid_for(blocks_per_sm(blocks_fn, *blocks_args, device=device),
                    device, n, STENCIL_RUN)
    partials = (torch.empty(grid, dtype=torch.float32, device=device)
                if with_dot else None)
    buf = packed_terms(plan)
    ticket = dot_ticket(device, stream).data_ptr() if with_dot else None
    return Launch(grid, ctypes.addressof(buf), partials, ticket, buf)


@functools.lru_cache(maxsize=64)
def _launch(n, center, terms, coeffs, conj, dtype, with_dot, device, stream):
    _check_terms(terms)
    _check_kernel(n, terms)
    return launch_plan(_plan(center, terms, coeffs, conj, dtype), n, with_dot,
                       device, stream, _lib().its_stencil_blocks_per_sm,
                       _DTYPE_CODE[dtype], int(with_dot))


def aligned(*tensors) -> bool:
    """Every tensor starts on a 16-byte boundary (the kernels' vector path;
    else they take their per-row loads)."""
    return all(t.data_ptr() % VEC_BYTES == 0 for t in tensors)


def stencil_apply(n, center, terms, coeffs, x, *, conj=False, with_dot=False,
                  out=None):
    """y = A x (and ``<x, Ax>`` in f32 with ``with_dot``) for the stencil
    ``(center, terms, coeffs)``; see the module docstring.  ``out``, a
    contiguous tensor like x, takes y on a CUDA launch."""
    n = int(n)
    if not (type(terms) is tuple and type(coeffs) is tuple
            and all(type(t) is tuple for t in terms)):
        terms, coeffs = _normal(terms, coeffs)
    _check_x(n, x)
    if x.device.type == "cpu":
        _check_terms(terms)
        return stencil_apply_plain(n, center, terms, coeffs, x, conj=conj,
                                   with_dot=with_dot)
    if x.device.type != "cuda":
        raise ValueError(f"stencil kernel runs on CUDA tensors, got {x.device}")
    dev = x.device
    stream = raw_stream(dev)
    # the plan without the dot holds nothing of a stream's
    launch = _launch(n, center, terms, coeffs, bool(conj), x.dtype,
                     bool(with_dot), dev, stream if with_dot else 0)
    y = torch.empty_like(x) if out is None else _check_out(out, x)
    if with_dot:
        dot = torch.empty((), dtype=torch.float32, device=dev)
        ptrs = (launch.partials.data_ptr(), launch.ticket, dot.data_ptr())
    else:
        ptrs = (None, None, None)
    with on_device(dev):
        err = _lib().its_stencil_apply(
            _DTYPE_CODE[x.dtype], int(with_dot), x.data_ptr(), y.data_ptr(),
            *ptrs, n, launch.grid, int(aligned(x, y)), launch.terms, stream)
    if err != 0:
        raise RuntimeError(f"stencil kernel launch failed (error {err})")
    stencil_apply.launches += 1
    return (y, dot) if with_dot else y


stencil_apply.launches = 0


def _check_out(out, x):
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like x")
    return out


def stencil_apply_rows(n, center, terms, coeffs, X, *, conj=False):
    """Y = rows ``A x_i`` of the (k, n) panel X (vectors as rows), in X's
    dtype.  A CUDA tensor launches the stencil kernel once per row into a
    contiguous (k, n) Y (each launch counted by :func:`stencil_apply`; the
    kernel's limits are checked before the first); a CPU tensor takes the
    plain version of the (n, k) columns ``X.T``.  Each row of Y is the same
    bits as :func:`stencil_apply` of that row on the same device (the plain
    sum is elementwise, so its layout does not change a bit)."""
    n = int(n)
    terms, coeffs = _normal(terms, coeffs)
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
    _check_kernel(n, terms)
    X = X if X.stride(1) == 1 else X.contiguous()
    Y = torch.empty_like(X, memory_format=torch.contiguous_format)
    for i in range(X.shape[0]):
        stencil_apply(n, center, terms, coeffs, X[i], conj=conj, out=Y[i])
    return Y
