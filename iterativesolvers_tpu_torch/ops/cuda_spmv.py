"""DIA SpMV (+ fused <u, Ax>): the CUDA kernel's wrappers and their plain
PyTorch version.

Port of the Pallas kernels ``dia_spmv`` / ``dia_spmv_dot``
(``iterativesolvers_tpu/ops/pallas_spmv.py:142,149``); the kernel is
``csrc/dia_spmv.cu``.  It computes

    y[i] = sum_d diag_d[i] * x[i + off_d]      (diag_d[i] = A[i, i + off_d])

where a column outside ``[0, n)`` reads 0; ``dia_spmv_dot`` also returns
``sum_i u[i] * y[i]`` in x's dtype.  x and u are 1-D f32 of length n (the
matrix is square); the diagonals are f32, bf16 or int8, and every product is
promoted to f32 before it is summed.

A CUDA tensor launches the kernel or raises (also past its limit of 32-bit
row indices); a CPU tensor takes the plain version :func:`dia_spmv_plain`,
which has no such limit.  A launch takes at most ``MAX_DIAGS`` diagonals: a
matrix with more launches the kernel once for each group of ``MAX_DIAGS``,
in order, each launch after the first adding to the y the one before
stored, so that every row is the FMA chain one launch over all the
diagonals would make; only the last launch takes the dot.  Each launch is
counted.

The kernel takes runs of ``run_rows(diag dtype)`` rows a thread (16 bytes
of each diagonal), and finishes the dot in the same launch on a ticket
(``cuda_stencil.dot_ticket``) and partial sums kept per shape, device and
stream, so that launches on concurrent streams share neither.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_stencil import (VEC_BYTES, _check_out, aligned, blocks_per_sm,
                           dot_ticket, grid_for, max_rows, on_device,
                           raw_stream, run_rows)

__all__ = ["dia_spmv", "dia_spmv_dot", "dia_spmv_rows", "dia_spmv_plain",
           "MAX_DIAGS", "DIAG_DTYPES"]

MAX_DIAGS = 16                   # diagonals one launch takes
_DIAG_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
DIAG_DTYPES = tuple(_DIAG_CODE)


def dia_spmv_plain(diags, offsets, x, u=None):
    """The kernel's function in plain PyTorch: shifted multiply-adds over a
    zero-padded x, each product in ``promote(diag, x)``, summed in the order
    of the diagonals.  Also the plain product of ``DIAMatrix.mv`` for any x:
    (m,) or (m, k), of a matrix with ``len(diags[0])`` rows and m columns."""
    n, m = diags[0].shape[0], x.shape[0]
    dt = torch.promote_types(diags[0].dtype, x.dtype)
    pad = max(max((abs(o) for o in offsets), default=0), 1)
    rest = tuple(x.shape[1:])
    xp = torch.cat([x.new_zeros((pad,) + rest), x,
                    x.new_zeros((pad + max(n - m, 0),) + rest)]).to(dt)
    y = torch.zeros((n,) + rest, dtype=dt, device=x.device)
    for d, off in zip(diags, offsets):
        # row i reads x[i + off]  ->  slice xp starting at pad + off
        d = d.to(dt) if x.ndim == 1 else d.to(dt)[:, None]
        y = y + d * xp[pad + off:pad + off + n]
    if u is None:
        return y
    return y, torch.sum(u * y)


def _check(diags, offsets, x, u):
    """The function's contract, on every device."""
    n = x.shape[0] if x.ndim == 1 else -1
    if x.ndim != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous 1-D f32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}")
    dev = x.get_device()
    if u is not None and u is not x and (
            u.shape != x.shape or u.dtype != x.dtype
            or u.get_device() != dev or not u.is_contiguous()):
        raise ValueError("u must match x in shape, dtype and device")
    if not diags or len(diags) != len(offsets):
        raise ValueError(
            f"need one diagonal per offset, at least one; got {len(diags)} "
            f"diagonals and {len(offsets)} offsets")
    dt = diags[0].dtype
    for d in diags:
        if (d.shape != (n,) or d.dtype != dt or d.get_device() != dev
                or not d.is_contiguous()):
            raise ValueError(
                "diagonals must be contiguous, of x's length and device, "
                "and of one dtype")
    if diags[0].dtype not in _DIAG_CODE:
        raise TypeError(f"DIA kernel takes f32, bf16 or int8 diagonals, got "
                        f"{diags[0].dtype}")


@functools.lru_cache(maxsize=64)
def _check_kernel(n, offsets):
    """The kernel's limit, checked before a launch (the plain version has
    none)."""
    span = max(abs(int(o)) for o in offsets)
    if n > max_rows(span):
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dia_spmv")
    lib.its_dia_spmv.restype = ctypes.c_int
    lib.its_dia_spmv.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.its_dia_blocks_per_sm.restype = ctypes.c_int
    lib.its_dia_blocks_per_sm.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=64)
def _grid(dtype, with_dot, nd, n, device, stream):
    """The grid (as many blocks as the SMs hold, with the dot as without
    it) and with the dot the partials and ticket of ``stream``, the current
    stream (made on it)."""
    bps = blocks_per_sm(_lib().its_dia_blocks_per_sm, _DIAG_CODE[dtype],
                        int(with_dot), nd, device=device)
    grid = grid_for(bps, device, n, run_rows(dtype))
    if not with_dot:
        return grid, None, None
    partials = torch.empty(grid, dtype=torch.float32, device=device)
    return grid, partials, dot_ticket(device, stream).data_ptr()


@functools.lru_cache(maxsize=64)
def _diag_args(ptrs, offsets):
    """The diagonals' pointers and offsets as C arrays (kept alive by the
    cache), by address; and whether every pointer is 16-byte aligned."""
    nd = len(ptrs)
    arrays = ((ctypes.c_void_p * nd)(*ptrs),
              (ctypes.c_int * nd)(*[int(o) for o in offsets]))
    return (ctypes.addressof(arrays[0]), ctypes.addressof(arrays[1]),
            all(p % VEC_BYTES == 0 for p in ptrs), arrays)


def _launch(diags, offsets, x, u, out=None):
    """(y, dot, launches): one launch for each group of ``MAX_DIAGS``
    diagonals, the dot (``u`` given) in the last."""
    if x.device.type != "cuda":
        raise ValueError(f"DIA kernel runs on CUDA tensors, got {x.device}")
    n = x.shape[0]
    _check_kernel(n, tuple(offsets))
    dev = x.device
    stream = raw_stream(dev)
    y = torch.empty_like(x) if out is None else _check_out(out, x)
    dot = None
    starts = range(0, len(diags), MAX_DIAGS)
    for g0 in starts:
        ds, offs = diags[g0:g0 + MAX_DIAGS], tuple(offsets[g0:g0 + MAX_DIAGS])
        dptr, optr, diags_aligned, _ = _diag_args(
            tuple(d.data_ptr() for d in ds), offs)
        with_dot = u is not None and g0 == starts[-1]
        grid, partials, ticket = _grid(ds[0].dtype, with_dot, len(ds), n,
                                       dev, stream if with_dot else 0)
        if with_dot:
            dot = torch.empty((), dtype=torch.float32, device=dev)
            red = (partials.data_ptr(), ticket, dot.data_ptr())
        else:
            red = (None, None, None)
        uu = u if with_dot else x
        vec = diags_aligned and aligned(x, uu, y)
        with on_device(dev):
            err = _lib().its_dia_spmv(
                _DIAG_CODE[ds[0].dtype], int(with_dot), dptr, optr, len(ds),
                x.data_ptr(), uu.data_ptr(), y.data_ptr(), *red, n, grid,
                int(vec), int(g0 > 0), stream)
        if err != 0:
            raise RuntimeError(f"DIA kernel launch failed (error {err})")
    return y, dot, len(starts)


def dia_spmv(diags, offsets, x, out=None):
    """y = A x for a DIA operator (sequence of 1-D diagonals + offsets).
    ``out``, a contiguous tensor like x, takes y on a CUDA launch."""
    _check(diags, offsets, x, None)
    if x.device.type == "cpu":
        return dia_spmv_plain(diags, offsets, x)
    y, _, launches = _launch(diags, offsets, x, None, out)
    dia_spmv.launches += launches
    return y


def dia_spmv_rows(diags, offsets, X):
    """Y = rows ``A x_i`` of the (k, n) f32 panel X (vectors as rows).  A
    CUDA tensor launches the DIA kernel once per row (and group of
    diagonals) into a contiguous (k, n) Y (each launch counted by
    :func:`dia_spmv`; the kernel's limit is checked before the first); a CPU tensor takes the plain version of
    the (n, k) columns ``X.T``.  Each row of Y is the same bits as
    :func:`dia_spmv` of that row on the same device."""
    if X.ndim != 2:
        raise ValueError(f"X must be a (k, n) panel, got {tuple(X.shape)}")
    X = X if X.stride(1) == 1 else X.contiguous()
    if X.shape[0]:
        _check(diags, offsets, X[0], None)
    if X.device.type == "cpu":
        return dia_spmv_plain(diags, offsets, X.T).T
    if X.device.type != "cuda":
        raise ValueError(f"DIA kernel runs on CUDA tensors, got {X.device}")
    _check_kernel(X.shape[1], tuple(offsets))
    Y = torch.empty_like(X, memory_format=torch.contiguous_format)
    for i in range(X.shape[0]):
        dia_spmv(diags, offsets, X[i], out=Y[i])
    return Y


def dia_spmv_dot(diags, offsets, x, u):
    """(A x, <u, A x>) in one fused pass (real dtypes)."""
    _check(diags, offsets, x, u)
    if x.device.type == "cpu":
        return dia_spmv_plain(diags, offsets, x, u)
    y, dot, launches = _launch(diags, offsets, x, u)
    dia_spmv_dot.launches += launches
    return y, dot


dia_spmv.launches = 0
dia_spmv_dot.launches = 0
