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

A CUDA tensor launches the kernel or raises (also past the kernel's limits:
at most ``MAX_DIAGS`` diagonals, 32-bit row indices); a CPU tensor takes the
plain version :func:`dia_spmv_plain`, which has no such limits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["dia_spmv", "dia_spmv_dot", "dia_spmv_plain", "MAX_DIAGS",
           "DIAG_DTYPES"]

MAX_DIAGS = 16
_THREADS = 256
_MAX_BLOCKS = 2048
_DIAG_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
DIAG_DTYPES = tuple(_DIAG_CODE)


def _grid(n: int) -> int:
    return max(1, min(-(-n // _THREADS), _MAX_BLOCKS))


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
    if u is not None and (u.shape != x.shape or u.dtype != x.dtype
                          or u.device != x.device or not u.is_contiguous()):
        raise ValueError("u must match x in shape, dtype and device")
    if not diags or len(diags) != len(offsets):
        raise ValueError(
            f"need one diagonal per offset, at least one; got {len(diags)} "
            f"diagonals and {len(offsets)} offsets")
    for d in diags:
        if (d.shape != (n,) or d.dtype != diags[0].dtype
                or d.device != x.device or not d.is_contiguous()):
            raise ValueError(
                "diagonals must be contiguous, of x's length and device, "
                "and of one dtype")
    if diags[0].dtype not in _DIAG_CODE:
        raise TypeError(f"DIA kernel takes f32, bf16 or int8 diagonals, got "
                        f"{diags[0].dtype}")


def _check_kernel(n, offsets):
    """The kernel's limits, checked before a launch (the plain version has
    none)."""
    if len(offsets) > MAX_DIAGS:
        raise ValueError(
            f"at most {MAX_DIAGS} diagonals, got {len(offsets)}")
    span = max(abs(int(o)) for o in offsets)
    if n + span + _THREADS * _MAX_BLOCKS >= 2**31:
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("dia_spmv").its_dia_spmv
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(diags, offsets, x, u):
    if x.device.type != "cuda":
        raise ValueError(f"DIA kernel runs on CUDA tensors, got {x.device}")
    n, nd = x.shape[0], len(diags)
    _check_kernel(n, offsets)
    ptrs = (ctypes.c_void_p * nd)(*[d.data_ptr() for d in diags])
    offs = (ctypes.c_int * nd)(*[int(o) for o in offsets])
    grid = _grid(n)
    with_dot = u is not None
    y = torch.empty_like(x)
    partials = torch.empty(grid if with_dot else 1, dtype=torch.float32,
                           device=x.device)
    dot = torch.empty((), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            _DIAG_CODE[diags[0].dtype], int(with_dot), ctypes.addressof(ptrs),
            ctypes.addressof(offs), nd, x.data_ptr(),
            (u if with_dot else x).data_ptr(), y.data_ptr(),
            partials.data_ptr(), dot.data_ptr(), n, grid, stream)
    if err != 0:
        raise RuntimeError(f"DIA kernel launch failed (error {err})")
    return y, dot


def dia_spmv(diags, offsets, x):
    """y = A x for a DIA operator (sequence of 1-D diagonals + offsets)."""
    _check(diags, offsets, x, None)
    if x.device.type == "cpu":
        return dia_spmv_plain(diags, offsets, x)
    y, _ = _launch(diags, offsets, x, None)
    dia_spmv.launches += 1
    return y


def dia_spmv_dot(diags, offsets, x, u):
    """(A x, <u, A x>) in one fused pass (real dtypes)."""
    _check(diags, offsets, x, u)
    if x.device.type == "cpu":
        return dia_spmv_plain(diags, offsets, x, u)
    out = _launch(diags, offsets, x, u)
    dia_spmv_dot.launches += 1
    return out


dia_spmv.launches = 0
dia_spmv_dot.launches = 0
