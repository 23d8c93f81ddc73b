"""Panel modified Gram-Schmidt: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the Pallas kernel ``panel_mgs``
(``iterativesolvers_tpu/ops/pallas_mgs.py:294``; its chunk sweep ``:115`` and
its row-buffer sweep ``:186`` compute the same function) in GMRES's form; the
kernel is ``csrc/panel_mgs.cu``.  For j = 0..k in order

    h[j] = <V[j], w>,   w -= h[j] V[j]

then ``nrm = |w|``, ``h[j] = 0`` for j > k, and ``w / nrm * do`` is written
as panel row ``k + 1`` in V's dtype, in place (``do = 0``, a masked step,
writes zeros): ``w_in = sum_j h[j] V[j] + nrm * V[k + 1]``.  Rows past k
are never read, and no row but k + 1 is written.  The panel V is a flat
``(m1, n)`` tensor, f32 or bf16 (the GMRES-IR panel); w is f32 and the
arithmetic is f32.  ``k`` and ``do`` are 0-d int32 tensors on V's device, so
GMRES issues a step without a host read.  The TPU's ``(rows, 512)`` padded
panel was a re-tiling artifact of the TPU and is not carried over.

A CUDA tensor launches the kernel (counted on ``panel_mgs.launches``) or
raises; a CPU tensor takes the plain version :func:`panel_mgs_plain`, whose
sweep is the MGS of ``ops/orthogonalize.py`` masked at k.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_stencil import _THREADS
from .orthogonalize import mgs_rows

__all__ = ["panel_mgs", "panel_mgs_plain", "check_panel", "PANEL_DTYPES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PANEL_DTYPES = tuple(_DTYPE_CODE)


def panel_mgs_plain(V, w, k, do):
    """The kernel's function in plain PyTorch, f32 arithmetic: writes row
    ``k + 1`` of V in place and returns ``(h, nrm)``.  The row is
    ``y * (1 / nrm)``, as the TPU kernels and the CUDA kernel form it.  The
    sums are ``torch.sum`` (pairwise on the CPU): ``vector_norm`` of an f32
    vector of 1M entries is 1e-5 off on the CPU."""
    y, h = mgs_rows(V, w.float(), k)
    nrm = torch.sqrt(torch.sum(y * y))
    inv = torch.where(nrm == 0, 1.0, 1.0 / nrm) * do.float()
    V.index_copy_(0, (k + 1).reshape(1).long(), (y * inv).to(V.dtype)[None])
    return h, nrm


def _check(V, w, k, do):
    """The function's contract, on every device."""
    check_panel(V, k, do)
    n = V.shape[1]
    if (w.shape != (n,) or w.dtype != torch.float32 or w.device != V.device
            or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous f32 ({n},) vector on the "
                         f"panel's device, got {w.dtype} {tuple(w.shape)}")


def check_panel(V, k, do=None):
    """The panel and step scalars every panel kernel takes: V a contiguous
    (m1, n) f32 or bf16 tensor, k (and do) 0-d int32 tensors on its
    device, and m1 >= 2 where a row k + 1 is written."""
    if V.ndim != 2 or V.dtype not in _DTYPE_CODE or not V.is_contiguous():
        raise ValueError(f"V must be a contiguous (m1, n) f32 or bf16 panel, "
                         f"got {V.dtype} {tuple(V.shape)}")
    scalars = (k,) if do is None else (k, do)
    for s in scalars:
        if (not isinstance(s, torch.Tensor) or s.shape != ()
                or s.dtype != torch.int32 or s.device != V.device):
            raise ValueError("k and do must be 0-d int32 tensors on the "
                             "panel's device")
    if do is not None and V.shape[0] < 2:
        raise ValueError("a panel row k + 1 needs m1 >= 2")


def _check_kernel(n):
    """The kernel's limit, checked before a launch (the plain version has
    none): 32-bit row indices, past n by up to one grid of threads (a
    cooperative grid holds at most 32 blocks on each of fewer than 2048
    SMs)."""
    if n + _THREADS * 32 * 2048 >= 2**31:
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("panel_mgs")
    lib.its_panel_mgs.restype = ctypes.c_int
    lib.its_panel_mgs.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.its_panel_mgs_grid.restype = ctypes.c_int
    lib.its_panel_mgs_grid.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=64)
def _grid(dtype_code, n, device_index):
    """The cooperative grid the kernel takes on this device: as many blocks
    as fit on the card at once, and no more than n needs."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().its_panel_mgs_grid(dtype_code, n, ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"panel_mgs occupancy query failed (error {err})")
    return grid.value


def panel_mgs(V, w, k, do):
    """GMRES's step: w orthogonalised against rows 0..k of V by MGS and
    normalised, written as row ``k + 1`` of V times ``do`` (in V's dtype, in
    place); returns ``(h, nrm)``.  See the module docstring."""
    _check(V, w, k, do)
    if V.device.type == "cpu":
        return panel_mgs_plain(V, w, k, do)
    if V.device.type != "cuda":
        raise ValueError(f"panel_mgs kernel runs on CUDA tensors, got "
                         f"{V.device}")
    m1, n = V.shape
    _check_kernel(n)
    code = _DTYPE_CODE[V.dtype]
    grid = _grid(code, n, V.device.index)
    dev = V.device
    y = torch.empty(n, dtype=torch.float32, device=dev)
    partials = torch.empty((m1 + 1) * grid, dtype=torch.float32, device=dev)
    h = torch.empty(m1, dtype=torch.float32, device=dev)
    nrm = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().its_panel_mgs(
            code, V.data_ptr(), w.data_ptr(), y.data_ptr(),
            partials.data_ptr(), h.data_ptr(), nrm.data_ptr(), k.data_ptr(),
            do.data_ptr(), n, m1, grid, stream)
    if err != 0:
        raise RuntimeError(f"panel_mgs kernel launch failed (error {err})")
    panel_mgs.launches += 1
    return h, nrm


panel_mgs.launches = 0
