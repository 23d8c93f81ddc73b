"""The shard-local sweeps of distributed CGS2: the CUDA kernels' wrappers and
their plain PyTorch versions.

Ports of the Pallas kernels ``_pallas_dots`` and ``_pallas_update``
(``iterativesolvers_tpu/parallel/panel_ortho.py:197`` and ``:227``); the
kernels are ``csrc/panel_ortho.cu``.  On one shard, with ``V`` the
``(m1, R, 512)`` panel block (f32 or bf16, rows past k zero), ``w`` an f32
``(R, 512)`` vector and ``k`` a 0-d int32 tensor on V's device:

    panel_dots(V, w, k)        -> part (m1,) f32:  part[j] = <V[j], w> for
                                  j <= k, 0 beyond
    panel_update(V, w, h, k)   -> (y, ss):  y = w - h[0] V[0] - ... - h[k] V[k]
                                  (rows in this order, f32), ss = sum(y * y)

A bf16 row is widened to f32 before its product.  Rows past k are never read
by the kernels, and GMRES issues both with no host read of k.

A CUDA tensor launches the kernel (counted on ``panel_dots.launches`` /
``panel_update.launches``) or raises; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["panel_dots", "panel_dots_plain", "panel_update",
           "panel_update_plain", "PANEL_DTYPES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PANEL_DTYPES = tuple(_DTYPE_CODE)


def _active(V, k):
    """(m1,) bool: rows 0..k."""
    return torch.arange(V.shape[0], device=V.device) <= k


def panel_dots_plain(V, w, k):
    """The dots kernel's function in plain PyTorch, f32 arithmetic."""
    m1 = V.shape[0]
    part = (V.reshape(m1, -1).float() * w.reshape(1, -1)).sum(dim=1)
    return torch.where(_active(V, k), part, 0.0)


def panel_update_plain(V, w, h, k):
    """The update kernel's function in plain PyTorch: the rows subtracted in
    order j = 0..k in f32 (a row past k has coefficient 0 and leaves y as it
    is); returns ``(y, ss)``."""
    hk = torch.where(_active(V, k), h, 0.0)
    y = w.clone()
    for j in range(V.shape[0]):
        y = y - hk[j] * V[j].float()
    return y, torch.sum(y * y)


def _check(V, w, k, h=None):
    """The functions' contract, on every device."""
    if V.ndim < 2 or V.dtype not in _DTYPE_CODE or not V.is_contiguous():
        raise ValueError(f"V must be a contiguous (m1, ...) f32 or bf16 panel "
                         f"block, got {V.dtype} {tuple(V.shape)}")
    if (w.shape != V.shape[1:] or w.dtype != torch.float32
            or w.device != V.device or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous f32 {tuple(V.shape[1:])} "
                         f"tensor on the panel's device, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if (not isinstance(k, torch.Tensor) or k.shape != ()
            or k.dtype != torch.int32 or k.device != V.device):
        raise ValueError("k must be a 0-d int32 tensor on the panel's device")
    if h is not None and (h.shape != V.shape[:1] or h.dtype != torch.float32
                          or h.device != V.device or not h.is_contiguous()):
        raise ValueError(f"h must be a contiguous f32 ({V.shape[0]},) tensor "
                         f"on the panel's device")


def _check_kernel(V, w):
    """The kernels' limits, checked before a launch (the plain versions have
    none): rows of a multiple of 4 entries, 16-byte aligned, and 32-bit
    indices of 4-entry groups."""
    n = w.numel()
    if n % 4 != 0 or n // 4 >= 2**31 - 2**12:
        raise ValueError(f"a row of {n} entries is not a multiple of 4 or "
                         f"too long for the kernels")
    if V.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("V and w must be 16-byte aligned")


def _device(V):
    if V.device.type != "cuda":
        raise ValueError(f"panel_ortho kernels run on CUDA tensors, got "
                         f"{V.device}")
    return V.device


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("panel_ortho")
    lib.its_panel_ortho_grid.restype = ctypes.c_int
    lib.its_panel_ortho_grid.argtypes = [ctypes.c_int]
    lib.its_panel_dots.restype = ctypes.c_int
    lib.its_panel_dots.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.its_panel_update.restype = ctypes.c_int
    lib.its_panel_update.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


def panel_dots(V, w, k):
    """Partial dots of the rows 0..k of the panel block V with w; see the
    module docstring."""
    _check(V, w, k)
    if V.device.type == "cpu":
        return panel_dots_plain(V, w, k)
    dev = _device(V)
    _check_kernel(V, w)
    m1, n = V.shape[0], w.numel()
    grid = _lib().its_panel_ortho_grid(n)
    partials = torch.empty(m1 * grid, dtype=torch.float32, device=dev)
    out = torch.empty(m1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().its_panel_dots(
            _DTYPE_CODE[V.dtype], V.data_ptr(), w.data_ptr(),
            partials.data_ptr(), out.data_ptr(), k.data_ptr(), n, m1, stream)
    if err != 0:
        raise RuntimeError(f"panel_dots kernel launch failed (error {err})")
    panel_dots.launches += 1
    return out


panel_dots.launches = 0


def panel_update(V, w, h, k):
    """``w`` less ``h[j] V[j]`` for the rows j = 0..k, and its sum of
    squares; see the module docstring."""
    _check(V, w, k, h)
    if V.device.type == "cpu":
        return panel_update_plain(V, w, h, k)
    dev = _device(V)
    _check_kernel(V, w)
    m1, n = V.shape[0], w.numel()
    grid = _lib().its_panel_ortho_grid(n)
    y = torch.empty_like(w)
    partials = torch.empty(grid, dtype=torch.float32, device=dev)
    ss = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().its_panel_update(
            _DTYPE_CODE[V.dtype], V.data_ptr(), w.data_ptr(), h.data_ptr(),
            y.data_ptr(), partials.data_ptr(), ss.data_ptr(), k.data_ptr(),
            n, m1, stream)
    if err != 0:
        raise RuntimeError(f"panel_update kernel launch failed (error {err})")
    panel_update.launches += 1
    return y, ss


panel_update.launches = 0
