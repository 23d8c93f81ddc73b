"""The GMRES step on a stencil operator straight from the Krylov panel: the
CUDA kernels' wrappers and their plain PyTorch versions.

Ports of the Pallas kernels of ``iterativesolvers_tpu/ops/pallas_arnoldi.py``;
the kernels are in ``csrc/arnoldi.cu``.

* :func:`stencil_panel_mv` (``stencil_panel_mv``, ``:560``): ``w = A V[k]``
  in f32 from panel row k, stored as f32 or bf16.
* :func:`fused_arnoldi` (``fused_arnoldi``, ``:385``): in one launch,
  ``w = A V[k]``, MGS of w against rows 0..k, the norm, and the write of
  ``w / nrm * do`` as panel row ``k + 1`` in V's dtype, in place (``do = 0``,
  a masked step, writes zeros); returns ``(h, nrm)``.  Rows 0..k are only
  read.

The stencil ``(n, center, terms, coeffs)`` is a ``StencilOperator``'s; its
products are summed in the order of ``ops/cuda_stencil.py`` (ascending
offsets), with the coefficients in f32 as the TPU kernels take them.  The
panel is flat ``(m1, n)``; ``k`` and ``do`` are 0-d int32 tensors on its
device.  A CUDA tensor launches the kernel or raises (also past the stencil
kernel's limits); a CPU tensor takes the plain version, and the plain fused
step is the plain ``stencil_panel_mv`` followed by the plain
``panel_mgs``, bit for bit.  The fused kernel keeps w on chip as the panel
MGS kernel does, on the same residency plan (``cuda_mgs.plan_residency``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._launch import aligned, launch, library, query, raw_stream
from .cuda_mgs import DTYPE_CODE, check_panel, panel_mgs_plain, plan_residency
from .cuda_stencil import (check_kernel, launch_plan, normal_terms,
                           packed_terms, stencil_sum, sum_plan)

__all__ = ["stencil_panel_mv", "stencil_panel_mv_plain", "fused_arnoldi",
           "fused_arnoldi_plain"]


def _row(V, k):
    """Panel row k (a 0-d tensor) in f32, with no host read."""
    return V.index_select(0, k.reshape(1).long())[0].float()


def stencil_panel_mv_plain(n, center, terms, coeffs, V, k):
    """``A V[k]`` in plain PyTorch: f32 arithmetic, the kernel's sum order."""
    terms, coeffs = normal_terms(terms, coeffs)
    plan = sum_plan(center, terms, coeffs, False, torch.float32)
    return stencil_sum(int(n), plan.order, _row(V, k))


def fused_arnoldi_plain(n, center, terms, coeffs, V, k, do):
    """The fused step in plain PyTorch: :func:`stencil_panel_mv_plain`, then
    ``ops/cuda_mgs.py``'s plain version (MGS and the row write)."""
    w = stencil_panel_mv_plain(n, center, terms, coeffs, V, k)
    return panel_mgs_plain(V, w, k, do)


def _check(n, terms, V, k, do=None):
    """The functions' contract, on every device."""
    check_panel(V, k, do)
    if V.shape[1] != n:
        raise ValueError(f"V must be an (m1, {n}) panel, got {tuple(V.shape)}")
    if any(s <= 0 or e <= 0 for (_, s, e) in terms):
        raise ValueError("stencil strides and extents must be positive")


@functools.lru_cache(maxsize=8)
def _fused_smem(dtype_code, device_index):
    """The dynamic shared memory a block of the fused kernel may take."""
    return query(library("arnoldi").its_fused_arnoldi_smem, dtype_code,
                 device=torch.device("cuda", device_index))


@functools.lru_cache(maxsize=64)
def _fused_grid(dtype_code, n, device_index):
    """The cooperative grid of the fused kernel on this device: one block
    on each SM, as ``cuda_mgs._grid``."""
    return query(library("arnoldi").its_fused_arnoldi_grid, dtype_code, n,
                 _fused_smem(dtype_code, device_index),
                 device=torch.device("cuda", device_index))


@functools.lru_cache(maxsize=8)
def _row_masks(n, center, terms, coeffs, device):
    """Each row's valid terms as the stencil kernels find them (a column in
    [0, n), and the term's grid axis on the grid), as int16 bits in the sum
    order of ``sum_plan``: the fused kernel reads them instead of computing
    them.  Built once per operator on its device (2 bytes a row)."""
    order = sum_plan(center, terms, coeffs, False, torch.float32).order
    i = torch.arange(n, device=device)
    masks = torch.zeros(n, dtype=torch.int32, device=device)
    for b, (off, _, term) in enumerate(order):
        ok = (i + off >= 0) & (i + off < n)
        if term is not None:
            stride, extent = term
            p = (i // stride) % extent + off // stride
            ok &= (p >= 0) & (p < extent)
        masks |= ok.int() << b
    return masks.to(torch.int16)


@functools.lru_cache(maxsize=64)
def _fused_terms(center, terms, coeffs):
    """The terms packed for the fused kernel (``cuda_stencil.packed_terms``)."""
    return packed_terms(sum_plan(center, terms, coeffs, False, torch.float32))


@functools.lru_cache(maxsize=64)
def _panel_mv_launch(n, center, terms, coeffs, dtype, device):
    """The panel SpMV's launch plan: the stencil kernel's
    (``cuda_stencil.launch_plan``) with an f32 output."""
    check_kernel(n, terms)
    return launch_plan(sum_plan(center, terms, coeffs, False, torch.float32),
                       n, False, device, 0,
                       library("arnoldi").its_stencil_panel_mv_blocks_per_sm,
                       DTYPE_CODE[dtype])


def _cuda(V, n, terms, name):
    if V.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got {V.device}")
    check_kernel(n, terms)


def stencil_panel_mv(n, center, terms, coeffs, V, k):
    """``w = A V[k]``, f32 (n,); see the module docstring."""
    n = int(n)
    terms, coeffs = normal_terms(terms, coeffs)
    _check(n, terms, V, k)
    if V.device.type == "cpu":
        return stencil_panel_mv_plain(n, center, terms, coeffs, V, k)
    if V.device.type != "cuda":
        raise ValueError(f"stencil_panel_mv kernel runs on CUDA tensors, got "
                         f"{V.device}")
    dev = V.device
    lp = _panel_mv_launch(n, center, terms, coeffs, V.dtype, dev)
    w = torch.empty(n, dtype=torch.float32, device=dev)
    launch(library("arnoldi").its_stencil_panel_mv, DTYPE_CODE[V.dtype],
           V.data_ptr(), k.data_ptr(), w.data_ptr(), n, V.shape[0], lp.grid,
           aligned(V, w), lp.terms, raw_stream(dev), device=dev,
           what="stencil_panel_mv")
    stencil_panel_mv.launches += 1
    return w


def fused_arnoldi(n, center, terms, coeffs, V, k, do):
    """One Arnoldi step in one launch: writes panel row ``k + 1`` in place
    and returns ``(h, nrm)``; see the module docstring."""
    n = int(n)
    terms, coeffs = normal_terms(terms, coeffs)
    _check(n, terms, V, k, do)
    if V.device.type == "cpu":
        return fused_arnoldi_plain(n, center, terms, coeffs, V, k, do)
    _cuda(V, n, terms, "fused_arnoldi")
    m1 = V.shape[0]
    dev = V.device
    code = DTYPE_CODE[V.dtype]
    grid = _fused_grid(code, n, dev.index)
    plan = plan_residency(n, grid, V.element_size(),
                          _fused_smem(code, dev.index))
    masks = _row_masks(n, center, terms, coeffs, dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    partials = torch.empty((m1 + 1) * grid, dtype=torch.float32, device=dev)
    h = torch.empty(m1, dtype=torch.float32, device=dev)
    nrm = torch.empty((), dtype=torch.float32, device=dev)
    launch(library("arnoldi").its_fused_arnoldi, code, V.data_ptr(),
           y.data_ptr(), partials.data_ptr(), h.data_ptr(), nrm.data_ptr(),
           k.data_ptr(), do.data_ptr(), masks.data_ptr(), n, m1, grid,
           *plan.args, ctypes.addressof(_fused_terms(center, terms, coeffs)),
           raw_stream(dev), device=dev, what="fused_arnoldi")
    fused_arnoldi.launches += 1
    return h, nrm


stencil_panel_mv.launches = 0
fused_arnoldi.launches = 0
