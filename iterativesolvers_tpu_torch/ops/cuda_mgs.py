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

The kernel runs one block on each SM, and each block keeps its chunk of the
working vector on chip for the whole sweep: :func:`plan_residency` splits
the chunk between registers, shared memory and device memory (the fused
Arnoldi kernel of ``ops/cuda_arnoldi.py`` takes the same plan).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ._launch import THREADS, launch, library, query, raw_stream
from .orthogonalize import mgs_rows

__all__ = ["panel_mgs", "panel_mgs_plain", "check_panel", "plan_residency",
           "Residency", "PANEL_DTYPES", "DTYPE_CODE", "ROW_REGS"]

# the panel dtypes' codes in the sweep kernels' C calls
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PANEL_DTYPES = tuple(DTYPE_CODE)

# The register tier (entries a thread; kRowRegs in csrc/panel_mgs.cuh).
ROW_REGS = 144
# The row tiles a pass streams through shared memory (panel_mgs.cuh): 32
# bytes of a row a thread, in a ring of STAGES tiles of two rows, each slot
# a tile and one 16-byte piece.
TILE_BYTES = 32
STAGES = 4


def tile_size(itemsize: int, threads: int = THREADS) -> int:
    """Entries of a row tile, for a panel of ``itemsize``-byte entries."""
    return TILE_BYTES // itemsize * threads


def ring_bytes(itemsize: int, threads: int = THREADS) -> int:
    """Shared memory of the ring of row tiles."""
    return STAGES * 2 * (TILE_BYTES * threads + 16)


class Residency(NamedTuple):
    """Where a block of the sweep keeps its chunk of the working vector:
    the first ``ROW_REGS * threads`` entries in registers, up to ``smem``
    more in shared memory (a whole number of tiles) and the ``spill`` left
    in device memory.  ``smem_bytes`` is the dynamic shared memory of a
    block: the ring of row tiles and the shared tier."""
    grid: int
    chunk: int
    smem: int
    spill: int
    smem_bytes: int

    @property
    def onchip_share(self) -> float:
        """The share of a full block's chunk held on chip."""
        return (self.chunk - self.spill) / self.chunk

    @property
    def args(self):
        """The plan as the kernels take it: (chunk, smem)."""
        return self.chunk, self.smem


@functools.lru_cache(maxsize=256)
def plan_residency(n: int, grid: int, itemsize: int, smem_limit: int,
                   threads: int = THREADS) -> Residency:
    """The residency of the sweep over ``n`` entries on ``grid`` blocks of
    ``threads``, for a panel of ``itemsize``-byte entries, where a block
    may take ``smem_limit`` bytes of dynamic shared memory: chunk
    c = ceil(n / grid); ROW_REGS entries a thread in registers; then shared
    memory, in whole tiles, up to what the limit leaves beside the ring;
    the rest spills."""
    if n < 1 or grid < 1:
        raise ValueError(f"plan_residency needs n >= 1 and grid >= 1, got "
                         f"{n}, {grid}")
    c = -(-n // grid)
    tile = tile_size(itemsize, threads)
    rest = max(0, c - ROW_REGS * threads)
    ring = ring_bytes(itemsize, threads)
    most = max(0, (smem_limit - ring) // 4 // tile * tile)
    smem = min(-(-rest // tile) * tile, most)
    return Residency(grid, c, smem, max(0, rest - smem), ring + 4 * smem)


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
    if V.ndim != 2 or V.dtype not in DTYPE_CODE or not V.is_contiguous():
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
    none): 32-bit row indices; a block indexes its chunk up to one tile
    past its end."""
    if n + tile_size(2) >= 2**31:
        raise ValueError(f"n = {n} is too large for 32-bit row indices")


@functools.lru_cache(maxsize=8)
def _smem(dtype_code, device_index):
    """The dynamic shared memory a block of the kernel may take on the
    device: its limit a block less the kernel's static shared memory."""
    return query(library("panel_mgs").its_panel_mgs_smem, dtype_code,
                 device=torch.device("cuda", device_index))


@functools.lru_cache(maxsize=64)
def _grid(dtype_code, n, device_index):
    """The cooperative grid the kernel takes on this device: one block on
    each SM, with the most dynamic shared memory a plan gives it, and no
    more blocks than n needs."""
    return query(library("panel_mgs").its_panel_mgs_grid, dtype_code, n,
                 _smem(dtype_code, device_index),
                 device=torch.device("cuda", device_index))


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
    code = DTYPE_CODE[V.dtype]
    grid = _grid(code, n, V.device.index)
    plan = plan_residency(n, grid, V.element_size(),
                          _smem(code, V.device.index))
    dev = V.device
    y = torch.empty(n, dtype=torch.float32, device=dev)
    partials = torch.empty((m1 + 1) * grid, dtype=torch.float32, device=dev)
    h = torch.empty(m1, dtype=torch.float32, device=dev)
    nrm = torch.empty((), dtype=torch.float32, device=dev)
    launch(library("panel_mgs").its_panel_mgs, code, V.data_ptr(),
           w.data_ptr(), y.data_ptr(), partials.data_ptr(), h.data_ptr(),
           nrm.data_ptr(), k.data_ptr(), do.data_ptr(), n, m1, grid,
           *plan.args, raw_stream(dev), device=dev, what="panel_mgs")
    panel_mgs.launches += 1
    return h, nrm


panel_mgs.launches = 0
