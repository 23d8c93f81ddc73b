"""The set-up of the panel sweep kernels, on the CPU: the residency plan
(``ops/cuda_mgs.plan_residency``), where each block of the panel MGS and
fused Arnoldi kernels keeps its chunk of the working vector (registers,
shared memory, device memory) beside the ring of row tiles it streams; the
fused kernel's row masks; the build's ``ptxas`` report.

The kernels themselves are held against their plain versions on a card by
``tests/test_torch_gpu.py``; here the plan is checked against the limits of
an H100 and the loops of ``csrc/panel_mgs.cuh`` replayed in Python.
"""

import re

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import _build, cuda_arnoldi, cuda_mgs
from iterativesolvers_tpu_torch.ops.cuda_stencil import (_THREADS, _normal,
                                                         _plan, stencil_sum)

NS = [1, 125, 300_763, 216**3, 240**3]
GRIDS = [1, 66, 132, 264]
# an H100's shared memory a block (227 KB, static included), and the sweep
# kernels' static shared memory (``ptxas -v``: the block sums' 144 bytes);
# on a card the wrappers ask the device and the kernel for both
H100_SMEM_BLOCK = 232_448
SWEEP_SMEM_STATIC = 144
H100_SMEM = H100_SMEM_BLOCK - SWEEP_SMEM_STATIC


def _tiers(plan, n, block, threads):
    """The entries block `block` visits in each tier, as the kernel's loops
    visit them: registers e = r * threads + t (r < ROW_REGS, e < len),
    shared memory e in [ROW_REGS * threads, + smem), device memory the
    rest."""
    c = plan.chunk
    lo = min(block * c, n)
    length = min(c, n - lo)
    rt = cuda_mgs.ROW_REGS * threads
    regs = [r * threads + t for r in range(cuda_mgs.ROW_REGS)
            for t in range(threads) if r * threads + t < length]
    send = min(length, rt + plan.smem)
    smem = [e for t in range(threads) for e in range(rt + t, send, threads)]
    spill = [e for t in range(threads)
             for e in range(rt + plan.smem + t, length, threads)]
    return lo, length, regs, smem, spill


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("n", NS)
def test_plan_covers_chunks_within_limits(n, grid, itemsize):
    """The chunks cover 0..n; the tiers of a full chunk add up to it; shared
    memory stays within an H100 block's."""
    plan = cuda_mgs.plan_residency(n, grid, itemsize, H100_SMEM)
    assert plan.grid == grid and plan.chunk == -(-n // grid)
    lens = [max(0, min(plan.chunk, n - b * plan.chunk)) for b in range(grid)]
    assert sum(lens) == n and lens[0] == min(n, plan.chunk)
    rt = cuda_mgs.ROW_REGS * _THREADS
    rest = max(0, plan.chunk - rt)
    assert min(plan.chunk, rt) + min(rest, plan.smem) + plan.spill == plan.chunk
    assert plan.smem >= 0 and plan.spill >= 0
    # shared memory takes entries only past the register tier, in whole
    # tiles, and the spill tier only what shared memory cannot
    tile = cuda_mgs.tile_size(itemsize)
    assert plan.smem % tile == 0 and plan.smem - rest < tile
    ring = cuda_mgs.ring_bytes(itemsize)
    assert plan.spill == 0 or ring + 4 * (plan.smem + tile) > H100_SMEM
    assert plan.smem_bytes == ring + 4 * plan.smem
    assert plan.smem_bytes + SWEEP_SMEM_STATIC <= H100_SMEM_BLOCK
    assert 0.0 < plan.onchip_share <= 1.0


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n, grid", [(1, 1), (125, 1), (700, 3), (3000, 2),
                                     (9000, 4), (17_000, 2)])
def test_kernel_loops_visit_each_entry_once(n, grid, itemsize, monkeypatch):
    """The kernel's three loops, replayed over every block with few threads
    and a small shared memory, visit each row 0..n exactly once; every tier
    is used by some case."""
    threads = 4
    plan = cuda_mgs.plan_residency(n, grid, itemsize, 6144, threads)
    seen = []
    for b in range(grid):
        lo, length, regs, smem, spill = _tiers(plan, n, b, threads)
        entries = regs + smem + spill
        assert sorted(entries) == list(range(length))
        seen += [lo + e for e in entries]
    assert sorted(seen) == list(range(n))
    tiers = (plan.smem > 0, plan.spill > 0)
    assert tiers == {1: (False, False), 125: (False, False),
                     700: (False, False), 3000: (True, False),
                     9000: (True, True), 17_000: (True, True)}[n]


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_at_216_cubed(itemsize):
    """At 216^3 on the H100's 132 SMs the working vector lives on chip
    (registers 144 entries a thread, the rest of the chunk in shared
    memory); on half the grid the spill tier is used."""
    n = 216**3
    full = cuda_mgs.plan_residency(n, 132, itemsize, H100_SMEM)
    assert full.spill == 0 and full.onchip_share == 1.0
    assert full.smem >= full.chunk - cuda_mgs.ROW_REGS * _THREADS
    half = cuda_mgs.plan_residency(n, 66, itemsize, H100_SMEM)
    assert half.spill > 0 and half.onchip_share < 1.0


def test_plan_constants_match_the_kernels():
    """ROW_REGS names the register tier of csrc/panel_mgs.cuh, and
    TILE_BYTES and STAGES its ring of row tiles."""
    src = (_build.CSRC / "panel_mgs.cuh").read_text()
    for name, value in (("kRowRegs", cuda_mgs.ROW_REGS),
                        ("kTileBytes", cuda_mgs.TILE_BYTES),
                        ("kStages", cuda_mgs.STAGES)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name


def test_plan_rejects_empty_input():
    with pytest.raises(ValueError):
        cuda_mgs.plan_residency(0, 132, 4, H100_SMEM)
    with pytest.raises(ValueError):
        cuda_mgs.plan_residency(10, 0, 4, H100_SMEM)


def test_kernel_resources_reads_the_ptxas_report(tmp_path, monkeypatch):
    """kernel_resources reads registers, stack frame and spills by kernel
    from the log ``ptxas -v`` leaves beside a library."""
    lib = tmp_path / "libpanel_mgs.so"
    name = "_ZN3its16panel_mgs_kernelIfEEvPT_PKfPfS4_S4_S4_PKiS6_iiii"
    lib.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 132 bytes smem,"
        " 440 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "build_all", lambda: {"panel_mgs": lib})
    assert _build.kernel_resources("panel_mgs") == {
        name: {"registers": 255, "stack": 0, "spill_stores": 8,
               "spill_loads": 4}}


@pytest.mark.parametrize("make", [
    lambda: pits.laplacian(7, 3, device="cpu"),
    lambda: pits.laplacian(9, 2, device="cpu"),
    lambda: pits.laplacian(11, 1, device="cpu"),
    lambda: pits.advection_diffusion_stencil(6, device="cpu"),
])
def test_row_masks_give_the_stencil_product(make):
    """The fused kernel's row masks (ops/cuda_arnoldi._row_masks): the sum
    over the slots a row's mask sets, each reading row i + off, in the
    plan's order, is the plain stencil product exactly; an unset slot reads
    row i with a coefficient of 0, as the kernel does."""
    St = make()
    terms, coeffs = _normal(St.terms, St.coeffs)
    masks = cuda_arnoldi._row_masks(St.n, St.center, terms, coeffs,
                                    torch.device("cpu"))
    assert masks.dtype == torch.int16 and masks.shape == (St.n,)
    masks = masks.int()
    order = _plan(St.center, terms, coeffs, False, torch.float32).order
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(St.n)
                         .astype(np.float32))
    i = torch.arange(St.n)
    y = torch.zeros(St.n)
    for b, (off, c, _) in enumerate(order):
        on = ((masks >> b) & 1).bool()
        y = y + torch.where(on, c, 0.0) * x[torch.where(on, i + off, i)]
    assert torch.equal(y, stencil_sum(St.n, order, x))
