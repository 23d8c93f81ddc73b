"""The host side of the stencil and DIA kernels, on the CPU: the
multiply-high constants that replace the stencil row's division and modulo
(``ops/cuda_stencil.fast_divisor``, carried in the cached plan), the runs of
rows a thread takes, the kernels' 32-bit limits, and the constants that
Python and ``csrc/`` share.

The kernels run only on a card (``tests/test_torch_gpu.py`` holds them
against their plain versions there).  Here their loops are replayed in
numpy from the plan the wrapper hands them: one thread's run of R rows,
its 16-byte windows or its clamped per-row loads, the select that drops an
invalid term, the tail past n.  Inputs are small integers, so every sum is
exact and the replay must give the plain product bit for bit.
"""

import re

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import (_build, _launch, cuda_spmv,
                                           cuda_stencil)
from iterativesolvers_tpu_torch.ops.cuda_stencil import (fast_divisor,
                                                         normal_terms,
                                                         stencil_sum, sum_plan)
from iterativesolvers_tpu_torch.utils import fixtures as pfix

N216 = 216**3


def _fast_div(i, mul, shr):
    """common.cuh's fast_div on uint64 numpy arrays (i < 2^31)."""
    i = np.asarray(i, dtype=np.uint64)
    if mul == 0:
        return i
    return (i * np.uint64(mul)) >> np.uint64(32 + shr)


def _check_divisor(d, i):
    mul, shr = fast_divisor(d)
    assert 0 <= mul < 2**32 and 0 <= shr <= 31
    got = _fast_div(i, mul, shr)
    np.testing.assert_array_equal(got, i // np.uint64(d))
    return mul, shr


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 17, 59, 216, 46_656, 216**3,
                               2**20, 2**31 - 1])
def test_fast_divisor_replays_floor_division_over_216_cubed(d):
    """floor(i / d) and i mod d for every i in [0, 216^3), in chunks."""
    for lo in range(0, N216, 1 << 22):
        i = np.arange(lo, min(lo + (1 << 22), N216), dtype=np.uint64)
        mul, shr = _check_divisor(d, i)
        q = _fast_div(i, mul, shr)
        np.testing.assert_array_equal(i - q * np.uint64(d), i % np.uint64(d))


@pytest.mark.parametrize("d", [1, 3, 5, 7, 216, 46_656, 1003, 65_537,
                               2**31 - 1])
def test_fast_divisor_at_the_largest_n(d):
    """Near the largest n that check_kernel admits: the last 2^20 rows,
    and the rows on either side of each multiple of d up there, where the
    multiply-high's error is largest."""
    top = _launch.max_rows(46_656)
    i = np.arange(top - (1 << 20), top + 1, dtype=np.uint64)
    k = np.arange(max(1, (top - (1 << 24)) // d), top // d + 1,
                  dtype=np.uint64)[-(1 << 16):]
    edges = np.concatenate([k * np.uint64(d) - np.uint64(1),
                            k * np.uint64(d)])
    _check_divisor(d, np.concatenate([i, edges[edges <= top]]))
    assert top < 2**31


def test_fast_divisor_past_31_bits():
    """A divisor of 2^31 or more gives the quotient 0 for every i < 2^31."""
    i = np.array([0, 1, 2**30, 2**31 - 1], dtype=np.uint64)
    for d in (2**31, 2**32 + 5):
        mul, shr = fast_divisor(d)
        assert not _fast_div(i, mul, shr).any()
    with pytest.raises(ValueError):
        fast_divisor(0)


def test_check_kernel_admits_up_to_max_rows():
    terms = ((46_656, 46_656, 216), (-46_656, 46_656, 216))
    top = _launch.max_rows(46_656)
    cuda_stencil.check_kernel(top, terms)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_stencil.check_kernel(top + 1, terms)
    cuda_spmv._check_kernel(top, (-46_656, 0, 46_656))
    with pytest.raises(ValueError, match="32-bit"):
        cuda_spmv._check_kernel(top + 1, (-46_656, 0, 46_656))
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_stencil.check_kernel(100, ((1, 2**31, 1),))


def _const(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None, name
    return int(m.group(1))


def test_constants_match_the_kernels():
    """The constants Python and csrc/ share: the kernels' term and
    diagonal limits and the stencil kernel's run (the vector width and the
    threads a block: tests/test_torch_launch.py)."""
    stencil = (_build.CSRC / "stencil.cuh").read_text()
    assert _const(stencil, "kMaxTerms") == cuda_stencil.MAX_TERMS
    assert _const(stencil, "kStencilRun") == cuda_stencil.STENCIL_RUN
    dia = (_build.CSRC / "dia_spmv.cu").read_text()
    assert _const(dia, "kMaxDiags") == cuda_spmv.MAX_DIAGS


# ---- numpy replays of the kernels' runs -------------------------------------


def _unpack(plan):
    k, off, step, stride, extent, magic, bit, nsum, cbit, sum_off, coeff = (
        plan.args)
    return dict(k=k, off=list(off)[:k], step=list(step)[:k],
                stride=list(stride)[:k], extent=list(extent)[:k],
                magic=list(magic)[:4 * k], bit=list(bit)[:k], nsum=nsum,
                cbit=cbit, sum_off=list(sum_off), coeff=list(coeff))


def _row_valid(p, i, n):
    """stencil.cuh's row_valid for row i."""
    valid, pos = 1 << p["cbit"], 0
    for t in range(p["k"]):
        reuse = t > 0 and (p["stride"][t], p["extent"][t]) == (
            p["stride"][t - 1], p["extent"][t - 1])
        if not reuse:
            sm, ss, em, es = p["magic"][4 * t:4 * t + 4]
            q = int(_fast_div(i, sm, ss))
            pos = q - int(_fast_div(q, em, es)) * p["extent"][t]
        j = i + p["off"][t]
        if 0 <= pos + p["step"][t] < p["extent"][t] and 0 <= j < n:
            valid |= 1 << p["bit"][t]
    return valid


def _run_valid(p, r0, R):
    """stencil.cuh's run_valid: the rows' slots from each group's grid
    position at r0, held (stride > 1) or stepped (stride 1) across the run;
    None where the run crosses a grid line."""
    same, steps = 1 << p["cbit"], [0] * R
    pos, unit, ok = 0, False, True
    for t in range(p["k"]):
        stride, extent = p["stride"][t], p["extent"][t]
        reuse = t > 0 and (stride, extent) == (p["stride"][t - 1],
                                               p["extent"][t - 1])
        if not reuse:
            sm, ss, em, es = p["magic"][4 * t:4 * t + 4]
            q = int(_fast_div(r0, sm, ss))
            pos = q - int(_fast_div(q, em, es)) * extent
            unit = stride == 1
            ok = ok and (pos + R <= extent if unit
                         else r0 - q * stride + R <= stride)
        q = pos + p["step"][t]
        if unit:
            for e in range(R):
                steps[e] |= int(0 <= q + e < extent) << p["bit"][t]
        else:
            same |= int(0 <= q < extent) << p["bit"][t]
    return [same | b for b in steps] if ok else None


def _window(x, j0, R, V, n):
    """common.cuh's load_window: the aligned vectors that cover the
    window where they lie inside x, else clamped per-row loads."""
    s = j0 & (V - 1)
    g0 = j0 - s
    if g0 >= 0 and g0 + R + (V if s else 0) <= n:
        buf = x[g0:g0 + R + (V if s else 0)]
        return buf[s:s + R], True
    return x[np.clip(j0 + np.arange(R), 0, n - 1)], False


def _fma(c, w, acc):
    # exact for the small integers (and halves) used here
    return (np.float64(c) * w.astype(np.float64) + acc).astype(np.float32)


def _replay_stencil(plan, x, n, vec, V, R):
    """stencil.cuh's stencil_kernel, run by run (runs of R rows: STENCIL_RUN,
    or with the dot one vector; 16-byte vectors of V elements of x): the vector path for a whole run of
    an aligned x, its valid terms found once for an interior run where
    run_valid can, row by row otherwise; the per-row path for the rest.
    Returns y and counts of the paths taken."""
    p = _unpack(plan)
    y = np.zeros(n, np.float32)
    seen = {"window inside": 0, "window clamped": 0, "run_valid": 0,
            "row_valid": 0}
    for r0 in range(0, n, R):
        if vec and r0 + R <= n:
            rows = [_row_valid(p, r0 + e, n) for e in range(R)]
            valid = None
            if (r0 + p["sum_off"][0] >= V
                    and r0 + R + V + p["sum_off"][-1] <= n):
                valid = _run_valid(p, r0, R)
            if valid is None:
                valid = rows
                seen["row_valid"] += 1
            else:
                assert valid == rows, r0
                seen["run_valid"] += 1
            acc = np.zeros(R, np.float32)
            for k in range(p["nsum"]):
                w, inside = _window(x, r0 + p["sum_off"][k], R, V, n)
                seen["window inside" if inside else "window clamped"] += 1
                on = np.array([(v >> k) & 1 for v in valid], bool)
                acc = np.where(on, _fma(p["coeff"][k], w, acc), acc)
            y[r0:r0 + R] = acc
        else:
            for i in range(r0, min(r0 + R, n)):
                valid = _row_valid(p, i, n)
                acc = np.float32(0)
                for k in range(p["nsum"]):
                    xv = x[min(max(i + p["sum_off"][k], 0), n - 1)]
                    if (valid >> k) & 1:
                        acc = _fma(p["coeff"][k], np.array([xv]), acc)[0]
                y[i] = acc
    return y, seen


STENCILS = {
    "laplacian 3-D 7^3": lambda: pits.laplacian(7, 3, device="cpu"),
    "laplacian 3-D 8^3": lambda: pits.laplacian(8, 3, device="cpu"),
    "laplacian 3-D 16^3": lambda: pits.laplacian(16, 3, device="cpu"),
    "laplacian 2-D 9^2": lambda: pits.laplacian(9, 2, device="cpu"),
    "laplacian 1-D 13": lambda: pits.laplacian(13, 1, device="cpu"),
    "advection-diffusion 6^3": lambda: pits.advection_diffusion_stencil(
        6, beta=0.5, device="cpu"),
    "general n=203": lambda: pits.StencilOperator(
        203, 4.5, ((3, 1, 17), (-5, 1, 17), (34, 17, 7), (-35, 17, 7),
                   (1, 1, 203), (-2, 1, 203), (118, 1, 203)),
        (-1.25, 0.5, -0.75, 2.0, -1.0, 0.25, 3.0), device="cpu"),
}


RUN_ALIGNED = ("laplacian 3-D 8^3", "laplacian 3-D 16^3")


@pytest.mark.parametrize("name", list(STENCILS))
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("vec, V, R", [(True, 4, 8), (True, 8, 8),
                                      (True, 4, 4), (False, 4, 8)])
def test_run_replay_gives_the_stencil_product(name, conj, vec, V, R):
    """The replay of every thread's run (8 rows, or with the dot one vector
    of 4 f32), on the vector path (an aligned f32 or bf16 x: 4 or 8
    elements a vector) and the per-row path (an x that is not aligned), gives stencil_sum's y bit for bit; where run_valid finds
    a run's valid terms it finds row_valid's; the vector path uses aligned
    windows and clamped ones, and both ways to the valid terms."""
    St = STENCILS[name]()
    terms, coeffs = normal_terms(St.terms, St.coeffs)
    plan = sum_plan(St.center, terms, coeffs, conj, torch.float32)
    rng = np.random.default_rng(len(name))
    x = rng.integers(-8, 9, St.n).astype(np.float32)
    y, seen = _replay_stencil(plan, x, St.n, vec, V, R)
    want = stencil_sum(St.n, plan.order, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, want)
    if vec and St.n >= 200:
        assert seen["window inside"] and seen["window clamped"], seen
        assert seen["row_valid"], seen
    if vec and name in RUN_ALIGNED:
        # grid sides a multiple of the run: every interior run
        assert seen["run_valid"], seen


@pytest.mark.parametrize("name", list(STENCILS))
def test_plan_carries_the_fast_div_constants(name):
    """The plan hands the kernel, for each term in its group order, the
    fast_div constants of its stride and extent, and the groups' shared
    positions (reuse) agree with recomputing every term's."""
    St = STENCILS[name]()
    terms, coeffs = normal_terms(St.terms, St.coeffs)
    p = _unpack(sum_plan(St.center, terms, coeffs, False, torch.float32))
    for t in range(p["k"]):
        assert tuple(p["magic"][4 * t:4 * t + 2]) == fast_divisor(
            p["stride"][t])
        assert tuple(p["magic"][4 * t + 2:4 * t + 4]) == fast_divisor(
            p["extent"][t])
    for i in range(St.n):
        pos = [(i // s) % e for s, e in zip(p["stride"], p["extent"])]
        q = [(i // s) % e + st for s, e, st in zip(p["stride"], p["extent"],
                                                  p["step"])]
        assert all(0 <= v for v in pos)
        valid = _row_valid(p, i, St.n)
        for t in range(p["k"]):
            ok = 0 <= q[t] < p["extent"][t] and 0 <= i + p["off"][t] < St.n
            assert bool((valid >> p["bit"][t]) & 1) == ok


def _replay_dia(vals, offsets, x, R, vec):
    """dia_spmv.cu's dia_kernel, run by run."""
    n = x.shape[0]
    y = np.zeros(n, np.float32)
    for r0 in range(0, n, R):
        if vec and r0 + R <= n:
            acc = np.zeros(R, np.float32)
            for d, off in zip(vals, offsets):
                w, inside = _window(x, r0 + off, R, 4, n)
                ok = (r0 + off + np.arange(R) >= 0) & (
                    r0 + off + np.arange(R) < n)
                assert inside <= ok.all()
                acc = np.where(ok, _fma_vec(d[r0:r0 + R], w, acc), acc)
            y[r0:r0 + R] = acc
        else:
            for i in range(r0, min(r0 + R, n)):
                acc = np.float32(0)
                for d, off in zip(vals, offsets):
                    j = i + off
                    xv = x[min(max(j, 0), n - 1)]
                    if 0 <= j < n:
                        acc = _fma_vec(d[i:i + 1], np.array([xv]), acc)[0]
                y[i] = acc
    return y


def _fma_vec(d, w, acc):
    return (d.astype(np.float64) * w.astype(np.float64) + acc).astype(
        np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n, offsets", [(343, None), (250, (-37, -7, -3, 0,
                                                             2, 5, 13, 64))])
def test_dia_run_replay_gives_the_plain_product(dtype, vec, n, offsets):
    """The DIA kernel's runs (R = 16 bytes of a diagonal) replayed on
    laplace_dia(7, 3) and on offsets that are not multiples of 4, n not a
    multiple of R: dia_spmv_plain's y bit for bit."""
    if offsets is None:
        A = pfix.laplace_dia(7, 3, dtype=np.float32, device="cpu")
        diags, offsets = pits.compress_values(A, dtype).diags, A.offsets
    else:
        rng = np.random.default_rng(n)
        diags = [torch.from_numpy(rng.integers(-9, 10, n).astype(np.float32))
                 .to(dtype) for _ in offsets]
    rng = np.random.default_rng(1)
    x = rng.integers(-8, 9, n).astype(np.float32)
    vals = [d.float().numpy() for d in diags]
    y = _replay_dia(vals, offsets, x, _launch.run_rows(dtype), vec)
    want = cuda_spmv.dia_spmv_plain(diags, offsets, torch.from_numpy(x))
    np.testing.assert_array_equal(y, want.numpy())


# ---- the in-launch dot (csrc/common.cuh finish_dot) -------------------------


def _shfl_tree(v):
    """block_sum's shuffle-down tree over the last axis (32 lanes): lane l
    adds lane l + o, or itself where l + o is past the warp."""
    for o in (16, 8, 4, 2, 1):
        partner = np.concatenate([v[..., o:], v[..., 32 - o:]], axis=-1)
        v = (v + partner).astype(np.float32)
    return v[..., 0]


def _block_sum(v):
    """block_sum over the last axis (256 threads): each warp's tree, then
    the tree over the 8 warp sums (lanes 8..31 hold 0)."""
    warps = _shfl_tree(v.reshape(v.shape[:-1] + (8, 32)))
    pad = np.zeros(warps.shape[:-1] + (24,), np.float32)
    return _shfl_tree(np.concatenate([warps, pad], axis=-1))


def _grid_dot(u, y, grid, R):
    """The kernels' dot on ``grid`` blocks of 256 threads, replayed: thread
    P takes runs P, P + T, ... (T = 256 grid) of R rows and adds their
    products by fmaf from 0 in that order; each block's block_sum is its
    partial; the last block's thread t adds partials t, t + 256, ... and
    block_sum gives the dot.  Returns the dot and how often each row was
    added."""
    n = u.shape[0]
    T = grid * 256
    runs = -(-n // R)
    local = np.zeros(T, np.float32)
    seen = np.zeros(n, np.int64)
    for first in range(0, runs, T):
        P = np.arange(min(T, runs - first))
        for e in range(R):
            rows = (first + P) * R + e
            ok = rows < n
            p, r = P[ok], rows[ok]
            # fmaf: the f32 product is exact in f64, one rounding after
            local[p] = (u[r].astype(np.float64) * y[r] + local[p]).astype(
                np.float32)
            seen[r] += 1
    partials = _block_sum(local.reshape(grid, 256))
    t = np.zeros(256, np.float32)
    for i in range(0, grid, 256):
        m = min(256, grid - i)
        t[:m] = (t[:m] + partials[i:i + m]).astype(np.float32)
    return _block_sum(t), seen


def _dot_bound(n, grid, R, u, y):
    """A bound on the rounding of any summation order with the kernels'
    depth: a thread's chain of L products, the two 5-level trees of each
    block_sum, the last block's chain over the partials: m additions in
    all, |error| <= 1.01 m 2^-24 sum |u_i y_i| (Higham, recursive
    summation)."""
    L = -(-(-(-n // R)) // (grid * 256)) * R
    m = L + 10 + -(-grid // 256) + 10
    return 1.01 * m * 2.0**-24 * float(np.abs(u.astype(np.float64) * y).sum())


@pytest.mark.parametrize("R", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 37, 1000, 70_001, 600_000])
def test_grid_dot_covers_every_row_once_within_its_bound(R, n):
    """The kernels' dot on a free grid (runs of R rows: f32 DIA 4, stencil
    and bf16 DIA 8, int8 DIA 16), replayed on one block, on the H100's 132
    SMs with one and three blocks each, and on more blocks than runs: every
    row is added once, and the dot, like the plain version's (torch.sum),
    lies within the rounding bound of its depth of the f64 dot."""
    rng = np.random.default_rng(n + R)
    u = rng.standard_normal(n).astype(np.float32)
    y = (rng.standard_normal(n) * 1e3).astype(np.float32)
    exact = float(np.dot(u.astype(np.float64), y))
    for grid in (1, 132, 396, -(-n // R) + 3):
        got, seen = _grid_dot(u, y, grid, R)
        assert (seen == 1).all(), grid
        assert abs(float(got) - exact) <= _dot_bound(n, grid, R, u, y), grid
    plain = float(torch.sum(torch.from_numpy(u) * torch.from_numpy(y)))
    assert abs(plain - exact) <= _dot_bound(n, 1, R, u, y)
