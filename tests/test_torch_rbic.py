"""The red-black IC(0) kernel's host side on the CPU (``ops/cuda_rbic.py``,
``csrc/rbic.cu``): the table of black scales by validity bits, the route
that ``RedBlackICPreconditioner.ldiv`` takes, the plain version, and a numpy
replay of the kernel's two passes from the arguments the wrapper packs.

The kernel runs only on a card (``tests/test_torch_gpu.py`` holds it against
the eager apply there).  Here the replay follows one thread's run of rows:
run_valid's bits where the run stays on one line, row_valid's row by row
where it does not, the colour stepped across the run or found row by row,
the clamped windows, the select that drops an invalid term, a term's
multiply-add rounded once (fmaf, replayed in f64: the f32 product is exact
there) and every other product and difference rounded on its own
(__fmul_rn, __fsub_rn).  The table, the plain version and the replay give
the eager apply's bits: torch's addcmul fuses its multiply-add on the CPU
as on a card.
"""

import ctypes

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import cuda_rbic
from iterativesolvers_tpu_torch.ops.cuda_stencil import STENCIL_RUN
from iterativesolvers_tpu_torch.utils import fixtures as pfix

torch.set_num_threads(1)

CPU = torch.device("cpu")
F32 = np.float32


def grid_stencil(extents, coeffs, center, dtype=torch.float32, device=CPU):
    """A symmetric unit-step stencil on a grid of ``extents`` (stride 1
    first), coefficient ``coeffs[k]`` on both terms of axis k."""
    terms, cs, stride = [], [], 1
    for e, c in zip(extents, coeffs):
        terms += [(stride, stride, e), (-stride, stride, e)]
        cs += [c, c]
        stride *= e
    return pits.StencilOperator(stride, center, tuple(terms), cs,
                                dtype=dtype, device=device)


GRIDS = {
    "laplacian 12^3": lambda: pits.laplacian(12, 3, device=CPU),
    "17x9x5, a coefficient an axis": lambda: grid_stencil(
        (17, 9, 5), (-1.0, -0.7, -1.3), 6.0),
    "2-D 11x7": lambda: grid_stencil((11, 7), (-1.0, -0.5), 4.0),
    "1-D 13": lambda: grid_stencil((13,), (-1.0,), 2.0),
    "n < 32: laplacian 3^3": lambda: pits.laplacian(3, 3, device=CPU),
    "n < 32: 1-D 5": lambda: grid_stencil((5,), (-0.9,), 2.0),
    "4-D 3x4x2x3": lambda: grid_stencil((3, 4, 2, 3), (-1.0, -0.6, -0.8, -1.1),
                                        9.0),
}
SHIFTS = [0.0, 0.37]


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_scale_table_reproduces_s_inv_bit_for_bit(grid, shift):
    """Each row's s_inv is the table's entry at its validity bits (black
    rows) or the table's last entry (red rows), bit for bit."""
    st = GRIDS[grid]()
    P = pits.RedBlackICPreconditioner.from_stencil(st, shift=shift)
    form = P.form
    assert form is not None
    T = len(st.terms)
    assert form.scales.shape == (2**T + 1,)
    assert form.scales.dtype == torch.float32
    valid = cuda_rbic.validity(st.n, st.terms, CPU)
    code = sum(valid[t].to(torch.int64) << t for t in range(T))
    want = torch.where(P.red, form.scales[2**T], form.scales[code])
    np.testing.assert_array_equal(_bits(want), _bits(P.s_inv))
    assert set(np.unique(_bits(P.s_inv[P.red]))) == {
        _bits(form.scales[2**T:])[0]}


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_cpu_tensor_takes_the_plain_path(grid, shift):
    """On a CPU tensor ``ldiv`` takes the plain version, launches nothing,
    and gives the eager apply's bits."""
    P = pits.RedBlackICPreconditioner.from_stencil(GRIDS[grid](), shift=shift)
    x = torch.randn(P.s_inv.shape[0], generator=torch.Generator().manual_seed(3))
    before = cuda_rbic.rbic_apply.launches
    z = P.ldiv(x)
    assert cuda_rbic.rbic_apply.launches == before
    assert z.dtype == x.dtype and z.shape == x.shape
    np.testing.assert_array_equal(_bits(z), _bits(P._apply(x, 0)))
    np.testing.assert_array_equal(_bits(z), _bits(cuda_rbic.rbic_apply_plain(
        [o for (o, _, _) in P.terms], P.mcs, P.s_inv, P.red, x)))


def test_plain_path_is_the_route_and_the_eager_apply_the_others(monkeypatch):
    """On the CPU no x goes to the kernel's wrapper: the form's 1-D f32 x,
    ldiv_rows, an (n, k) x and an f64 x all take the plain version, the
    one eager apply."""
    P = pits.RedBlackICPreconditioner.from_stencil(GRIDS["2-D 11x7"]())
    kernel, plain = [], []
    real = cuda_rbic.rbic_apply_plain
    monkeypatch.setattr(cuda_rbic, "rbic_apply",
                        lambda form, x: kernel.append(x.shape))
    monkeypatch.setattr(cuda_rbic, "rbic_apply_plain",
                        lambda *a, **k: plain.append(a[4].shape)
                        or real(*a, **k))
    x = torch.randn(77, generator=torch.Generator().manual_seed(1))
    P.ldiv(x)
    P.ldiv_rows(torch.stack([x, -x]))
    P.ldiv(torch.stack([x, -x], 1))
    P.ldiv(x.double())
    assert kernel == []
    assert plain == [(77,), (2, 77), (77, 2), (77,)]


def test_forms_only_where_the_kernel_takes_them():
    """A form for f32 stencils on nested grids with 2 to 8 terms; none for
    f64 or bf16, a grid whose strides do not nest, a 5-D grid (10 terms), or
    ``from_dia``; a CPU-side copy through its arrays keeps the eager apply."""
    RB = pits.RedBlackICPreconditioner
    assert RB.from_stencil(pits.laplacian(6, 3, device=CPU)).form is not None
    for dt in (torch.float64, torch.bfloat16):
        assert RB.from_stencil(pits.laplacian(6, 3, dtype=dt,
                                              device=CPU)).form is None
    loose = pits.StencilOperator(
        35, 4.0, ((1, 1, 5), (-1, 1, 5), (7, 7, 3), (-7, 7, 3)),
        [-1.0] * 4, device=CPU)
    assert cuda_rbic.grid_axes(35, loose.terms) is None
    assert RB.from_stencil(loose).form is None
    assert RB.from_stencil(pits.laplacian(3, 5, device=CPU)).form is None
    A = pfix.variable_diffusion(6, 3, contrast=10.0, seed=1, dtype=np.float32,
                                device=CPU)
    assert RB.from_dia(A, 6, 3).form is None
    P = RB.from_stencil(pits.laplacian(6, 3, device=CPU))
    copy = RB(P.terms, P.mcs, P.center, P.s_inv, P.red)
    x = torch.randn(216, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(_bits(copy.ldiv(x)), _bits(P.ldiv(x)))


@pytest.mark.parametrize("n,terms,want", [
    (1000, pits.laplacian(10, 3, device=CPU).terms,
     [(1, 10), (10, 10), (100, 10)]),
    (765, grid_stencil((17, 9, 5), (-1.0,) * 3, 7.0).terms,
     [(1, 17), (17, 9), (153, 5)]),
    (764, grid_stencil((17, 9, 5), (-1.0,) * 3, 7.0).terms, None),
    (35, ((7, 7, 5), (-7, 7, 5), (1, 1, 7), (-1, 1, 7)), [(1, 7), (7, 5)]),
    (10, ((2, 2, 5), (-2, 2, 5)), None),
])
def test_grid_axes(n, terms, want):
    assert cuda_rbic.grid_axes(n, terms) == want


def test_rbic_apply_checks_its_arguments():
    """The wrapper takes a contiguous (n,) f32 CUDA x and raises on any
    other, a CPU tensor among them; it makes its plan at the first launch."""
    P = pits.RedBlackICPreconditioner.from_stencil(GRIDS["1-D 13"]())
    with pytest.raises(ValueError):
        cuda_rbic.rbic_apply(P.form, torch.zeros(12))
    with pytest.raises(TypeError):
        cuda_rbic.rbic_apply(P.form, torch.zeros(13, dtype=torch.float64))
    with pytest.raises(ValueError):
        cuda_rbic.rbic_apply(P.form, torch.zeros(13, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rbic.rbic_apply(P.form, torch.zeros(13))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rbic.rbic_apply(P.form, torch.zeros(26)[::2])
    assert P.form.plan is None


# ---- the kernel's two passes replayed in numpy -----------------------------

def _fast_div(i, mul, shr):
    return i if mul == 0 else (i * mul) >> (32 + shr)


class _Packed:
    """What its_rbic_pack_terms (through stencil.cuh's pack_terms) makes of
    the wrapper's arguments."""

    def __init__(self, form):
        (T, goff, step, stride, extent, magic, bit, nsum, center, sum_off, _,
         off, coeff) = (a if isinstance(a, int) else list(a)
                        for a in cuda_rbic.pack_args(form))
        assert sorted(bit) == list(range(T))
        assert (nsum, center) == (T + 1, T)
        assert sum_off == sorted(sum_off) and len(sum_off) == nsum
        self.T, self.off, self.coeff = T, off, [F32(c) for c in coeff]
        assert goff == [off[j] for j in bit]
        self.goff = goff
        self.bit, self.step, self.stride, self.extent = bit, step, stride, extent
        self.magic = [magic[4 * k:4 * k + 4] for k in range(T)]
        self.reuse = [k > 0 and (stride[k], extent[k]) ==
                      (stride[k - 1], extent[k - 1]) for k in range(T)]
        self.min_off, self.max_off = sum_off[0], sum_off[-1]

    def pos(self, k, i):
        smul, sshr, emul, eshr = self.magic[k]
        q = _fast_div(i, smul, sshr)
        return q - _fast_div(q, emul, eshr) * self.extent[k]

    def row_valid(self, i, n):
        valid, pos = 1 << self.T, 0
        for k in range(self.T):
            if not self.reuse[k]:
                pos = self.pos(k, i)
            p, j = pos + self.step[k], i + self.goff[k]
            valid |= int(0 <= p < self.extent[k] and 0 <= j < n) << self.bit[k]
        return valid

    def run_valid(self, r0, R):
        same, step_bits, pos, unit, ok = 1 << self.T, [0] * R, 0, False, True
        for k in range(self.T):
            if not self.reuse[k]:
                q = _fast_div(r0, *self.magic[k][:2])
                pos = self.pos(k, r0)
                unit = self.stride[k] == 1
                ok = ok and (pos + R <= self.extent[k] if unit
                             else r0 - q * self.stride[k] + R <= self.stride[k])
            p = pos + self.step[k]
            if unit:
                for e in range(R):
                    step_bits[e] |= int(0 <= p + e < self.extent[k]) << self.bit[k]
            else:
                same |= int(0 <= p < self.extent[k]) << self.bit[k]
        return ok, [same | b for b in step_bits]

    def black_of(self, i):
        return sum(self.pos(k, i) for k in range(self.T)
                   if not self.reuse[k]) & 1


def _replay_pass(pk, scales, src, kpass, vec=True):
    """One launch of rbic_apply_kernel<kpass> over every run, in numpy f32."""
    n, R, V = src.shape[0], STENCIL_RUN, 4
    sr = scales[-1]
    code_mask = (1 << pk.T) - 1
    out = np.full(n, np.nan, F32)

    def at(j):
        return src[min(max(j, 0), n - 1)]

    def operand(v):
        return F32(F32(v * sr) * sr) if kpass == 0 else v

    def finish(c, acc, black, valid):
        if kpass == 0:
            if not black:
                return F32(c * sr)
            sb = scales[valid & code_mask]
            return F32(F32(F32(c - acc) * sb) * sb)
        return c if black else F32(F32(c - F32(sr * acc)) * sr)

    for r0 in range(0, n, R):
        rows = [r0 + e for e in range(R) if r0 + e < n]
        if vec and r0 + R <= n:
            interior = (r0 + pk.min_off >= V
                        and r0 + R + V + pk.max_off <= n)
            ok, valid = pk.run_valid(r0, R) if interior else (False, None)
            if ok:
                b0 = pk.black_of(r0)
                black = [b0 ^ (e & 1) for e in range(R)]
            else:
                valid = [pk.row_valid(i, n) for i in rows]
                black = [pk.black_of(i) for i in rows]
        else:
            valid = [pk.row_valid(i, n) for i in rows]
            black = [pk.black_of(i) for i in rows]
        for e, i in enumerate(rows):
            acc = F32(0)
            for k in range(pk.T):
                s = F32(np.float64(acc) + np.float64(pk.coeff[k])
                        * np.float64(operand(at(i + pk.off[k]))))
                acc = s if (valid[e] >> k) & 1 else acc
            out[i] = finish(at(i), acc, black[e], valid[e])
    return out


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernel_replay_gives_the_eager_bits(grid, shift, vec):
    """Both passes replayed from the packed arguments, on the vector path
    (runs, run_valid) and on the per-row path (an unaligned x), give the
    eager apply's z bit for bit; w holds x s_r at red rows."""
    P = pits.RedBlackICPreconditioner.from_stencil(GRIDS[grid](), shift=shift)
    pk = _Packed(P.form)
    scales = P.form.scales.numpy()
    n = P.s_inv.shape[0]
    x = torch.randn(n, generator=torch.Generator().manual_seed(11))
    w = _replay_pass(pk, scales, x.numpy(), 0, vec)
    z = _replay_pass(pk, scales, w, 1, vec)
    np.testing.assert_array_equal(z.view(np.uint32), _bits(P._apply(x, 0)))
    red = P.red.numpy()
    np.testing.assert_array_equal(w[red].view(np.uint32),
                                  _bits(x * P.s_inv)[red])


def test_packed_groups_and_bits():
    """Grouped by (stride, extent), each group's terms adjacent and in the
    terms' order, a bit per term at its place; steps +-1; the center bit
    above the terms'."""
    st = grid_stencil((17, 9, 5), (-1.0, -0.7, -1.3), 6.0)
    # the terms interleaved across axes: groups still come out adjacent
    terms = tuple(st.terms[i] for i in (4, 0, 2, 5, 1, 3))
    form = cuda_rbic.RBICForm(st.n, terms, [1.0] * 6, torch.ones(65))
    pk = _Packed(form)
    assert pk.bit == [1, 4, 2, 5, 0, 3]
    assert pk.reuse == [False, True, False, True, False, True]
    assert [pk.goff[k] // pk.stride[k] for k in range(6)] == pk.step
    assert sorted(pk.step) == [-1, -1, -1, 1, 1, 1]
    assert pk.row_valid(0, st.n) >> 6 == 1
    buf = cuda_rbic.pack_args(form)
    assert isinstance(buf[1], ctypes.Array) and len(buf) == 13


@pytest.mark.parametrize("side", [8, 16, 216])
def test_runs_on_216_lines_use_run_valid(side):
    """Where the side is a multiple of the run, every interior run stays on
    one line of the stride-1 axis: run_valid's bits and the stepped colours
    equal row_valid's and black_of's row by row (sampled at 216^3)."""
    st = pits.laplacian(side, 3, device=CPU)
    form = cuda_rbic.RBICForm(st.n, st.terms, st.coeffs, torch.ones(65))
    pk = _Packed(form)
    R = STENCIL_RUN
    rng = np.random.default_rng(side)
    starts = (range(0, st.n, R) if st.n <= 4096 else
              R * rng.integers(0, st.n // R, 2000))
    for r0 in starts:
        r0 = int(r0)
        if not (r0 + pk.min_off >= 4 and r0 + R + 4 + pk.max_off <= st.n):
            continue
        ok, valid = pk.run_valid(r0, R)
        assert ok
        assert valid == [pk.row_valid(r0 + e, st.n) for e in range(R)]
        b0 = pk.black_of(r0)
        assert [b0 ^ (e & 1) for e in range(R)] == [
            pk.black_of(r0 + e) for e in range(R)]
