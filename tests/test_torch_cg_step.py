"""The CG step's vector work (``ops/cuda_cg.py``) on the CPU: its plain
versions against a numpy replay of the kernels' arithmetic and sum order
(``csrc/cg_step.cu``), which solve vectors take the route, and the step's
contract on it (a masked step, the iterator's checkpoints).  The kernels
themselves run in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import _launch, cuda_cg
from iterativesolvers_tpu_torch.solvers import cg as pcg
from iterativesolvers_tpu_torch.solvers.common import chunked_steps

torch.set_num_threads(1)

F32 = np.float32
T, RUN = _launch.THREADS, cuda_cg.RUN


def _warp(lanes):
    """Lane 0 of ``__shfl_down_sync``'s tree: lane l adds lane l + o, or
    itself past the warp's last lane."""
    v = [F32(a) for a in lanes]
    for o in (16, 8, 4, 2, 1):
        v = [F32(v[l] + (v[l + o] if l + o < 32 else v[l])) for l in range(32)]
    return v[0]


def _block(values):
    """``block_sum`` of a block's threads: each warp's tree, then the first
    warp's tree of the warp sums, its other lanes 0."""
    warps = [_warp(values[w:w + 32]) for w in range(0, len(values), 32)]
    return _warp(warps + [F32(0)] * (32 - len(warps)))


def replay_sum(p, grid):
    """The kernels' sum of the f32 products ``p``, thread by thread."""
    n, runs = len(p), -(-len(p) // RUN)
    partials = []
    for b in range(grid):
        local = []
        for t in range(T):
            s, j = F32(0), b * T + t
            while j < runs:
                for i in range(RUN * j, min(RUN * j + RUN, n)):
                    s = F32(s + p[i])
                j += grid * T
            local.append(s)
        partials.append(_block(local))
    last = []
    for t in range(T):
        s = F32(0)
        for i in range(t, grid, T):
            s = F32(s + partials[i])
        last.append(s)
    return _block(last)


def _fma(a, b, c):
    """f32 a b + c rounded once (the f64 product is exact)."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


@pytest.mark.parametrize("n, grid", [(1, 1), (5003, 1), (5003, 3),
                                     (4 * 256 * 300 + 7, 300), (777, None)])
def test_kernel_sum_is_the_kernels_order(n, grid):
    """``kernel_sum`` on any grid against the thread-by-thread replay, bit
    for bit: runs of 4 rows, a grid-stride loop, the shuffle trees, the last
    block's sum of the partials (more than 256 of them at grid 300)."""
    g = torch.Generator().manual_seed(n)
    p = torch.randn(n, generator=g) * torch.rand(n, generator=g) ** 4
    grid_ = cuda_cg.plain_grid(n) if grid is None else grid
    got = cuda_cg.kernel_sum(p, grid_)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == float(replay_sum(p.numpy(), grid_))


def test_plain_grid_follows_the_runs():
    assert [cuda_cg.plain_grid(n) for n in (1, 1024, 1025, 10**8)] == [
        1, 1, 2, cuda_cg.PLAIN_BLOCKS]


def test_plain_versions_round_as_the_kernels():
    """The plain direction, update and rho against numpy's replay of the
    kernels' roundings: u' = c + (beta u) and r' = r - (alpha c) with the
    products rounded, x' one fused multiply-add, the sums in the kernels'
    order, the correctly rounded square root; the count and the log slot."""
    n = 2051
    g = torch.Generator().manual_seed(3)
    x, u, r, c, c2 = (torch.randn(n, generator=g) for _ in range(5))
    live = torch.tensor(True)
    rho_prev, sigma = torch.tensor(1.3), torch.tensor(-2.9)
    dot = cuda_cg.cg_rho(c, r)
    grid = cuda_cg.plain_grid(n)
    assert float(dot) == float(replay_sum((c * r).numpy(), grid))
    for square, src in ((False, dot), (True, torch.tensor(0.7))):
        u2, rho = cuda_cg.cg_direction(c, u, src, rho_prev, live,
                                       square=square)
        s = F32(src.item())
        want_rho = F32(s * s) if square else s
        beta = F32(want_rho / F32(rho_prev.item()))
        np.testing.assert_array_equal(
            u2.numpy(), (c.numpy() + (beta * u.numpy()).astype(F32)))
        assert float(rho) == float(want_rho)
    alpha = F32(F32(rho.item()) / F32(sigma.item()))
    k, log = torch.tensor(9), torch.zeros(4)
    x2, r2, res, k2 = cuda_cg.cg_update(x, u2, r, c2, rho, sigma, live,
                                        torch.tensor(5.0), k, log)
    np.testing.assert_array_equal(x2.numpy(), _fma(alpha, u2.numpy(),
                                                   x.numpy()))
    want_r = r.numpy() - alpha * c2.numpy()
    np.testing.assert_array_equal(r2.numpy(), want_r)
    rr = replay_sum((want_r * want_r).astype(F32), grid)
    assert float(res) == float(F32(np.sqrt(np.float64(rr))))
    assert int(k2) == 10 and float(log[3]) == float(res)
    assert int((log != 0).sum()) == 1


def test_plain_update_masked_keeps_its_inputs():
    n = 300
    g = torch.Generator().manual_seed(4)
    x, u, r, c = (torch.randn(n, generator=g) for _ in range(4))
    x[3] = -0.0
    off = torch.tensor(False)
    log = torch.arange(4.0)
    x2, r2, res, k2 = cuda_cg.cg_update(
        x, u, r, c, torch.tensor(1.0), torch.tensor(0.0), off,
        torch.tensor(5.0), torch.tensor(2), log)
    u2, rho = cuda_cg.cg_direction(c, u, torch.tensor(3.0),
                                   torch.tensor(0.0), off, square=True)
    for a, b in ((x2, x), (r2, r), (u2, u)):
        assert torch.equal(a, b) and torch.equal(a.signbit(), b.signbit())
    assert float(res) == 5.0 and int(k2) == 2 and float(rho) == 0.0
    assert torch.equal(log, torch.arange(4.0))


@pytest.mark.parametrize("dtype, shape, contiguous, want", [
    (torch.float32, (64,), True, True),
    (torch.float64, (64,), True, False),
    (torch.complex64, (64,), True, False),
    (torch.bfloat16, (64,), True, False),
    (torch.float32, (64, 2), True, False),
    (torch.float32, (64,), False, False),
])
def test_takes_routes_by_dtype_shape_and_layout(dtype, shape, contiguous,
                                               want):
    v = torch.zeros(shape[:1] + (2,) if not contiguous else shape,
                    dtype=dtype)
    v = v[:, 0] if not contiguous else v
    assert cuda_cg.takes(v) is want
    assert cuda_cg.takes(torch.zeros(64), torch.zeros(65)) is False


@pytest.mark.parametrize("bad, at", [
    (torch.tensor(1.0, dtype=torch.float64), 0),
    (torch.tensor([1.0]), 1),
    (torch.tensor(1.0), 2),
    (torch.tensor(3, dtype=torch.int32), 4),
    (None, None),
])
def test_scalar_checks_take_0d_tensors_of_their_dtypes(bad, at):
    """The launches' 0-d inputs are checked before their addresses are
    passed: each must be 0-d, of its dtype and on the vectors' device."""
    good = [torch.tensor(2.0), torch.tensor(3.0), torch.tensor(True),
            torch.tensor(1.5), torch.tensor(7)]
    if bad is None:
        ptrs = cuda_cg._scalars(-1, cuda_cg._UPDATE_SCALARS, *good)
        assert ptrs == [t.data_ptr() for t in good]
        return
    good[at] = bad
    with pytest.raises(ValueError, match="0-d"):
        cuda_cg._scalars(-1, cuda_cg._UPDATE_SCALARS, *good)
    with pytest.raises(ValueError, match="0-d"):
        cuda_cg._scalars(0, cuda_cg._UPDATE_SCALARS, *good[:3])


class _Counted:
    """The module's functions counted by name, for one solve."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in ("cg_rho", "cg_direction", "cg_update"):
            f = getattr(cuda_cg, name)

            def counted(*a, _f=f, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _f(*a, **kw)

            monkeypatch.setattr(cuda_cg, name, counted)


@pytest.mark.parametrize("dtype, route", [(torch.float32, True),
                                          (torch.float64, False),
                                          (torch.complex64, False)])
@pytest.mark.parametrize("precond", [False, True])
def test_cg_takes_the_route_for_f32_vectors_only(monkeypatch, dtype, route,
                                                  precond):
    """A real f32 solve runs the direction and update once a step (and rho
    with a preconditioner); f64 and complex solves run the eager step."""
    st = pits.laplacian(8, 3, dtype=dtype, device="cpu")
    b = torch.ones(st.n, dtype=dtype)
    Pl = (pits.DiagonalPreconditioner(torch.full((st.n,), 6.0, dtype=dtype),
                                      device="cpu") if precond else None)
    calls = _Counted(monkeypatch).calls
    x, h = pits.cg(st, b, Pl=Pl, reltol=1e-5, log=True)
    assert h.isconverged and x.dtype == dtype
    steps = chunked_steps(h.iters)
    want = ({"cg_direction": steps, "cg_update": steps,
             **({"cg_rho": steps} if precond else {})} if route else {})
    assert calls == want


def test_cg_on_a_2d_x_runs_the_eager_step(monkeypatch):
    """A 2-D solve vector (one right-hand side as a column) keeps the eager
    step."""
    A = pits.FunctionOperator(lambda v: 4.0 * v, (16, 16), torch.float32,
                              device="cpu")
    calls = _Counted(monkeypatch).calls
    st = pcg._cg_init(A, torch.ones(16, 1), torch.zeros(16, 1),
                      torch.tensor(1e-6), torch.tensor(0.0), 10, True)
    s = pcg._cg_step(A, pits.IdentityPreconditioner(), st, torch.tensor(True))
    assert calls == {} and s.x.shape == (16, 1)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("in_place", [False, True])
def test_masked_step_returns_its_state_bit_for_bit(precond, in_place):
    """On the route, a step with ``live`` false returns every field of its
    state bit for bit; without ``log_in_place`` neither step writes a tensor
    of the state it was given."""
    st = pits.laplacian(10, 3, device="cpu")
    Pl = (pits.DiagonalPreconditioner(torch.full((st.n,), 6.0), device="cpu")
          if precond else pits.IdentityPreconditioner())
    b = torch.randn(st.n, generator=torch.Generator().manual_seed(1))
    it = pits.cg_iterator(st, b, Pl=Pl)
    for _ in range(4):
        next(it)
    s = it.state
    frozen = [t.clone() for t in s]
    off = pcg._cg_step(st, Pl, s, torch.tensor(False), log_in_place=in_place)
    for a, f in zip(off, frozen):
        assert torch.equal(a, f)
    on = pcg._cg_step(st, Pl, s, torch.tensor(True), log_in_place=in_place)
    assert int(on.k) == int(s.k) + 1
    if not in_place:
        for a, f in zip(s, frozen):
            assert torch.equal(a, f)


def test_f32_iterator_states_stay_checkpoints():
    """The f32 iterator (the route's plain versions) yields the solve's
    residuals; a state held at step 3 is never written, and stepping on
    from it gives the solve's x."""
    st = pits.laplacian(9, 3, device="cpu")
    b = torch.randn(st.n, generator=torch.Generator().manual_seed(2))
    x, h = pits.cg(st, b, log=True)
    it = pits.cg_iterator(st, b)
    res = []
    for k, r in enumerate(it):
        res.append(float(r))
        if k == 2:
            saved = it.state
            frozen = [t.clone() for t in saved]
    np.testing.assert_array_equal(res, h["resnorm"])
    assert torch.equal(it.x, x)
    assert all(torch.equal(a, f) for a, f in zip(saved, frozen))
    resumed = pits.cg_iterator(st, b)
    resumed.state = saved
    for _ in resumed:
        pass
    assert torch.equal(resumed.x, x)


def test_unpreconditioned_rho_is_the_residual_squared():
    """Without a preconditioner the state's rho is the square of the
    residual the step started from (src/cg.jl's ``it.residual^2``)."""
    st = pits.laplacian(7, 3, device="cpu")
    it = pits.cg_iterator(st, torch.ones(st.n))
    prev = it.state.residual
    next(it)
    assert float(it.state.rho) == float(prev * prev)


def test_a_product_outside_the_route_is_made_contiguous():
    """An operator whose product is a strided view (a FunctionOperator's)
    takes the route with the product made contiguous: the same bits as the
    contiguous product's solve."""
    st = pits.laplacian(6, 3, device="cpu")
    b = torch.randn(st.n, generator=torch.Generator().manual_seed(5))

    def strided(v):
        return torch.stack([st.mv(v), v], dim=1)[:, 0]

    op = pits.FunctionOperator(strided, st.shape, torch.float32, device="cpu")
    x, h = pits.cg(op, b, log=True)
    xs, hs = pits.cg(st, b, log=True)
    assert h.iters == hs.iters and torch.equal(x, xs)
