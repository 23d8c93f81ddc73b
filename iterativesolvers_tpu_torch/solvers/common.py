"""Solver driver protocol (port of ``iterativesolvers_tpu/solvers/common.py``).

Each solver defines a state ``NamedTuple`` of tensors, an ``init`` and a
``step``.  The classic API drives the step on the device through
:func:`run_chunked`, which reads the data-dependent exit back to the host only
once per phase; the iterator API (:class:`SolverIterator`) exposes the same
step eagerly, and its state doubles as a checkpoint.

Shared behavioral contract (SURVEY §2.3):
  * stopping: ``resnorm <= max(reltol * resnorm0, abstol)``
    with defaults ``reltol = sqrt(eps(real(T)))``, ``abstol = 0``
    (src/cg.jl:121-122,141)
  * ``maxiter = size(A, 2)`` default (src/cg.jl:123)
  * allocating form starts from x0 = 0 and skips the initial A*x product
    (``initially_zero``, src/cg.jl:132-139)
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.dtypes import as_dtype, default_reltol, real_dtype
from ..utils.history import ConvergenceHistory

__all__ = [
    "SolveResult",
    "with_highest_precision",
    "tolerance",
    "norm",
    "vdot",
    "safe_inv",
    "random_like",
    "SolverIterator",
    "resolve_tols",
    "Problem",
    "prepare",
    "make_history",
    "print_resnorms",
    "live_print",
    "select",
    "log_at",
    "run_chunked",
    "chunked_steps",
    "allreduce",
    "row_norms",
    "local_len",
]


def norm(x, mesh=None):
    """2-norm, always real.  (Complex-safe: sums |x|^2.)  With a ``mesh``
    (an operator's ``mesh``, ``parallel/sharded.py``; None is one device)
    ``x`` is this rank's block of a row-sharded vector, and the local sum of
    squares is allreduced over the mesh."""
    if mesh is None:
        return torch.linalg.vector_norm(x)
    xr = (x * x.conj()).real if x.is_complex() else x * x
    return torch.sqrt(mesh.all_reduce(torch.sum(xr)))


def vdot(a, b, mesh=None):
    """<a, b> with the first argument conjugated (Julia ``dot`` semantics);
    with a ``mesh``, of two row-sharded vectors (see :func:`norm`)."""
    s = torch.sum(a.conj() * b)
    return s if mesh is None else mesh.all_reduce(s)


def safe_inv(x):
    """1/x for x > 0, else 0 — the breakdown guard used when normalizing
    Golub-Kahan / Lanczos vectors (a zero norm means the recurrence
    terminated; the masked-step machinery freezes the state)."""
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)


def random_like(generator, shape, dtype, mesh=None):
    """Uniform random block of ``shape`` drawn from ``generator`` (a
    ``torch.Generator``) on its device; complex dtypes get independent
    uniform real and imaginary parts (the analogue of the reference's
    ``rand(T, n)`` shadow residuals / shadow spaces, src/bicgstabl.jl:38,
    src/idrs.jl:132).  With a ``mesh`` the last axis of ``shape`` is the
    global n: the whole block is drawn on every rank and this rank's rows
    returned, so a row-sharded solve draws the vectors of the one-device
    solve."""
    dev = generator.device
    rdt = real_dtype(dtype)
    out = torch.rand(shape, generator=generator, dtype=rdt, device=dev)
    if as_dtype(dtype).is_complex:
        im = torch.rand(shape, generator=generator, dtype=rdt, device=dev)
        out = torch.complex(out, im).to(dtype)
    if mesh is not None:
        nloc = -(-shape[-1] // mesh.size)
        lo = min(mesh.rank * nloc, shape[-1])
        out = out[..., lo:lo + nloc].contiguous()
    return out


def tolerance(resnorm0, reltol, abstol):
    """max(reltol*|r0|, abstol) — src/cg.jl:141."""
    return torch.maximum(reltol * resnorm0, abstol)


def resolve_tols(dtype, reltol: Optional[float], abstol: Optional[float],
                 device=None):
    """(reltol, abstol) as 0-d tensors of the real solve dtype on ``device``."""
    if reltol is None:
        reltol = default_reltol(dtype)
    if abstol is None:
        abstol = 0.0
    rt = real_dtype(dtype)
    return (torch.tensor(float(reltol), dtype=rt, device=device),
            torch.tensor(float(abstol), dtype=rt, device=device))


def allreduce(t, mesh=None):
    """``t``, a rank-local partial of a sum over rows, summed over ``mesh``
    (in place; every rank gets the same bits); ``t`` itself on one device.
    The block solvers send each Gram, norm and projection through it."""
    return t if mesh is None else mesh.all_reduce(t)


def row_norms(R, mesh=None):
    """The 2-norm of each row of a (k, n) panel; with a ``mesh``, of a
    row-sharded panel (each rank's sums of squares allreduced)."""
    return torch.sqrt(allreduce(torch.sum((R.conj() * R).real, dim=1),
                                mesh))


def local_len(n: int, mesh=None) -> int:
    """Rows of a length-n vector this rank holds: n on one device, the
    rank's block on a mesh."""
    if mesh is None:
        return int(n)
    lo, hi = mesh.rows(n)
    return hi - lo


class Problem(NamedTuple):
    """A solve's inputs on the operator's device (:func:`prepare`)."""

    op: Any
    b: Any
    x0: Any
    Pl: Any
    reltol: Any             # 0-d tensors of the real solve dtype
    abstol: Any
    maxiter: int
    initially_zero: bool


def prepare(A, b, x0=None, Pl=None, abstol=None, reltol=None, maxiter=None):
    """The common set-up of a solver call: the operator (``as_operator``)
    and preconditioner on the operator's device, ``b`` and ``x0`` moved
    there (``x0 = 0`` of ``b``'s rows and the solve dtype when None: all n
    on one device, this rank's block on a mesh), ``maxiter`` defaulting to
    the operator's n, and the tolerances (:func:`resolve_tols`)."""
    from ..operators.linear_operator import as_operator
    from ..operators.preconditioners import as_preconditioner
    from ..utils.dtypes import solve_dtype

    op = as_operator(A, b)
    dev = op.device
    Pl = as_preconditioner(Pl, device=dev)
    b = torch.as_tensor(b, device=dev)
    maxiter = int(maxiter if maxiter is not None else op.shape[1])
    dtype = solve_dtype(op.dtype, b.dtype)
    initially_zero = x0 is None
    if x0 is None:
        x0 = torch.zeros(b.shape[0], dtype=dtype, device=dev)
    else:
        x0 = torch.as_tensor(x0, device=dev)
    reltol_, abstol_ = resolve_tols(dtype, reltol, abstol, device=dev)
    return Problem(op, b, x0, Pl, reltol_, abstol_, maxiter, initially_zero)


class SolveResult(NamedTuple):
    """Uniform device-side result every solver returns from its core."""

    x: Any                  # solution (vector / matrix)
    iters: Any              # int — iterations performed
    converged: Any          # bool
    resnorm: Any            # final residual norm estimate
    log: dict               # name -> (buffer, nvalid) fixed-size series


def make_history(
    res: SolveResult,
    *,
    mv_per_iter: float = 1.0,
    mv_initial: int = 1,
    mtv_per_iter: float = 0.0,
    restart: Optional[int] = None,
    partial: bool = False,
    extra_counters: Optional[dict] = None,
) -> ConvergenceHistory:
    """Materialize a host ConvergenceHistory from device buffers."""
    h = ConvergenceHistory(partial=partial, restart=restart)
    iters = int(res.iters)
    h.iters = iters
    h.isconverged = bool(res.converged)
    h.mvps = int(round(mv_initial + mv_per_iter * iters))
    h.mtvps = int(round(mtv_per_iter * iters))
    if extra_counters:
        for k, v in extra_counters.items():
            setattr(h, k, int(v))
    for key, (buf, nvalid) in res.log.items():
        h.set_series(key, buf.detach().cpu().numpy(), int(nvalid))
    return h


def print_resnorms(res: SolveResult, key: str = "resnorm") -> None:
    """Host-side per-iteration residual printout after the solve (the
    reference prints live via @printf, src/cg.jl:234)."""
    buf, nvalid = res.log[key]
    for i, v in enumerate(buf[: int(nvalid)].tolist()):
        print(f"{i + 1:3d}\t{v:.2e}")


def live_print(log_of):
    """``verbose=True``'s printout as a :func:`run_chunked` ``on_phase``
    hook: after each phase it prints the residuals logged since its last
    call, numbered from 1.  ``log_of(state)`` gives ``(buffer, nvalid)``.
    The JAX package prints each step inside its compiled loop; here the
    lines of a phase come at the phase's end, with one host read a phase
    beside ``run_chunked``'s own, none a step."""
    printed = [0]

    def hook(state):
        buf, nvalid = log_of(state)
        k = int(nvalid)
        for i, v in enumerate(buf[printed[0]:k].tolist(), printed[0]):
            print(f"{i + 1:3d}\t{v:.2e}")
        printed[0] = max(printed[0], k)

    return hook


def select(live, new, old, keep=("resnorm_log",)):
    """The state ``new`` where the 0-d bool tensor ``live`` is true, else
    ``old``, field by field (the masked step of :func:`run_chunked`, as the
    JAX package's ``guarded`` selects every leaf); ``new`` itself when
    ``live`` is None (the iterator's unmasked step).  Fields named in
    ``keep`` come from ``new`` as they are: the residual log, which the
    step writes with :func:`log_at` under the same mask."""
    if live is None:
        return new
    return type(new)(*(a if f in keep else torch.where(live, a, b)
                       for f, a, b in zip(new._fields, new, old)))


def log_at(log, k, value, live=None, in_place=False):
    """``log`` with ``value`` (a row of the log: a 0-d tensor for a 1-D
    log) at slot ``k`` (a 0-d int tensor, clamped to the buffer) where
    ``live`` (a 0-d bool tensor; None: always).  A copy unless
    ``in_place``: a solve's own loop, which holds no earlier state, writes
    in place, to avoid a copy of the whole buffer a step."""
    log = log if in_place else log.clone()
    slot = k.clamp(min=0, max=log.shape[0] - 1).reshape(1)
    if live is not None:
        value = torch.where(live, value, log.index_select(0, slot)[0])
    log.index_put_((slot,),
                   value.reshape((1,) + tuple(log.shape[1:])).to(log.dtype))
    return log


class SolverIterator:
    """Eager iterator over a solver's step — the analogue of the reference's
    iterator protocol (docs/src/iterators.md:1-77).

    Yields a per-iteration value (typically the residual norm).  The caller
    may inspect/replace ``.state`` between steps (e.g. swap the RHS), exactly
    like mutating the reference's iterable struct.  A step returns a new
    state and changes no tensor of the state it was given, so an old
    ``.state`` stays a valid checkpoint.
    """

    def __init__(
        self,
        state,
        step: Callable,
        done: Callable,
        extract: Callable = lambda s: s,
        get_x: Callable | None = None,
    ):
        self.state = state
        self._step = step
        self._done = done
        self._extract = extract
        self._get_x = get_x

    def __iter__(self):
        return self

    def __next__(self):
        if bool(self._done(self.state)):
            raise StopIteration
        self.state = self._step(self.state)
        return self._extract(self.state)

    @property
    def x(self):
        st = self.state
        if self._get_x is not None:
            return self._get_x(st)
        return getattr(st, "x", None) if hasattr(st, "x") else st.X


@contextlib.contextmanager
def _highest_precision():
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def with_highest_precision(f):
    """Run a solver core with TF32 off for matmuls and cuDNN: TF32 keeps
    about three decimal digits, fatal for Krylov orthogonalization and Gram
    matrices in f32.  The previous settings are restored on exit."""

    @functools.wraps(f)
    def g(*args, **kwargs):
        with _highest_precision():
            return f(*args, **kwargs)

    return g


_WARMUP = (8, 16, 32, 64, 128)


def _phases(chunk: int):
    """Phase lengths of :func:`run_chunked`: the warm-up ladder below
    ``chunk``, then ``chunk`` forever."""
    for c in _WARMUP:
        if c < chunk:
            yield c
    while True:
        yield chunk


def chunked_steps(iters: int, chunk: int = 256) -> int:
    """Steps :func:`run_chunked` executes, masked ones included, for a solve
    that stops after ``iters`` live steps."""
    if chunk <= 1:
        return int(iters)
    done = 0
    for c in _phases(chunk):
        if done >= iters:
            return done
        done += c


def run_chunked(step, done, state, chunk: int = 256, on_phase=None):
    """Drive ``state = step(state, live)`` until ``done(state)``, reading the
    data-dependent exit back to the host only once per phase: every read
    waits for the device, so a check per step would idle the card between
    steps.

    Inside a phase every step runs, and ``live = ~done(state)`` is handed to
    it as a 0-d bool tensor on the device.  ``step`` must return ``state``
    unchanged where ``live`` is false, so no visible state advances past
    convergence: iteration counters and logs freeze exactly at convergence,
    and the numerics are identical at every ``chunk``; only the exit
    granularity changes.  How a step masks itself is the solver's choice
    (CG masks its scalar coefficients, which costs no extra pass over a
    vector; see ``cg._cg_step``).

    Phases follow the warm-up ladder 8, 16, 32, 64, 128 (those below
    ``chunk``), then ``chunk``: a solve converging at iteration ~10 should
    not run a full steady-state chunk of masked steps.  ``chunk <= 1``
    checks ``done`` on the host before every step.  ``on_phase(state)``,
    if given, runs after each phase (``verbose``'s :func:`live_print`).
    """
    if chunk <= 1:
        while not bool(done(state)):
            state = step(state, ~done(state))
            if on_phase is not None:
                on_phase(state)
        return state
    for c in _phases(chunk):
        if bool(done(state)):
            return state
        for _ in range(c):
            state = step(state, ~done(state))
        if on_phase is not None:
            on_phase(state)
