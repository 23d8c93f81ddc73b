"""Solver driver protocol (port of ``iterativesolvers_tpu/solvers/common.py``).

Each solver defines a state ``NamedTuple`` of tensors, an ``init`` and a
``step``.  The classic API drives the step on the device through
:func:`run_chunked`, which reads the data-dependent exit back to the host once
per phase of steps, one phase late, so the card is never left idle at a
check; the iterator API (:class:`SolverIterator`) exposes the same
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
import weakref
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.dtypes import as_dtype, default_reltol, real_dtype
from ..utils.history import ConvergenceHistory
from ..utils.profiling import span

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
    "CHUNK",
    "StepGraphs",
    "step_graphs",
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
    """Materialize a host ConvergenceHistory from device buffers (span
    ``its.history``: the scalar reads and the logs' copies to the host)."""
    with span("its.history"):
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

# the steady phase of run_chunked and every solver's default ``chunk``:
# chosen on the H100 against 32 and against the JAX package's 256 (PERF.md)
CHUNK = 16


def _phases(chunk: int):
    """Phase lengths of :func:`run_chunked`: the warm-up ladder below
    ``chunk``, then ``chunk`` forever."""
    for c in _WARMUP:
        if c < chunk:
            yield c
    while True:
        yield chunk


def chunked_steps(iters: int, chunk: int = CHUNK, *,
                  step_reads_host: bool = False) -> int:
    """Steps :func:`run_chunked` executes, masked ones included, for a solve
    that stops after ``iters`` live steps: the phases through the one that
    holds the last live step, and the one queued behind it before the host
    read that the solve was done (none with ``step_reads_host``)."""
    if chunk <= 1 or iters <= 0:
        return max(int(iters), 0)
    phases = _phases(chunk)
    ran = 0
    while ran < iters:
        ran += next(phases)
    return ran if step_reads_host else ran + next(phases)


def run_chunked(step, done, state, chunk: int = CHUNK, on_phase=None,
                graphs=None, *, step_reads_host: bool = False):
    """Drive ``state = step(state, live)`` until ``done(state)``, in phases
    of steps between which the host reads the data-dependent exit without
    waiting for the card to run dry.

    Inside a phase every step runs, and ``live = ~done(state)`` is handed to
    it as a 0-d bool tensor on the device.  ``step`` must return ``state``
    unchanged where ``live`` is false, so no visible state advances past
    convergence: iteration counters and logs freeze exactly at convergence,
    and the numerics are identical at every ``chunk``; only the exit
    granularity changes.  How a step masks itself is the solver's choice
    (CG masks its scalar coefficients, which costs no extra pass over a
    vector; see ``cg._cg_step``).

    Phases follow the warm-up ladder 8, 16, 32, 64, 128 (those below
    ``chunk``), then ``chunk``.  ``done`` is read once before the first
    phase, waiting for the device (a solve that starts converged runs no
    step).  After that each phase's ``done`` goes to pinned host memory
    behind an event, and the host reads it one phase late: with phase k+1
    queued, it waits for phase k's flag alone, so the card never runs dry
    at a check.  A solve whose last live step falls in phase j so runs
    phases 1 ... j+1 (:func:`chunked_steps`); the ranks of a mesh, which
    read the same flags, stop after the same phase.  ``step_reads_host``
    (LOBPCG's ``eigh``, svdl's ``svd``: a step that waits for the device
    itself) reads each phase's ``done`` after it, waiting, and runs no
    phase past the last live one.  ``chunk <= 1`` reads ``done`` before
    every step, waiting.  ``on_phase(state)``, if given, runs after each
    phase (``verbose``'s :func:`live_print`).

    Under a profiler, each executed step is a span ``its.step`` (its live
    mask included) and each exit read a span ``its.sync``
    (``utils/profiling.span``).

    ``graphs`` (a :class:`StepGraphs`, from :func:`step_graphs`): each
    phase is one replay of a CUDA graph of its steps, captured at its
    first use, instead of its steps enqueued one by one; the same steps,
    masks and exit reads.
    """
    if chunk <= 1:
        while not _finished(done, state):
            with span("its.step"):
                state = step(state, ~done(state))
            if on_phase is not None:
                on_phase(state)
        return state
    if graphs is not None:
        return graphs.run(step, done, state, chunk, on_phase)
    if _finished(done, state):
        return state
    flags = None if step_reads_host else _ExitFlags()
    for c in _phases(chunk):
        for _ in range(c):
            with span("its.step"):
                state = step(state, ~done(state))
        if on_phase is not None:
            on_phase(state)
        if _exit_after(done, state, flags):
            return state


def _finished(done, state) -> bool:
    """``done(state)`` read back to the host: it waits for the device."""
    with span("its.sync"):
        return bool(done(state))


def _exit_after(done, state, flags) -> bool:
    """The exit read after a phase that left ``state``: with ``flags`` (an
    :class:`_ExitFlags`), the flag of the phase before it; without, this
    phase's, waiting for the device."""
    if flags is None:
        return _finished(done, state)
    with span("its.sync"):
        flags.post(done(state))
        return flags.late()


class _ExitFlags:
    """The exit flags of one :func:`run_chunked` call's phases, each read
    one phase late.  On the card a flag is copied into a slot of a pinned
    host buffer, behind the phase that computed it, and an event recorded
    behind the copy; reading it waits for that event alone.  Two slots
    suffice: a slot is written again only after its flag was read.  On the
    CPU a flag is the stored bool."""

    def __init__(self):
        self.posted = 0
        self.host = None        # the pinned slots, on the card
        self.events = None
        self.slots = [False, False]

    def post(self, flag):
        """Queue the flag of the phase just enqueued (a 0-d bool tensor)."""
        i = self.posted % 2
        if flag.is_cuda:
            if self.host is None:
                self.host = torch.empty(2, dtype=torch.bool, pin_memory=True)
                self.slots = self.host.numpy()
                self.events = (torch.cuda.Event(), torch.cuda.Event())
            self.host[i].copy_(flag, non_blocking=True)
            self.events[i].record(torch.cuda.current_stream(flag.device))
        else:
            self.slots[i] = bool(flag)
        self.posted += 1

    def late(self) -> bool:
        """The flag of the phase before the one posted last, once it has
        reached the host; False after the first phase (the read before it
        found the solve not done)."""
        if self.posted < 2:
            return False
        i = self.posted % 2             # the slot of flag posted - 2
        if self.events is not None:
            self.events[i].synchronize()
        return bool(self.slots[i])


class StepGraphs:
    """The phases of :func:`run_chunked` as CUDA graphs, for the solves of
    one solver in one dtype on one operator whose vectors are row blocks
    over a mesh of several cards (``parallel/sharded.py``).

    Every collective of a step makes each card wait for the slowest rank's
    host to have launched its part; replayed, a phase of steps is one launch
    a rank, and the cards set the pace together.  A phase of ``c`` steps is
    captured at its first use (one warm-up step, masked off, on the capture
    stream, before the first capture) and replayed at every later use, in
    this solve and the next: the state lives in static tensors, into which
    each solve copies its initial state, and which each replay advances by
    ``c`` steps (the graph's last nodes copy the stepped state back).  The
    step must take no host read and keep no host-side state, and its
    collectives must be NCCL's, which a capture takes; every rank captures
    and replays in the same order, as every rank runs the same phases.
    What a solve returns is a copy of the static state.

    The solve's iteration limit is the 0-d tensor :meth:`limit`, which its
    ``done`` reads, so that a new ``maxiter`` replays the same graphs.  A
    state tensor that is a log along its first axis (``maxiter`` rows) is
    held at the longest a solve has given: a shorter one fills its leading
    rows and is returned as those rows (a step writes only at the live
    slots below the solve's limit, the same slots as in the solve's own
    log); a longer one makes new static state and captures anew.

    Memory, held while the operator lives: the static state (for CG x, r
    and u, a vector each, the scalars, and the residual log of the largest
    ``maxiter`` given) and the graphs' private pool (the intermediates of a
    phase's steps: a few vectors).

    The mesh counts each replay and its steps (``counts["replay"]`` and
    ``["replay_steps"]``) and, for each replay, the collectives the graph
    holds, as if issued again.  Under a profiler each capture is a span
    ``its.capture`` and each replay a span ``its.replay``.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.static = None
        self.graphs = {}        # phase length -> (graph, collectives held)
        self.pool = None
        self.stream = None
        self._limit = None

    def limit(self, maxiter: int) -> torch.Tensor:
        """The 0-d int64 tensor the captured steps read as the iteration
        limit, set to ``maxiter`` (on the stream, in order with the
        replays)."""
        if self._limit is None:
            self._limit = torch.zeros((), dtype=torch.int64,
                                      device=self.mesh.device)
        return self._limit.fill_(maxiter)

    def _load(self, state):
        """The solve's initial state copied into the static tensors; new
        static tensors (and no graphs) on the first solve or for a log
        longer than they hold."""
        S = self.static
        if S is None or any(d.shape[0] < t.shape[0]
                            for d, t in zip(S, state) if t.ndim):
            # owned copies: the caller's tensors (x0 among them) stay as
            # they are
            self.static, self.graphs = type(state)(
                *(t.clone() for t in state)), {}
            return
        for d, t in zip(S, state):
            (d[:t.shape[0]] if t.ndim else d).copy_(t)

    def run(self, step, done, state, chunk, on_phase=None):
        self._load(state)
        S, counts = self.static, self.mesh.counts
        flags = _ExitFlags()
        for c in () if _finished(done, S) else _phases(chunk):
            graph, held = self.graphs.get(c) or self._capture(step, done, c)
            with span("its.replay"):
                graph.replay()
            for kind, n in held.items():
                counts[kind] += n
            counts["replay"] += 1
            counts["replay_steps"] += c
            if on_phase is not None:
                on_phase(S)
            if _exit_after(done, S, flags):
                break
        return type(S)(*((d[:t.shape[0]] if t.ndim else d).clone()
                         for d, t in zip(S, state)))

    def _capture(self, step, done, c):
        S, counts = self.static, self.mesh.counts
        if self.stream is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=self.mesh.device)
            # what a capture may not do (a first launch's set-up, a
            # stream's dot ticket, NCCL's own start) happens here, in a
            # step that changes nothing
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                step(S, torch.zeros((), dtype=torch.bool,
                                    device=S[0].device))
            torch.cuda.current_stream().wait_stream(self.stream)
        before = dict(counts)
        graph = torch.cuda.CUDAGraph()
        with span("its.capture"), torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            s = S
            for _ in range(c):
                with span("its.step"):
                    s = step(s, ~done(s))
            for dst, src in zip(S, s):
                if dst is not src:
                    dst.copy_(src)
        # the capture ran nothing: its collectives are counted at replay
        held = {k: n - before[k] for k, n in counts.items() if n != before[k]}
        for kind, n in held.items():
            counts[kind] -= n
        self.graphs[c] = (graph, held)
        return self.graphs[c]


def step_graphs(op, dtype, key):
    """The :class:`StepGraphs` of ``op`` under ``key`` (the solver, and all
    that its captured steps hold fixed but the iteration limit: dtype,
    shape, ...), made at first use and kept while the operator lives (one
    for each solver and dtype: the shape is the operator's block); None
    where ``op.capturable(dtype)`` says no."""
    if not op.capturable(dtype):
        return None
    cache = _STEP_GRAPHS.setdefault(op, {})
    if key not in cache:
        cache[key] = StepGraphs(op.mesh)
    return cache[key]


# operator -> {key: StepGraphs}; an entry goes with its operator
_STEP_GRAPHS = weakref.WeakKeyDictionary()
