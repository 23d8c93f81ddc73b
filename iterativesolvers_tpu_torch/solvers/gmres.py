"""Restarted GMRES(m) — port of ``iterativesolvers_tpu/solvers/gmres.py``.

Design, as in the JAX package (reference: src/gmres.jl):

  * The Arnoldi panel is stored as rows, V (m+1, n): every panel op is a
    contiguous-row read or write.  Rows past the active count are zero, so
    orthogonalization against the whole panel stays exact.  The panel is
    flat; the JAX package's (rows, 512) padded layout was a TPU re-tiling
    artifact and is not carried over.
  * The Hessenberg QR is kept incrementally with Givens rotations (one new
    rotation per step), so the residual estimate ``|g[k+1]|`` is free and
    the restart solve is a masked back-substitution.
  * The loop is cycle-granular: one trip of the Python loop is one restart
    cycle of ``restart`` masked Arnoldi steps, one finalize and one fresh
    cycle.  ``k``, ``do`` and the residual stay tensors on the device; the
    host reads ``done`` once per cycle and never per step.

Semantics preserved: left/right preconditioning ``Pl^{-1} A Pr^{-1}``
(src/gmres.jl:285-304), stopping on the preconditioned residual, restart
default ``min(20, n)`` (src/gmres.jl:113), pluggable orthogonalization with
MGS default (src/gmres.jl:116), solution formed only at restart/convergence.

The Arnoldi step takes one of three kernel routes where it applies, chosen by
``_fused_setup``, ``_stencil_panel_setup`` and ``_use_panel_mgs`` (the JAX
package's rule without its TPU and VMEM gates): the fused step
(``ops/cuda_arnoldi.fused_arnoldi``) on an unpreconditioned stencil operator
with a panel of the solve's dtype; the panel SpMV
(``ops/cuda_arnoldi.stencil_panel_mv``) and panel MGS
(``ops/cuda_mgs.panel_mgs``) on such an operator with a bf16 panel; and
``op.mv`` followed by the panel MGS for any other real f32 MGS solve.  Every
other solve (f64, complex, CGS/CGS2/DGKS) runs plain PyTorch
(``ops/orthogonalize.py``), on a mesh with its reductions allreduced.

On a row-sharded operator of D > 1 ranks (``op.mesh``, ``parallel/``) the
step takes the sharded-panel route (``_dist_panel_setup``): the panel lives
in the per-rank padded ``(m+1, R, 512)`` blocks of ``parallel/panel_ortho.py``
and is orthogonalized by distributed CGS2, whose two sweeps are the CUDA
kernels of ``ops/cuda_panel_ortho.py`` in an f32 solve.  Every scalar of the
state is computed from allreduced values, so all ranks hold the same bits.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ..operators.linear_operator import as_operator
from ..operators.preconditioners import as_preconditioner, is_identity
from ..operators.stencil import StencilOperator
from ..ops.cuda_arnoldi import fused_arnoldi, stencil_panel_mv
from ..ops.cuda_mgs import PANEL_DTYPES, panel_mgs
from ..ops.givens import apply_givens, apply_givens_chain, givens
from ..ops.hessenberg import back_substitute
from ..ops.orthogonalize import ORTH_METHODS, orthogonalize_and_normalize_rows
from ..parallel.panel_ortho import (dist_panel_ortho, panel_layout,
                                    panel_row_to_vec, vec_to_panel_row)
from ..utils.dtypes import as_dtype, real_dtype, solve_dtype
from .common import (SolveResult, SolverIterator, make_history, norm,
                     resolve_tols, tolerance, with_highest_precision)

__all__ = ["gmres", "gmres_iterator", "GMRESState"]


class GMRESState(NamedTuple):
    x: torch.Tensor
    V: torch.Tensor          # (m+1, n) Arnoldi basis rows, zero beyond
    #                          active; (m+1, R, 512) blocks on a mesh
    R: torch.Tensor          # (m+1, m) rotated Hessenberg (upper triangular)
    g: torch.Tensor          # (m+1,) rotated rhs
    cs: torch.Tensor         # (m,) Givens cosines (real)
    ss: torch.Tensor         # (m,) Givens sines
    k: torch.Tensor          # inner iteration within the current cycle (int32)
    kt: torch.Tensor         # total inner iterations (int32)
    restarts: torch.Tensor
    residual: torch.Tensor
    tol: torch.Tensor
    stall: torch.Tensor      # consecutive no-progress IR cycles (else 0)
    resnorm_log: torch.Tensor


def _use_panel_mgs(n, dtype, orth_method, panel_dtype=None):
    """The panel-MGS kernel (ops/cuda_mgs.py) applies to a real f32 solve
    with MGS, on an f32 or bf16 panel, at every n."""
    pd = dtype if panel_dtype is None else panel_dtype
    return (orth_method == "mgs" and dtype == torch.float32
            and pd in PANEL_DTYPES)


def _stencil_panel_setup(op, Pl, Pr, n, dtype, orth_method, panel_dtype=None):
    """The stencil kernels that read the panel (ops/cuda_arnoldi.py) apply
    to an unpreconditioned ``StencilOperator`` in a real f32 MGS solve.
    Returns their stencil arguments ``(n, center, terms, coeffs)`` or
    None."""
    if orth_method != "mgs" or dtype != torch.float32:
        return None
    if not isinstance(op, StencilOperator):
        return None
    if not (is_identity(Pl) and is_identity(Pr)):
        return None
    return (op.n, op.center, op.terms, op.coeffs)


def _fused_setup(op, Pl, Pr, n, dtype, orth_method, panel_dtype=None):
    """The fused Arnoldi kernel: the stencil route with a panel of the
    solve's dtype (the JAX package fuses only f32 panels, gmres.py:100-116;
    the H100 comparison of the two routes is in PERF.md)."""
    if panel_dtype is not None and panel_dtype != dtype:
        return None
    return _stencil_panel_setup(op, Pl, Pr, n, dtype, orth_method,
                                panel_dtype)


class _DistPanel(NamedTuple):
    """The sharded-panel route (``gmres.py:119-148`` of the JAX package):
    the Krylov panel lives in the per-rank padded ``(m+1, R, 512)`` blocks
    of ``parallel/panel_ortho.py`` and is orthogonalized by distributed CGS2
    (two classical passes, the DGKS stability class): one (m+1,)-vector
    allreduce a pass instead of distributed MGS's m scalar allreduces a
    step."""
    mesh: object
    layout: object

    def to_row(self, vec):
        return vec_to_panel_row(vec, self.mesh, self.layout)

    def row_to_vec(self, row2d):
        return panel_row_to_vec(row2d, self.mesh, self.layout)

    def ortho(self, V, w, k):
        return dist_panel_ortho(V, w, k, V.shape[0], self.mesh, self.layout)

    @property
    def vtail(self):
        return (self.layout.R, 512)


def _dist_panel_setup(op, n, dtype, orth_method, warn: bool = False,
                      explicit: bool = True) -> _DistPanel | None:
    """The sharded-panel route applies when the operator carries a mesh of
    D > 1 ranks, the solve is real f32/f64 and the caller asked for the
    default MGS (subsumed by CGS2 on a mesh) or CGS/CGS2 explicitly.  A
    non-divisible n takes the layout's zero-padded last shard.

    Elsewhere on a mesh ('dgks', complex dtypes) it returns None and the
    step orthogonalizes this rank's rows of the panel with the requested
    method through ``ops/orthogonalize.py`` and the mesh (a projection's
    coefficients and each norm allreduced), as the JAX package falls back
    to GSPMD orthogonalization.  ``warn=True`` (set once by ``gmres()``)
    warns of that fallback, and where an EXPLICIT 'mgs'/'cgs' is upgraded
    to distributed CGS2 (the solver's own default pick is not a
    substitution)."""
    mesh = op.mesh
    if mesh is None or mesh.size <= 1:
        return None
    D = mesh.size
    on_mesh_but = None
    if orth_method not in ("mgs", "cgs", "cgs2"):
        on_mesh_but = f"orth_method={orth_method!r} has no sharded-panel form"
    elif dtype not in (torch.float32, torch.float64):
        on_mesh_but = f"solve dtype {dtype} is not f32/f64"
    if on_mesh_but is not None:
        if warn:
            warnings.warn(
                f"gmres on a {D}-device mesh operator: {on_mesh_but}; "
                "falling back to mesh-reduced orthogonalization (an "
                "allreduce per projection and norm, m of them a step with "
                "MGS, instead of the sharded-panel CGS2 route)",
                stacklevel=3)
        return None
    if warn and explicit and orth_method in ("mgs", "cgs"):
        warnings.warn(
            f"gmres on a {D}-device mesh operator: orth_method="
            f"{orth_method!r} is subsumed by distributed CGS2 on the "
            "sharded-panel path (same DGKS stability class, one (m+1,)-"
            "vector allreduce per pass)", stacklevel=3)
    return _DistPanel(mesh, panel_layout(n, D))


class _Routes(NamedTuple):
    fused: tuple | None        # stencil args of fused_arnoldi
    panel_mv: tuple | None     # stencil args of stencil_panel_mv
    mgs: bool                  # panel_mgs orthogonalizes
    dist: _DistPanel | None    # the sharded-panel route


def _routes(op, Pl, Pr, n, dtype, orth_method, vdtype) -> _Routes:
    dist = _dist_panel_setup(op, n, dtype, orth_method)
    if dist is not None:
        return _Routes(None, None, False, dist)
    if op.mesh is not None and op.mesh.size > 1:
        # the mesh fallback: no single-device kernel sees the whole panel
        return _Routes(None, None, False, None)
    fused = _fused_setup(op, Pl, Pr, n, dtype, orth_method, vdtype)
    mgs = _use_panel_mgs(n, dtype, orth_method, vdtype)
    panel_mv = None
    if fused is None and mgs:
        panel_mv = _stencil_panel_setup(op, Pl, Pr, n, dtype, orth_method,
                                        vdtype)
    return _Routes(fused, panel_mv, mgs, None)


def _new_cycle(r, m, dtype, vdtype, mesh=None, dist=None, V=None):
    """Panel and rotations of a cycle started from the (left-preconditioned)
    residual r (~ init!, src/gmres.jl:235-255), this rank's rows of it on a
    ``mesh``.  ``dist`` lays the panel out in its sharded blocks.  ``V`` is
    zeroed and reused when given (``gmres``'s own loop, which holds no
    earlier state)."""
    beta = norm(r, mesh)
    safe = torch.where(beta == 0, 1, beta)
    tail = dist.vtail if dist is not None else (r.shape[0],)
    if V is None:
        V = torch.zeros((m + 1, *tail), dtype=vdtype, device=r.device)
    else:
        V.zero_()
    V[0] = (dist.to_row(r / safe) if dist is not None
            else r / safe).to(vdtype)
    R = torch.zeros((m + 1, m), dtype=dtype, device=r.device)
    g = torch.zeros(m + 1, dtype=dtype, device=r.device)
    g[0] = beta
    cs = torch.ones(m, dtype=real_dtype(dtype), device=r.device)
    ss = torch.zeros(m, dtype=dtype, device=r.device)
    return V, R, g, cs, ss, beta


def _panel_update(y, Vm, out_dtype, dist=None):
    """x-update ``V^T y``.  On a bf16 panel, y is rounded to bf16 and the
    products are summed in f32 into an f32 result, as the JAX package's
    ``tensordot(..., preferred_element_type=f32)``: one ``addcmul`` per row,
    with no f32 copy of the panel.  In the sharded layout (``dist``) the
    rank's padded block is unpadded to its rows."""
    Vm = Vm.reshape(Vm.shape[0], -1)
    if Vm.dtype == y.dtype:
        upd = y @ Vm
    else:
        yv = y.to(Vm.dtype).to(out_dtype)
        upd = torch.zeros(Vm.shape[1], dtype=out_dtype, device=Vm.device)
        for j in range(Vm.shape[0]):
            upd.addcmul_(Vm[j], yv[j])
    return dist.row_to_vec(upd) if dist is not None else upd


def _make_step(op, Pl, Pr, m, dtype, orth_method, routes, maxiter=None,
               masked=False, in_place=False):
    """One Arnoldi expansion + incremental QR update, ``state -> state``.

    With ``masked=True`` the step runs unconditionally but every state
    write is gated on ``do = (residual > tol) & (kt < maxiter)``; a masked
    step is a no-op (the row write stores zeros, keeping the
    zero-beyond-k panel invariant), so a cycle runs ``restart`` steps with
    no host read.  With ``in_place`` the step writes the panel row and the
    residual log of the state it is given (``gmres``'s loop); otherwise it
    writes copies and leaves the given state unchanged (the iterator)."""
    dev = op.device
    idx1 = torch.arange(m + 1, device=dev)
    idxm = torch.arange(m, device=dev)
    pair = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)

    def step(s: GMRESState) -> GMRESState:
        k = s.k
        V = s.V if in_place else s.V.clone()
        if masked:
            do = (s.residual > s.tol) & (s.kt < maxiter)
        else:
            do = always
        if routes.fused is not None:
            h, nrm = fused_arnoldi(*routes.fused, V, k, do.to(torch.int32))
        elif routes.dist is not None:
            # sharded panel: the operator's own halo product on this rank's
            # rows, then distributed CGS2 (one allreduce a pass)
            dist = routes.dist
            row = V.index_select(0, k.reshape(1).long())[0]
            v = dist.row_to_vec(row).to(s.x.dtype)
            w = Pl.ldiv(op.mv(Pr.ldiv(v)))
            w, h, nrm = dist.ortho(V, w, k)
            w = torch.where(do, w, 0)
            V.index_copy_(0, (k + 1).reshape(1).long(), w.to(V.dtype)[None])
        else:
            if routes.panel_mv is not None:
                w = stencil_panel_mv(*routes.panel_mv, V, k)
            else:
                # expand! (src/gmres.jl:285-304): w = Pl^{-1} A Pr^{-1} v_k
                v = V.index_select(0, k.reshape(1).long())[0].to(s.x.dtype)
                w = Pl.ldiv(op.mv(Pr.ldiv(v)))
            if routes.mgs:
                h, nrm = panel_mgs(V, w.to(dtype), k, do.to(torch.int32))
            else:
                w, h, nrm = orthogonalize_and_normalize_rows(
                    V, w, orth_method, op.mesh)
                w = torch.where(do, w, 0)
                V.index_copy_(0, (k + 1).reshape(1).long(),
                              w.to(V.dtype)[None])
        at_k, at_k1, col_k = idx1 == k, idx1 == k + 1, idxm == k
        # Hessenberg column: h[0..k] + subdiagonal nrm at k+1
        hcol = torch.where(at_k1, nrm.to(dtype), h.to(dtype))
        # apply the stored rotations (identities beyond k) as one scan
        hcol = apply_givens_chain(s.cs, s.ss, hcol)
        kk = (k + pair).long()
        hk, hk1 = hcol.index_select(0, kk)
        c, sn, r = givens(hk, hk1)
        hcol = torch.where(at_k, r, torch.where(at_k1, 0, hcol))
        gk, gk1 = s.g.index_select(0, kk)
        gk, gk1 = apply_givens(c, sn, gk, gk1)
        residual = gk1.abs()
        # a masked step (do false) writes none of these
        if masked:
            at_k, at_k1, col_k = at_k & do, at_k1 & do, col_k & do
            residual = torch.where(do, residual, s.residual)
        R = torch.where(col_k, hcol[:, None], s.R)
        g = torch.where(at_k, gk, torch.where(at_k1, gk1, s.g))
        cs = torch.where(col_k, c.to(s.cs.dtype), s.cs)
        ss = torch.where(col_k, sn.to(s.ss.dtype), s.ss)
        inc = do.to(k.dtype)
        log = s.resnorm_log if in_place else s.resnorm_log.clone()
        slot = s.kt.clamp(max=log.shape[0] - 1).reshape(1).long()
        log.index_copy_(0, slot, torch.where(
            do, residual, log.index_select(0, slot)[0]).reshape(1))
        return s._replace(V=V, R=R, g=g, cs=cs, ss=ss, k=k + inc,
                          kt=s.kt + inc, residual=residual, resnorm_log=log)

    return step


def _gmres_init(op, b, x0, Pl, reltol, abstol, restart, maxiter,
                initially_zero, vdtype, dist=None):
    """The state before the first cycle (~ gmres_iterable!,
    src/gmres.jl:108-136)."""
    dtype = solve_dtype(op.dtype, b.dtype)
    x = x0.to(dtype)
    b = b.to(dtype)
    # initial (preconditioned) residual; skip the A*x when x0 == 0
    r = Pl.ldiv(b) if initially_zero else Pl.ldiv(b - op.mv(x))
    V, R, g, cs, ss, beta = _new_cycle(r.to(dtype), restart, dtype, vdtype,
                                       op.mesh, dist)
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=x.device)  # noqa: E731
    return GMRESState(
        x=x, V=V, R=R, g=g, cs=cs, ss=ss, k=i32(), kt=i32(), restarts=i32(),
        residual=beta, tol=tolerance(beta, reltol, abstol), stall=i32(),
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=real_dtype(dtype),
                                device=x.device),
    )


def _running(s: GMRESState, maxiter):
    return (s.kt < maxiter) & (s.residual > s.tol) & (s.stall < 2)


def _finalize(s: GMRESState, Pr, m, dtype, dist=None):
    """x after a cycle: the masked-length solve of the rotated system and
    ``x + Pr^{-1} V^T y``.  R and g froze exactly at convergence, V rows
    beyond k are zero and y is zero beyond k."""
    y = back_substitute(s.R[:m, :], s.g[:m], s.k)
    return s.x + Pr.ldiv(_panel_update(y, s.V[:m], dtype, dist))


@torch.no_grad()
@with_highest_precision
def _gmres_solve(op, b, x0, Pl, Pr, reltol, abstol, restart, maxiter,
                 initially_zero, orth_method, panel_dtype=None,
                 verbose=False, ir_stall_exit=True):
    """The cycle-granular loop (``_gmres_core`` of the JAX package).

    With ``panel_dtype=bfloat16`` (GMRES-IR mode) the Krylov panel is
    stored in bf16, halving the orthogonalization's memory traffic, while
    all arithmetic stays f32.  Each cycle starts from the true f32 residual
    of the f32 iterate, so the bf16 basis limits only per-cycle progress;
    because the in-cycle Givens estimate is bf16-limited, convergence is
    decided on the true residual computed at each cycle boundary."""
    dtype = solve_dtype(op.dtype, b.dtype)
    vdtype = panel_dtype if panel_dtype is not None else dtype
    ir = panel_dtype is not None and panel_dtype != dtype
    m = restart
    b = b.to(dtype)
    routes = _routes(op, Pl, Pr, op.shape[1], dtype, orth_method, vdtype)
    state = _gmres_init(op, b, x0, Pl, reltol, abstol, restart, maxiter,
                        initially_zero, vdtype, routes.dist)
    step = _make_step(op, Pl, Pr, m, dtype, orth_method, routes,
                      maxiter=maxiter, masked=True, in_place=True)
    zero = torch.zeros((), dtype=torch.int32, device=b.device)

    def cycle(s):
        # entry residual: in IR mode the cycle-start TRUE residual (set by
        # the previous fresh cycle); the in-cycle estimates only overwrite
        # it transiently
        beta_prev = s.residual
        for _ in range(m):
            s = step(s)
        x = _finalize(s, Pr, m, dtype, routes.dist)
        finished = (s.residual <= s.tol) | (s.kt >= maxiter)
        # unconditional fresh cycle (1 SpMV); if finished, the loop exits
        # and none of V/R/g/cs/ss is read again
        r = Pl.ldiv(b - op.mv(x)).to(dtype)
        V, R, g, cs, ss, beta = _new_cycle(r, m, dtype, vdtype, op.mesh,
                                           routes.dist, V=s.V)
        stall = s.stall
        if ir:
            # decide on the true residual; the estimate only freezes steps
            finished = (beta <= s.tol) | (s.kt >= maxiter)
            residual = beta
            if ir_stall_exit:
                # two consecutive cycles with < 0.1% true-residual
                # reduction exit the solve (converged stays False): the
                # bf16 basis floors the attainable per-cycle contraction
                progressed = beta < beta_prev * 0.999
                stall = torch.where(finished | progressed, zero, s.stall + 1)
        else:
            residual = torch.where(finished, s.residual, beta)
        return s._replace(
            x=x, V=V, R=R, g=g, cs=cs, ss=ss, k=zero,
            restarts=s.restarts + (~finished).to(s.restarts.dtype),
            residual=residual, stall=stall)

    verbose = verbose and (op.mesh is None or op.mesh.rank == 0)
    # the one host read of a cycle.  On a mesh every rank must take the same
    # branch, or the ranks' collectives no longer pair up and the run
    # deadlocks: the state it reads (residual, tol, kt, stall) is computed
    # from allreduced values only, so every rank holds the same bits.
    while bool(_running(state, maxiter)):
        kt0 = int(state.kt) if verbose else 0
        state = cycle(state)
        if verbose:
            # the cycle's residual estimates (the incremental-Givens
            # |g_{k+1}|, what the reference prints, src/gmres.jl:227)
            kt1 = int(state.kt)
            for i, v in enumerate(state.resnorm_log[kt0:kt1].tolist()):
                print(f"{kt0 + i + 1:3d}\t{v:.2e}")
    return SolveResult(
        x=state.x,
        iters=state.kt,
        converged=state.residual <= state.tol,
        resnorm=state.residual,
        log={"resnorm": (state.resnorm_log, state.kt)},
    ), state.restarts


def _prepare(A, b, x0, Pl, Pr, abstol, reltol, restart, maxiter,
             orth_method):
    op = as_operator(A, b)
    dev = op.device
    Pl = as_preconditioner(Pl, device=dev)
    Pr = as_preconditioner(Pr, device=dev)
    b = torch.as_tensor(b, device=dev)
    n = op.shape[1]
    restart = int(restart if restart is not None else min(20, n))
    maxiter = int(maxiter if maxiter is not None else n)
    orth_method = orth_method or "mgs"
    if orth_method not in ORTH_METHODS:
        raise ValueError(f"unknown orthogonalization method {orth_method!r}")
    dtype = solve_dtype(op.dtype, b.dtype)
    initially_zero = x0 is None
    if x0 is None:
        # b's rows: all n on one device, this rank's block on a mesh
        x0 = torch.zeros(b.shape[0], dtype=dtype, device=dev)
    else:
        x0 = torch.as_tensor(x0, device=dev)
    reltol_, abstol_ = resolve_tols(dtype, reltol, abstol, device=dev)
    return (op, b, x0, Pl, Pr, reltol_, abstol_, restart, maxiter,
            orth_method, dtype, initially_zero)


def gmres(
    A,
    b,
    *,
    x0=None,
    Pl=None,
    Pr=None,
    abstol: float | None = None,
    reltol: float | None = None,
    restart: int | None = None,
    maxiter: int | None = None,
    orth_method: str | None = None,
    panel_dtype="auto",
    ir_stall_exit: bool = True,
    log: bool = False,
    verbose: bool = False,
):
    """Solve A x = b with restarted GMRES(m) (~ gmres/gmres!,
    src/gmres.jl:143-233).  Stopping is on the *left-preconditioned*
    residual.  Returns ``x``, or ``(x, ConvergenceHistory)`` with
    ``log=True``.  The solve runs on the operator's device; a numpy or host
    ``b`` / ``x0`` is moved there.

    ``panel_dtype``: storage dtype of the Krylov basis.  ``torch.bfloat16``
    on an f32 problem runs mixed-precision GMRES-IR: the panel's memory
    traffic halves, all arithmetic stays f32, and convergence is decided on
    the true residual recomputed at each restart, so the attainable accuracy
    is unchanged; only the per-cycle contraction degrades.  ``None`` (or the
    solve's dtype) keeps a full-precision panel.  ``"auto"`` resolves to a
    full-precision panel on every device: the JAX package's rule picks bf16
    on a TPU from a TPU measurement, and the H100's own comparison is in
    PERF.md.

    ``ir_stall_exit``: in IR mode, exit after two consecutive restart
    cycles with < 0.1% true-residual reduction (``converged=False``)
    instead of burning the maxiter budget at the bf16 floor.  Set False for
    run-to-maxiter timing.

    ``verbose`` prints each step's residual estimate, a cycle's lines at the
    end of that cycle, where the loop reads the device anyway (the JAX
    package prints them live from inside its jitted loop).
    """
    orth_explicit = orth_method is not None
    (op, b, x0, Pl, Pr, reltol_, abstol_, restart, maxiter, orth_method,
     dtype, initially_zero) = _prepare(A, b, x0, Pl, Pr, abstol, reltol,
                                       restart, maxiter, orth_method)
    # surface a mesh-route substitution once, outside the loop
    _dist_panel_setup(op, op.shape[1], dtype, orth_method, warn=True,
                      explicit=orth_explicit)
    if isinstance(panel_dtype, str) and panel_dtype == "auto":
        panel_dtype = None
    if panel_dtype is not None:
        panel_dtype = as_dtype(panel_dtype)
        if panel_dtype == dtype:
            panel_dtype = None
        elif dtype != torch.float32 or panel_dtype != torch.bfloat16:
            raise ValueError(
                "panel_dtype supports only bfloat16 panels on float32 solves")
    res, restarts = _gmres_solve(
        op, b, x0, Pl, Pr, reltol_, abstol_, restart, maxiter,
        initially_zero, orth_method, panel_dtype, verbose=bool(verbose),
        ir_stall_exit=bool(ir_stall_exit))
    if not log:
        return res.x
    # mvps: 1 per inner iteration, 1 per executed cycle boundary (the
    # unconditional fresh cycle: restarts + the finishing cycle, which only
    # exists if the loop ran at all), and (0 or 1) for the initial residual
    restarts = int(restarts)
    ran_cycles = int(res.iters) > 0 or restarts > 0
    history = make_history(
        res,
        mv_per_iter=1.0,
        mv_initial=(0 if initially_zero else 1) + restarts + int(ran_cycles),
        restart=restart,
    )
    history["abstol"] = float(abstol_)
    history["reltol"] = float(reltol_)
    history.restarts = restarts
    return res.x, history


def gmres_iterator(
    A,
    b,
    *,
    x0=None,
    Pl=None,
    Pr=None,
    abstol: float | None = None,
    reltol: float | None = None,
    restart: int | None = None,
    maxiter: int | None = None,
    orth_method: str | None = None,
) -> SolverIterator:
    """Eager GMRES iterator (~ ``gmres_iterable!``, src/gmres.jl:108-136):
    yields the (lazily estimated) residual norm each inner iteration.
    ``.x`` is current only at restart/convergence boundaries, exactly like
    the reference (solution formed at restart, src/gmres.jl:82-103).

    A step leaves the state it was given unchanged (the ``SolverIterator``
    contract): it writes the new panel row into a copy of the panel, so each
    step copies the (m+1, n) panel; ``gmres`` itself writes in place.  The
    step reads back whether the cycle is over, once per step."""
    (op, b, x0, Pl, Pr, reltol_, abstol_, restart, maxiter, orth_method,
     dtype, initially_zero) = _prepare(A, b, x0, Pl, Pr, abstol, reltol,
                                       restart, maxiter, orth_method)
    m = restart
    b = b.to(dtype)
    routes = _routes(op, Pl, Pr, op.shape[1], dtype, orth_method, dtype)
    with torch.no_grad():
        state0 = _gmres_init(op, b, x0, Pl, reltol_, abstol_, m, maxiter,
                             initially_zero, dtype, routes.dist)
    arnoldi = _make_step(op, Pl, Pr, m, dtype, orth_method, routes)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        s = arnoldi(s)
        if not bool((s.k >= m) | (s.residual <= s.tol) | (s.kt >= maxiter)):
            return s
        x = _finalize(s, Pr, m, dtype, routes.dist)
        if bool((s.residual <= s.tol) | (s.kt >= maxiter)):
            return s._replace(x=x)
        r = Pl.ldiv(b - op.mv(x)).to(dtype)
        V, R, g, cs, ss, beta = _new_cycle(r, m, dtype, dtype, op.mesh,
                                           routes.dist)
        return s._replace(x=x, V=V, R=R, g=g, cs=cs, ss=ss,
                          k=torch.zeros_like(s.k),
                          restarts=s.restarts + 1, residual=beta)

    return SolverIterator(state0, step=step,
                          done=lambda s: ~_running(s, maxiter),
                          extract=lambda s: s.residual)
