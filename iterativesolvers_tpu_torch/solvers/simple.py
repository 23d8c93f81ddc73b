"""Simple eigensolvers: (shifted / inverse) power method — port of
``iterativesolvers_tpu/solvers/simple.py``.

Per iteration (src/simple.jl:28-48):

    Ax = B x
    theta = <x, Ax>          (Rayleigh quotient)
    r = Ax - theta x;  residual = |r|
    x = Ax / |Ax|

Shift-and-invert (src/simple.jl:50-51,85-90): the user passes an operator B
with the action of ``(A - shift I)^{-1}``; the returned eigenvalue is
transformed back as ``shift + 1/theta`` (``shift + theta`` when not
inverted).

Defaults mirror the reference: ``tol = eps(real(T)) * n^3``,
``maxiter = size(B, 2)`` (src/simple.jl:53,120); the allocating form starts
from a random complex unit vector (src/simple.jl:64-68), here drawn from a
``torch.Generator`` (``key``; None: seeded 0 on the operator's device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..operators.linear_operator import as_operator
from ..utils.dtypes import eps, real_dtype
from .common import (SolveResult, SolverIterator, live_print, log_at,
                     make_history, norm, run_chunked, select, vdot,
                     with_highest_precision)

__all__ = ["powm", "invpowm", "powm_iterator"]


class PowerState(NamedTuple):
    x: torch.Tensor
    theta: torch.Tensor
    residual: torch.Tensor
    k: torch.Tensor
    resnorm_log: torch.Tensor


def _power_init(x0, maxiter):
    rt = real_dtype(x0.dtype)
    dev = x0.device
    return PowerState(
        x=x0,
        theta=torch.zeros((), dtype=x0.dtype, device=dev),
        residual=torch.tensor(torch.finfo(rt).max, dtype=rt, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        # done is ``k > maxiter`` (src/simple.jl:26) so up to maxiter + 1
        # steps run and the final residual lands at index maxiter
        resnorm_log=torch.zeros((maxiter + 1,), dtype=rt, device=dev),
    )


def _power_step(op, state: PowerState, live=None,
                log_in_place=False) -> PowerState:
    """One power step, masked by ``live`` as ``minres._minres_step``."""
    Ax = op.mv(state.x)
    theta = vdot(state.x, Ax, op.mesh)
    residual = norm(Ax - theta * state.x, op.mesh)
    new = PowerState(
        x=Ax / norm(Ax, op.mesh),
        theta=theta.to(state.theta.dtype),
        residual=residual,
        k=state.k + 1,
        resnorm_log=log_at(state.resnorm_log, state.k, residual, live,
                           log_in_place))
    return select(live, new, state)


def _power_done(state: PowerState, tol, maxiter: int):
    # reference: done when iteration > maxiter || residual <= tol
    # (src/simple.jl:26); the residual is from the *previous* x
    return (state.k > maxiter) | (state.residual <= tol)


@torch.no_grad()
@with_highest_precision
def _power_solve(op, x0, tol, maxiter, verbose, chunk=256):
    final = run_chunked(
        lambda s, live: _power_step(op, s, live, log_in_place=True),
        lambda s: _power_done(s, tol, maxiter),
        _power_init(x0, maxiter), chunk=chunk,
        on_phase=live_print(lambda s: (s.resnorm_log, s.k)) if verbose
        else None)
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= tol,
        resnorm=final.residual,
        log={"resnorm": (final.resnorm_log, final.k)},
    ), final.theta


def _default_x0(op, generator):
    """Random complex unit start vector (src/simple.jl:64-68): normal real
    and imaginary parts from ``generator``."""
    rt = real_dtype(op.dtype)
    n = op.shape[0]
    dev = generator.device
    re = torch.randn(n, generator=generator, dtype=rt, device=dev)
    im = torch.randn(n, generator=generator, dtype=rt, device=dev)
    x0 = torch.complex(re, im)
    return x0 / norm(x0)


def _tol(op, tol):
    return eps(op.dtype) * op.shape[1] ** 3 if tol is None else tol


def powm(
    B,
    *,
    x0=None,
    shift=0.0,
    inverse: bool = False,
    tol: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    verbose: bool = False,
    key=None,
    chunk: int = 256,
):
    """Approximate the dominant eigenpair of ``B`` by power iteration.

    Mirrors ``powm`` / ``powm!`` (src/simple.jl:58-68,113-169).  With
    ``inverse=True`` and ``shift=sigma``, ``B`` must act as
    ``(A - sigma I)^{-1}`` and the returned eigenvalue is an eigenvalue of A.
    ``key``: the ``torch.Generator`` of the random start (no ``x0``).
    ``chunk``: as ``cg``'s.

    Returns ``(lam, x)`` or ``(lam, x, history)`` when ``log=True``.
    """
    op = as_operator(B, x0)
    if x0 is None:
        if key is None:
            key = torch.Generator(device=op.device).manual_seed(0)
        x0 = _default_x0(op, key)
    x0 = torch.as_tensor(x0, device=op.device)
    tol = _tol(op, tol)
    maxiter = int(maxiter if maxiter is not None else op.shape[1])
    res, theta = _power_solve(
        op, x0, torch.tensor(tol, dtype=real_dtype(x0.dtype),
                             device=op.device),
        maxiter, bool(verbose), chunk=int(chunk))
    lam = shift + (1.0 / theta if inverse else theta)
    if not log:
        return lam, res.x
    history = make_history(res, mv_per_iter=1.0, mv_initial=0)
    history["tol"] = float(tol)
    return lam, res.x, history


def invpowm(B, *, shift=0.0, **kwargs):
    """Inverse power iteration (~ ``invpowm(!)``, src/simple.jl:171-185):
    ``B`` must act as ``(A - shift I)^{-1}``; finds the eigenvalue of A
    closest to ``shift``."""
    return powm(B, shift=shift, inverse=True, **kwargs)


def powm_iterator(B, x0, *, tol: float | None = None,
                  maxiter: int | None = None) -> SolverIterator:
    """Eager power-method iterator (~ ``powm_iterable!``,
    src/simple.jl:53-55): yields the residual norm; ``.state.theta`` holds
    the Rayleigh quotient."""
    op = as_operator(B, x0)
    x0 = torch.as_tensor(x0, device=op.device)
    tol_ = torch.tensor(_tol(op, tol), dtype=real_dtype(x0.dtype),
                        device=op.device)
    maxiter = int(maxiter if maxiter is not None else op.shape[0])

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _power_step(op, s)

    return SolverIterator(_power_init(x0, maxiter), step=step,
                          done=lambda s: _power_done(s, tol_, maxiter),
                          extract=lambda s: s.residual)
