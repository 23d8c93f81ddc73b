"""Textbook CG, one host decision a step.

It works in the dtype of ``b`` it is given and starts from x0 = 0.  It
stops where the recurrence residual ``|r_k| <= reltol * |b|`` or after
``maxiter`` steps, the rule of IterativeSolvers.jl ``src/cg.jl``.
"""

from __future__ import annotations

import torch


def cg(A, b, M=None, reltol: float = 0.0, maxiter: int | None = None):
    """(x, steps) of (preconditioned) CG on ``A x = b``; ``A`` and ``M``
    (``M^{-1}`` applied) are callables."""
    maxiter = b.numel() if maxiter is None else int(maxiter)
    x = torch.zeros_like(b)
    r = b.clone()
    u = torch.zeros_like(b)
    rho_prev = None
    res = float(torch.linalg.vector_norm(r))
    tol = reltol * res
    k = 0
    while k < maxiter and res > tol:
        c = r if M is None else M(r)
        rho = torch.dot(c, r)
        u = c if rho_prev is None else c + (rho / rho_prev) * u
        q = A(u)
        alpha = rho / torch.dot(u, q)
        x = x + alpha * u
        r = r - alpha * q
        rho_prev = rho
        res = float(torch.linalg.vector_norm(r))
        k += 1
    return x, k
