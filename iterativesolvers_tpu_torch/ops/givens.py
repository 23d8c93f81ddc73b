"""Givens rotations, complex-safe (port of ``iterativesolvers_tpu/ops/givens.py``;
the analogue of LAPACK's ``givensAlgorithm`` used by the reference,
src/hessenberg.jl:24).

Convention: ``givens(a, b) -> (c, s, r)`` with c real, s of a/b's dtype,
such that::

    [  c        s ] [a]   [r]
    [ -conj(s)  c ] [b] = [0]

Scalar work on 0-d tensors, on the solve's device: a solver step calls these
without reading anything back to the host.
"""

from __future__ import annotations

import torch

__all__ = ["givens", "apply_givens", "apply_givens_chain"]


def _conj(t):
    return t.conj() if t.is_complex() else t


def givens(a, b):
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    abs_a, abs_b = a.abs(), b.abs()
    d = torch.sqrt(abs_a * abs_a + abs_b * abs_b)
    safe_d = torch.where(d == 0, 1, d)
    safe_abs_a = torch.where(abs_a == 0, 1, abs_a)
    one = torch.ones((), dtype=dtype, device=a.device)
    sign_a = torch.where(abs_a == 0, one, a / safe_abs_a)
    c = torch.where(d == 0, 1, abs_a / safe_d)
    s = torch.where(d == 0, 0, torch.where(abs_a == 0, one,
                                           sign_a * _conj(b) / safe_d))
    r = torch.where(abs_a == 0, b, sign_a * d)
    r = torch.where(d == 0, 0, r)
    return c, s, r


def apply_givens(c, s, x, y):
    """Apply the rotation to a pair (x, y) -> (c*x + s*y, -conj(s)*x + c*y)."""
    return c * x + s * y, -_conj(s) * x + c * y


def apply_givens_chain(cs, ss, col):
    """Apply stored rotations G_0..G_{m-1} pairwise-sequentially to a new
    Hessenberg column, the incremental-QR update loop

        for j in 0..m-1:  (col[j], col[j+1]) = G_j (col[j], col[j+1])

    with no loop over j.  The carry ``t_{j+1} = -conj(s_j) t_j + c_j col[j+1]``
    is a first-order affine recurrence, so the chain is an inclusive scan of
    the affine maps ``(A_j, B_j) = (-conj(s_j), c_j col[j+1])``, here
    Hillis-Steele: ceil(log2 m) rounds of whole-vector ops in place of m
    rotations (the JAX package runs it as an ``associative_scan``).

    ``cs`` may be real while ``ss`` / ``col`` are complex; rotations beyond
    the active k must be identities (c = 1, s = 0), which make the recurrence
    a no-op there, as in the loop form."""
    m = cs.shape[0]
    h = col[1:]                       # col[j+1] for j = 0..m-1
    dtype = torch.promote_types(torch.promote_types(cs.dtype, ss.dtype),
                                col.dtype)
    A = (-_conj(ss)).to(dtype)
    B = cs.to(dtype) * h.to(dtype)
    d = 1
    while d < m:
        # (A, B)[i] <- (A, B)[i - d] then (A, B)[i]: x -> A_i (A_{i-d} x + B_{i-d}) + B_i
        A, B = (torch.cat([A[:d], A[:-d] * A[d:]]),
                torch.cat([B[:d], A[d:] * B[:-d] + B[d:]]))
        d *= 2
    t0 = col[:1].to(dtype)
    # t_0 = col[0]; t_j (j >= 1) = A_{0..j-1} t_0 + B_{0..j-1}
    t = torch.cat([t0, A * t0 + B])
    out = cs.to(dtype) * t[:-1] + ss.to(dtype) * h.to(dtype)
    return torch.cat([out, t[-1:]]).to(col.dtype)
