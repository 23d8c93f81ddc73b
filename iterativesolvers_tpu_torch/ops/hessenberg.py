"""Hessenberg least-squares via Givens QR (port of
``iterativesolvers_tpu/ops/hessenberg.py``).

Functional analogue of ``FastHessenberg`` / ``ldiv!`` (src/hessenberg.jl:4-46):
solve ``min |H y - rhs|`` for an (m+1) x m Hessenberg H, leaving the residual
norm as ``|rhs[m]|`` after rotation.  Shapes are static (m = restart window);
the *active* column count ``k`` may be a 0-d tensor on the device.  Unused
columns of H must be zero (GMRES keeps its H buffer zero-initialized), so
rotations computed for them are identities and the back-substitution is
masked.
"""

from __future__ import annotations

import torch

from .givens import apply_givens, givens

__all__ = ["hessenberg_lstsq", "back_substitute"]


def back_substitute(R, g, k=None):
    """Solve R[:k,:k] y = g[:k] for upper-triangular R (m x m, zero-padded
    beyond k).  Returns y of length m with zeros beyond k.

    ``k`` may be a 0-d tensor: the masked system (unit diagonal and a zero
    right-hand side past k) is one triangular solve, with no host read."""
    m = R.shape[1]
    dtype = torch.promote_types(R.dtype, g.dtype)
    if k is None:
        k = m
    active = torch.arange(m, device=R.device) < k
    Rm = torch.where(active[:, None] & active[None, :], R.to(dtype), 0)
    Rm = Rm + torch.diag((~active).to(dtype))
    gm = torch.where(active, g.to(dtype), 0)
    return torch.linalg.solve_triangular(Rm, gm[:, None], upper=True)[:, 0]


def hessenberg_lstsq(H, rhs, k=None, method: str = "auto"):
    """min |H[:k+1,:k] y - rhs[:k+1]|.

    H: (m+1, m) Hessenberg with columns >= k zero.  rhs: (m+1,).
    Returns (y, residual) where y has length m (zeros beyond k) and
    residual = |rotated rhs[k]| (the reference leaves it in rhs[end],
    src/hessenberg.jl:40-46).

    ``method``: ``"dense"`` solves by one Householder QR of ``[H | rhs]`` +
    masked triangular solve, with the residual read from the rotated rhs;
    ``"givens"`` is the reference-shaped sequential Givens QR
    (src/hessenberg.jl:17-46).  ``"auto"`` picks dense, as the JAX package
    does (its choice was measured on a TPU; this scalar-sized solve is not on
    any hot path here).  GMRES never calls this: its rotations are
    incremental, one per iteration.
    """
    m = H.shape[1]
    if k is None:
        k = m
    if method == "auto":
        method = "dense"
    if method == "dense":
        # rows beyond k+1 of H[:, :k] are structurally zero (Hessenberg with
        # zero columns >= k), so they never influence y; mask rhs there so
        # they don't pollute the residual either.
        full = isinstance(k, int) and k == m
        rows = torch.arange(H.shape[0], device=H.device)
        rhs_m = rhs if full else torch.where(rows <= k, rhs, 0)
        # one Q-free QR of the augmented [H | rhs]: column m of R is Q^H rhs,
        # and its rows >= k hold the least-squares residual components
        _, Raug = torch.linalg.qr(torch.cat([H, rhs_m[:, None]], dim=1),
                                  mode="r")
        R = Raug[:m, :m]
        g_full = Raug[:, m]
        if full:
            y = torch.linalg.solve_triangular(R, g_full[:m, None],
                                              upper=True)[:, 0]
            return y, g_full[m].abs()
        # columns >= k of H are zero, hence so are those of R (incl. the
        # diagonal); put 1s there and zero the matching g rows so the
        # triangular solve returns exact y[:k] and y[k:] = 0
        col_act = torch.arange(m, device=H.device) < k
        R = R + torch.diag((~col_act).to(R.dtype))
        g = torch.where(col_act, g_full[:m], 0)
        y = torch.linalg.solve_triangular(R, g[:, None], upper=True)[:, 0]
        tail = torch.where(rows >= k, g_full, 0)
        residual = torch.sqrt(torch.sum(tail.conj() * tail).real)
        return y, residual
    if method != "givens":
        raise ValueError(f"unknown method {method!r}")

    R = H.clone()
    g = rhs.clone()
    cols = torch.arange(m, device=H.device)
    for j in range(m):
        # zero sub-diagonal entry j+1 of column j with one new rotation;
        # previous rotations were already applied column-by-column below.
        c, s, r = givens(R[j, j], R[j + 1, j])
        R[j, j] = r
        R[j + 1, j] = 0
        gj, gj1 = apply_givens(c, s, g[j], g[j + 1])
        g[j], g[j + 1] = gj, gj1
        # apply this rotation to the remaining columns' rows (j, j+1)
        rowj, rowj1 = apply_givens(c, s, R[j, :], R[j + 1, :])
        later = cols > j
        R[j, :], R[j + 1, :] = (torch.where(later, rowj, R[j, :]),
                                torch.where(later, rowj1, R[j + 1, :]))
    y = back_substitute(R[:m, :], g[:m], k)
    kk = torch.clamp(torch.as_tensor(k, device=H.device), max=m)
    return y, g.index_select(0, kk.reshape(1).long())[0].abs()
