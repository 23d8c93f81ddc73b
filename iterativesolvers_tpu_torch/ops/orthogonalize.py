"""Orthogonalization (port of ``iterativesolvers_tpu/ops/orthogonalize.py``,
the analogue of src/orthogonalize.jl).

``orthogonalize_and_normalize(V, w, method)`` orthogonalizes ``w`` against the
columns of ``V`` and normalizes it, returning ``(w, h, nrm)`` with
``w_original = V h + nrm * w``.

The basis has a fixed column count (the restart/window size); inactive
columns must be zero, so their coefficients vanish naturally.  Methods:

  * ``"mgs"``  — modified Gram-Schmidt, column-wise dots (src/orthogonalize.jl:67-79).
    Default, like the reference.  Sequential in the column index; one body,
    :func:`mgs_rows`, for both layouts and the panel kernel's plain version.
  * ``"cgs"``  — classical Gram-Schmidt: two tall-skinny GEMVs
    (src/orthogonalize.jl:41-51).
  * ``"dgks"`` — CGS with conditional re-orthogonalization while
    ``nrm < eta * norm(latest correction)`` with eta = 1/sqrt(2), the ARPACK
    constant (src/orthogonalize.jl:15-39); a masked loop with a capped
    repeat count, so no host read decides a repeat.
  * ``"cgs2"`` — CGS with one unconditional re-orthogonalization pass
    ("twice is enough"; DGKS stability class without the data-dependent
    gate).
"""

from __future__ import annotations

import math

import torch

from ..solvers.common import norm

__all__ = ["orthogonalize_and_normalize", "orthogonalize_and_normalize_rows",
           "mgs_rows", "ORTH_METHODS"]

ORTH_METHODS = ("mgs", "cgs", "cgs2", "dgks")
_DGKS_ETA = 1.0 / math.sqrt(2.0)  # src/orthogonalize.jl:19 ("used by ARPACK")
# "twice is enough": the reference notes the DGKS condition "is true only
# once" typically (src/orthogonalize.jl:24-25); two capped repeats cover it
_DGKS_MAX_REPEATS = 2


def mgs_rows(Vt, w, k=None):
    """MGS of ``w`` against the rows of ``Vt`` in order, in w's dtype (each
    row is widened before it meets the 0-d ``h_j``, since torch would round
    ``h_j * v_j`` to the row's dtype); returns ``(w, h)``.  With ``k`` (an
    int or a 0-d tensor) a row past k leaves w as it is and gets ``h = 0``,
    whatever it holds: the masked sweep of the panel-MGS kernel's plain
    version (``ops/cuda_mgs.py``), on the same bits as the unmasked one."""
    active = (None if k is None
              else torch.arange(Vt.shape[0], device=Vt.device) <= k)
    hs = []
    for j in range(Vt.shape[0]):
        vj = Vt[j].to(w.dtype)
        hj = torch.sum(vj.conj() * w)
        if active is None:
            w = w - hj * vj
        else:
            hj = torch.where(active[j], hj, 0)
            w = torch.where(active[j], w - hj * vj, w)
        hs.append(hj)
    h = torch.stack(hs) if hs else w.new_zeros(0)
    return w, h


def _project_cgs(V, w):
    h = V.conj().T @ w
    return h, w - V @ h


def _project_cgs_rows(Vt, w):
    """CGS against the ROWS of a (m, n) panel: two matvecs."""
    h = Vt.conj() @ w
    return h, w - h @ Vt


def _dgks_loop(project, w, h):
    """DGKS conditional re-orthogonalization (src/orthogonalize.jl:22-33):
    repeat CGS while ``norm(w) < eta * norm(latest correction)``, the
    comparison against the LATEST correction's size (the reference updates
    ``projection_size`` inside the loop), initially ``norm(h)``.

    Masked form: every repeat up to the cap runs, and one the criterion
    would have skipped changes nothing (``torch.where`` on each value), so
    the loop reads nothing back to the host."""
    nrm = norm(w)
    proj = norm(h)
    active = nrm < _DGKS_ETA * proj
    for _ in range(_DGKS_MAX_REPEATS):
        corr, w2 = project(w)
        nrm2 = norm(w2)
        w = torch.where(active, w2, w)
        h = torch.where(active, h + corr, h)
        nrm = torch.where(active, nrm2, nrm)
        proj = torch.where(active, norm(corr), proj)
        active = active & (nrm < _DGKS_ETA * proj)
    return w, h


def _normalize(w, h):
    nrm = norm(w)
    safe = torch.where(nrm == 0, 1, nrm)
    return w / safe, h, nrm


def orthogonalize_and_normalize_rows(Vt, w, method: str = "mgs"):
    """Row-panel variant: the basis is stored as (m, n), rows are the Krylov
    vectors (GMRES's panel).  Inactive rows are zero, so full-panel ops stay
    exact.  MGS runs over every row, each step a contiguous-row dot + axpy.
    A panel stored in a narrower dtype than w (bf16 on an f32 solve) is
    computed in w's dtype, as in JAX: each row is widened before it meets
    the 0-d ``h_j``, since torch would round ``h_j * v_j`` to the row's
    dtype."""
    w = w.to(torch.promote_types(Vt.dtype, w.dtype))
    if method != "mgs":
        Vt = Vt.to(w.dtype)
    if method == "mgs":
        w, h = mgs_rows(Vt, w)
    elif method == "cgs":
        h, w = _project_cgs_rows(Vt, w)
    elif method == "cgs2":
        h, w = _project_cgs_rows(Vt, w)
        h2, w = _project_cgs_rows(Vt, w)
        h = h + h2
    elif method == "dgks":
        h, w = _project_cgs_rows(Vt, w)
        w, h = _dgks_loop(lambda v: _project_cgs_rows(Vt, v), w, h)
    else:
        raise ValueError(f"unknown orthogonalization method {method!r}")
    return _normalize(w, h)


def orthogonalize_and_normalize(V, w, method: str = "mgs"):
    """Column-panel variant, the public API analogue of the reference's
    ``orthogonalize_and_normalize!(V, w, h, method)``
    (src/orthogonalize.jl:1-11), for user code that keeps a basis as (n, m)
    columns.  GMRES uses :func:`orthogonalize_and_normalize_rows`."""
    dtype = torch.promote_types(V.dtype, w.dtype)
    w = w.to(dtype)
    if method != "mgs":
        V = V.to(dtype)
    if method == "mgs":
        w, h = mgs_rows(V.T, w)
    elif method == "cgs":
        h, w = _project_cgs(V, w)
    elif method == "cgs2":
        h, w = _project_cgs(V, w)
        h2, w = _project_cgs(V, w)
        h = h + h2
    elif method == "dgks":
        h, w = _project_cgs(V, w)
        w, h = _dgks_loop(lambda v: _project_cgs(V, v), w, h)
    else:
        raise ValueError(f"unknown orthogonalization method {method!r}")
    return _normalize(w, h)
