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

With a ``mesh`` (a row-sharded operator's ``mesh``, ``parallel/sharded.py``)
the basis rows and ``w`` are this rank's block of rows: every projection
``V^H w`` and every norm of ``w`` is a rank-local product followed by one
``mesh.all_reduce``, so every rank holds the same coefficients and takes the
same DGKS branch.  GMRES takes this form on a mesh where its sharded-panel
CGS2 route does not apply ('dgks', complex dtypes).
"""

from __future__ import annotations

import math

import torch

from ..solvers.common import norm, vdot

__all__ = ["orthogonalize_and_normalize", "orthogonalize_and_normalize_rows",
           "mgs_rows", "ORTH_METHODS"]

ORTH_METHODS = ("mgs", "cgs", "cgs2", "dgks")
_DGKS_ETA = 1.0 / math.sqrt(2.0)  # src/orthogonalize.jl:19 ("used by ARPACK")
# "twice is enough": the reference notes the DGKS condition "is true only
# once" typically (src/orthogonalize.jl:24-25); two capped repeats cover it
_DGKS_MAX_REPEATS = 2


def mgs_rows(Vt, w, k=None, mesh=None):
    """MGS of ``w`` against the rows of ``Vt`` in order, in w's dtype (each
    row is widened before it meets the 0-d ``h_j``, since torch would round
    ``h_j * v_j`` to the row's dtype); returns ``(w, h)``.  With ``k`` (an
    int or a 0-d tensor) a row past k leaves w as it is and gets ``h = 0``,
    whatever it holds: the masked sweep of the panel-MGS kernel's plain
    version (``ops/cuda_mgs.py``), on the same bits as the unmasked one.
    With a ``mesh`` each ``h_j`` is allreduced (one allreduce a row)."""
    active = (None if k is None
              else torch.arange(Vt.shape[0], device=Vt.device) <= k)
    hs = []
    for j in range(Vt.shape[0]):
        vj = Vt[j].to(w.dtype)
        hj = vdot(vj, w, mesh)
        if active is None:
            w = w - hj * vj
        else:
            hj = torch.where(active[j], hj, 0)
            w = torch.where(active[j], w - hj * vj, w)
        hs.append(hj)
    h = torch.stack(hs) if hs else w.new_zeros(0)
    return w, h


def _reduced(h, mesh):
    return h if mesh is None else mesh.all_reduce(h)


def _project_cgs(V, w, mesh=None):
    h = _reduced(V.conj().T @ w, mesh)
    return h, w - V @ h


def _project_cgs_rows(Vt, w, mesh=None):
    """CGS against the ROWS of a (m, n) panel: two matvecs."""
    h = _reduced(Vt.conj() @ w, mesh)
    return h, w - h @ Vt


def _dgks_loop(project, w, h, mesh=None):
    """DGKS conditional re-orthogonalization (src/orthogonalize.jl:22-33):
    repeat CGS while ``norm(w) < eta * norm(latest correction)``, the
    comparison against the LATEST correction's size (the reference updates
    ``projection_size`` inside the loop), initially ``norm(h)``.

    Masked form: every repeat up to the cap runs, and one the criterion
    would have skipped changes nothing (``torch.where`` on each value), so
    the loop reads nothing back to the host.  The coefficients ``h`` are
    replicated on a ``mesh``; only the norms of ``w`` are reduced."""
    nrm = norm(w, mesh)
    proj = norm(h)
    active = nrm < _DGKS_ETA * proj
    for _ in range(_DGKS_MAX_REPEATS):
        corr, w2 = project(w)
        nrm2 = norm(w2, mesh)
        w = torch.where(active, w2, w)
        h = torch.where(active, h + corr, h)
        nrm = torch.where(active, nrm2, nrm)
        proj = torch.where(active, norm(corr), proj)
        active = active & (nrm < _DGKS_ETA * proj)
    return w, h


def _normalize(w, h, mesh=None):
    nrm = norm(w, mesh)
    safe = torch.where(nrm == 0, 1, nrm)
    return w / safe, h, nrm


def _orthogonalize(project, mgs, w, method, mesh):
    """The four methods over one layout: ``project(w)`` is a CGS pass
    returning ``(h, w)``, ``mgs(w)`` an MGS sweep returning ``(w, h)``."""
    if method == "mgs":
        w, h = mgs(w)
    elif method == "cgs":
        h, w = project(w)
    elif method == "cgs2":
        h, w = project(w)
        h2, w = project(w)
        h = h + h2
    elif method == "dgks":
        h, w = project(w)
        w, h = _dgks_loop(project, w, h, mesh)
    else:
        raise ValueError(f"unknown orthogonalization method {method!r}")
    return _normalize(w, h, mesh)


def orthogonalize_and_normalize_rows(Vt, w, method: str = "mgs", mesh=None):
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
    return _orthogonalize(lambda v: _project_cgs_rows(Vt, v, mesh),
                          lambda v: mgs_rows(Vt, v, mesh=mesh), w, method,
                          mesh)


def orthogonalize_and_normalize(V, w, method: str = "mgs", mesh=None):
    """Column-panel variant, the public API analogue of the reference's
    ``orthogonalize_and_normalize!(V, w, h, method)``
    (src/orthogonalize.jl:1-11), for user code that keeps a basis as (n, m)
    columns.  GMRES uses :func:`orthogonalize_and_normalize_rows`."""
    dtype = torch.promote_types(V.dtype, w.dtype)
    w = w.to(dtype)
    if method != "mgs":
        V = V.to(dtype)
    return _orthogonalize(lambda v: _project_cgs(V, v, mesh),
                          lambda v: mgs_rows(V.T, v, mesh=mesh), w, method,
                          mesh)
