"""Preconditioner protocol and preconditioners (port of
``iterativesolvers_tpu/operators/preconditioners.py``).

Reference contract (docs/src/preconditioning.md:5-10): a preconditioner must
support ``ldiv!(y, P, x)`` — i.e. apply P^{-1}.  Here the protocol is a single
method ``ldiv(x) -> P^{-1} x`` on tensors.

``IdentityPreconditioner`` mirrors ``Identity`` (src/common.jl:28-32).  The
incomplete factorizations (``ILUPreconditioner``, ``ICPreconditioner``)
factor on the host (the native layer) and apply two level-scheduled
triangular sweeps (``ops/triangular.py``); the red-black ones
(``RedBlackICPreconditioner``, ``EisenstatSSOROperator``) apply masked
shifted multiply-adds over full-length vectors (:func:`shift_sum`).  Like
the JAX package, they read the device back only while they are built (the
symmetry and breakdown checks), never in an apply.
"""

from __future__ import annotations

import numpy as np
import torch

from .linear_operator import LinearOperator

__all__ = [
    "Preconditioner",
    "IdentityPreconditioner",
    "DiagonalPreconditioner",
    "DensePreconditioner",
    "FunctionPreconditioner",
    "ILUPreconditioner",
    "ICPreconditioner",
    "RedBlackICPreconditioner",
    "EisenstatSSOROperator",
    "shift_sum",
    "as_preconditioner",
    "is_identity",
]


class Preconditioner:
    def ldiv(self, x):
        raise NotImplementedError

    def ldiv_rows(self, Xr):
        """Apply to a (k, n) ROW panel (vectors as rows, the block solvers'
        layout).  Default: the single-vector apply row by row (the JAX
        package vmaps it); preconditioners with a native block form
        override it."""
        return torch.stack([self.ldiv(r) for r in Xr])

    def __call__(self, x):
        return self.ldiv(x)


class IdentityPreconditioner(Preconditioner):
    def ldiv(self, x):
        return x

    def ldiv_rows(self, Xr):
        return Xr


class DiagonalPreconditioner(Preconditioner):
    """Jacobi preconditioner: P = diag(d); ldiv divides elementwise."""

    def __init__(self, diag, device="cuda"):
        self.diag = torch.as_tensor(diag, device=device)

    def ldiv(self, x):
        return x / self.diag

    def ldiv_rows(self, Xr):
        return Xr / self.diag


class DensePreconditioner(Preconditioner):
    """Dense P, LU-factorized once at construction on ``device``
    (``torch.linalg.lu_factor``); ``ldiv`` is two triangular solves
    (``lu_solve``) in ``promote(P, x)``.  Matches the reference tests' use of
    exact factorizations as preconditioners (test/cg.jl:43-47)."""

    def __init__(self, mat=None, *, lu_and_piv=None, device="cuda"):
        if lu_and_piv is None:
            lu_and_piv = torch.linalg.lu_factor(
                torch.as_tensor(mat, device=device))
        self.lu_and_piv = lu_and_piv

    def ldiv(self, x):
        LU, piv = self.lu_and_piv
        dt = torch.promote_types(LU.dtype, x.dtype)
        b = x.to(dt)
        out = torch.linalg.lu_solve(LU.to(dt), piv,
                                    b[:, None] if b.ndim == 1 else b)
        return out[:, 0] if x.ndim == 1 else out

    def ldiv_rows(self, Xr):
        return self.ldiv(Xr.T).T


class FunctionPreconditioner(Preconditioner):
    """Matrix-free preconditioner from a callable x -> P^{-1} x."""

    def __init__(self, ldiv_fn, params=()):
        self._ldiv = ldiv_fn
        self.params = tuple(params)

    def ldiv(self, x):
        return self._ldiv(*self.params, x) if self.params else self._ldiv(x)


def as_preconditioner(P, device="cuda") -> Preconditioner:
    """Coerce ``None`` / a preconditioner / a callable / a 1-D array of the
    diagonal / a 2-D matrix (LU-factorized, :class:`DensePreconditioner`) to
    a :class:`Preconditioner`; an array goes to ``device``."""
    if P is None:
        return IdentityPreconditioner()
    if isinstance(P, Preconditioner):
        return P
    if callable(P) and not hasattr(P, "ndim") and not isinstance(P, LinearOperator):
        return FunctionPreconditioner(P)
    arr = P if isinstance(P, torch.Tensor) else torch.as_tensor(P)
    if arr.ndim == 1:
        return DiagonalPreconditioner(arr, device=device)
    if arr.ndim == 2:
        return DensePreconditioner(arr, device=device)
    raise ValueError(f"cannot interpret preconditioner of type {type(P)}")


def is_identity(P) -> bool:
    return P is None or isinstance(P, IdentityPreconditioner)


def shift_sum(offsets, streams, u, axis: int = 0):
    """``sum_o streams_o * shift(u, o)`` along ``axis`` (the length-n axis):
    ``acc[i] += streams_o[i] * u[i + o]`` where ``0 <= i + o < n``, term by
    term in the order of ``offsets``, each a multiply-add of slices into one
    accumulator of ``promote(u, streams)`` (the JAX package's one padded
    pass; reads past either end are its zero padding).  ``u`` is 1-D, or 2-D
    with the streams broadcast along the other axis."""
    n = u.shape[axis]
    dt = torch.promote_types(u.dtype, streams[0].dtype)
    acc = torch.zeros(u.shape, dtype=dt, device=u.device)
    for o, c in zip(offsets, streams):
        lo, hi = max(0, -o), min(n, n - o)
        if hi <= lo:
            continue
        cc = c[lo:hi]
        if u.ndim == 2:
            cc = cc[:, None] if axis == 0 else cc[None, :]
        acc.narrow(axis, lo, hi - lo).addcmul_(
            cc, u.narrow(axis, lo + o, hi - lo))
    return acc


def _shifted(v, o):
    """``v[i + o]`` with 0 where ``i + o`` falls outside ``[0, n)``."""
    out = torch.zeros_like(v)
    n = v.shape[0]
    if o >= 0:
        out[: n - o] = v[o:]
    else:
        out[-o:] = v[: n + o]
    return out


def _parity_red(n, axes, device):
    """(n,) bool: True where the sum of the grid coordinates is even; each
    axis ``(stride, extent)``."""
    i = torch.arange(n, device=device)
    p = torch.zeros(n, dtype=torch.int64, device=device)
    for s, e in axes:
        p += (i // s) % e
    return (p % 2) == 0


def _unit_step_dia(dia, side: int, dims: int):
    """Check the unit-step contract of a DIA matrix on a side^dims grid and
    return ``(n, offsets without 0, {offset: diagonal})``."""
    from .sparse import DIAMatrix

    if not isinstance(dia, DIAMatrix):
        raise TypeError("from_dia wraps a DIAMatrix")
    n = dia.shape[0]
    if side**dims != n:
        raise ValueError(f"side^dims = {side**dims} != n = {n}")
    strides = {side**k for k in range(dims)}
    offs = [o for o in dia.offsets if o != 0]
    if 0 not in dia.offsets or {abs(o) for o in offs} - strides:
        raise ValueError(
            "DIA offsets must be {0} U {+-side^k} (unit grid steps)")
    return n, offs, dict(zip(dia.offsets, dia.diags))


def _symmetric_partner(by_off, o, c):
    """Raise unless ``A[i, i+o] == A[i+o, i]`` on the stored streams (to
    rtol 1e-6 where ``c`` is nonzero; one host read, at construction)."""
    other = by_off.get(-o)
    if other is None:
        raise ValueError(f"offset {o} has no symmetric partner")
    c_T = torch.roll(other, -o)       # A[i+o, i] laid back onto row i
    if not torch.allclose(torch.where(c != 0, c_T, 0).to(c.dtype), c,
                          rtol=1e-6, atol=0):
        raise ValueError("DIA matrix is not symmetric")


def _multicolor_perm(csr):
    """Greedy-multicolor permutation of a CSR pattern: rows grouped by color
    (stable within a color).  An ILU(0)/IC(0) factor of the PERMUTED matrix
    has no fill, and rows of one color share no edge, so every row's
    triangular-solve dependencies sit in earlier colors — the level schedule
    of the factor collapses to <= ncolors parallel fronts (2 for red-black
    grids) instead of the O(n^{1/3}) anti-diagonal fronts natural ordering
    yields on 3-D stencils.  The permuted factorization is a (well-known)
    slightly weaker preconditioner per iteration; it exists to make the
    apply parallel."""
    from ..solvers.stationary import _color_classes

    color, nc = _color_classes(csr)
    perm = np.argsort(color, kind="stable").astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv, nc


def _host_csr(rows, cols, vals, n):
    """(indptr, indices, data) on the host of COO triplets, sorted and
    summed as ``CSRMatrix.from_coo`` sorts them (kept on the CPU)."""
    from .sparse import CSRMatrix

    m = CSRMatrix.from_coo(rows, cols, vals, (n, n), device="cpu")
    return m._host("indptr"), m._host("indices"), m._host("data")


def sorted_part(rows, cols, mask, n):
    """(indptr, int32 indices) of the entries ``mask`` keeps of a CSR
    matrix's row-sorted triplets: what ``CSRMatrix.from_coo`` of them gives
    (they stay sorted and distinct), without its sort."""
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[mask], minlength=n), out=indptr[1:])
    return indptr, cols[mask].astype(np.int32)


class _TriangularPair(Preconditioner):
    """``ldiv = U^{-1} L^{-1}`` by two level-scheduled sweeps, on the
    multicolor-permuted vector when a permutation is stored.  Both orderings
    return the promoted solve dtype (the sweeps promote x with the factor
    dtype), as the JAX package's ``ILUPreconditioner.ldiv`` does."""

    def __init__(self, lower_solve, upper_solve, perm=None, inv=None):
        self.lower_solve = lower_solve
        self.upper_solve = upper_solve
        dev = lower_solve.device
        self.perm = None if perm is None else torch.as_tensor(
            perm).to(device=dev, dtype=torch.int64)
        self.inv = None if inv is None else torch.as_tensor(
            inv).to(device=dev, dtype=torch.int64)

    @property
    def device(self):
        return self.lower_solve.device

    @property
    def nlevels(self):
        """Sequential fronts per triangular sweep (the apply's depth)."""
        return max(self.lower_solve.nlevels, self.upper_solve.nlevels)

    def _apply(self, x, axis):
        if self.perm is not None:
            x = torch.index_select(x, axis, self.perm)
        y = self.upper_solve.solve(self.lower_solve.solve(x))
        if self.perm is not None:
            y = torch.index_select(y, axis, self.inv)
        return y

    def ldiv(self, x):
        return self._apply(x, 0)

    def ldiv_rows(self, Xr):
        """The (k, n) row panel through the same two sweeps once (each level
        takes every row of the panel), not k separate applies."""
        return self._apply(Xr, 1)


class ILUPreconditioner(_TriangularPair):
    """ILU(0): incomplete LU with zero fill on A's sparsity pattern.

    The reference ships no incomplete factorizations (its docs point users
    at external ILU packages, docs/src/preconditioning.md; its tests build
    an inexact LU via ``lu(droptol!(...))``, test/idrs.jl:54-60).  The
    factorization runs once on the host (the native IKJ pass, its numpy
    version for complex); the apply is two level-scheduled triangular sweeps
    on the device, the same sweep the sparse Gauss-Seidel/SOR solvers use
    (ops/triangular.py).

    ``ordering="multicolor"`` factors the multicolor-permuted matrix instead
    (see ``_multicolor_perm``): the level count of the apply collapses to
    the color count, trading a few extra Krylov iterations for a parallel
    sweep.

    For matrices whose exact LU has no fill (e.g. tridiagonal), ILU(0) IS
    the exact factorization.  The ILU apply is nonsymmetric even for SPD A —
    use :class:`ICPreconditioner` with ``cg``/``minres``.  The factors live
    on ``device`` (default: the operator's).
    """

    @classmethod
    def from_operator(cls, A, ordering: str = "natural",
                      device=None) -> "ILUPreconditioner":
        from .. import native
        from ..ops.triangular import LevelScheduledTriangular
        from .sparse import CSRMatrix

        csr = A if isinstance(A, CSRMatrix) else A.to_csr()
        dev = csr.device if device is None else device
        n, m = csr.shape
        if n != m:
            raise ValueError("ILU(0) needs a square operator")
        perm = inv = None
        if ordering == "multicolor":
            perm, inv, _nc = _multicolor_perm(csr)
            csr = csr.permute(perm)
        elif ordering != "natural":
            raise ValueError(f"unknown ordering {ordering!r}")
        indptr = csr._host("indptr")
        indices = csr._host("indices")
        rows = csr._host("row_ids")
        f = native.ilu0(indptr, indices, csr._host("data"), n)

        lmask = indices < rows
        umask = indices > rows
        dmask = indices == rows
        lower = LevelScheduledTriangular.from_csr(
            *sorted_part(rows, indices, lmask, n), f[lmask],
            np.ones(n, f.dtype), lower=True, device=dev)
        upper = LevelScheduledTriangular.from_csr(
            *sorted_part(rows, indices, umask, n), f[umask],
            f[dmask], lower=False, device=dev)
        return cls(lower, upper, perm, inv)

    @classmethod
    def block_jacobi(cls, A, nblocks: int, device=None) -> "ILUPreconditioner":
        """Block-Jacobi ILU(0): drop every entry crossing a block boundary
        (contiguous row blocks of ~n/nblocks) and ILU(0)-factor the
        block-diagonal remainder.  The factorization decouples per block, so
        the level schedule runs all blocks' levels in parallel (weaker than
        global ILU(0) by the dropped couplings; with ``nblocks`` equal to
        the rank count, the apply of
        ``parallel.ShardedBlockJacobiPreconditioner``)."""
        from .sparse import CSRMatrix

        csr = A if isinstance(A, CSRMatrix) else A.to_csr()
        n = csr.shape[0]
        rows, cols, vals = csr._host_coo()
        bs = -(-n // int(nblocks))
        keep = (rows // bs) == (cols // bs)
        blockdiag = CSRMatrix.from_coo(rows[keep], cols[keep],
                                       csr.data.cpu()[torch.from_numpy(keep)],
                                       csr.shape, device="cpu")
        return cls.from_operator(blockdiag,
                                 device=csr.device if device is None
                                 else device)


class ICPreconditioner(_TriangularPair):
    """IC(0): incomplete Cholesky on the lower-triangular pattern of an SPD
    (or Hermitian positive-definite) A, applied as L^{-H} L^{-1} — a
    symmetric preconditioner safe for ``cg``/``minres``/``lobpcg``.
    Raises ``ZeroDivisionError`` on breakdown (non-positive pivot); shifted
    variants can be built by passing ``A + alpha*I``.

    ``ordering="multicolor"`` factors the multicolor-permuted matrix: the
    symmetric permutation preserves SPD-ness, and the apply's level count
    collapses to the color count (see :class:`ILUPreconditioner`)."""

    @classmethod
    def from_operator(cls, A, ordering: str = "natural",
                      device=None) -> "ICPreconditioner":
        from .. import native
        from ..ops.triangular import LevelScheduledTriangular
        from .sparse import CSRMatrix

        csr = A if isinstance(A, CSRMatrix) else A.to_csr()
        dev = csr.device if device is None else device
        n, m = csr.shape
        if n != m:
            raise ValueError("IC(0) needs a square operator")
        perm = inv = None
        if ordering == "multicolor":
            perm, inv, _nc = _multicolor_perm(csr)
            csr = csr.permute(perm)
        elif ordering != "natural":
            raise ValueError(f"unknown ordering {ordering!r}")
        indices = csr._host("indices")
        rows = csr._host("row_ids")
        vals = csr._host("data")
        keep = indices <= rows     # lower triangle incl. diagonal; CSR column
        lrows, lcols, lvals = rows[keep], indices[keep], vals[keep]
        lp = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(lrows, minlength=n), out=lp[1:])
        g = native.ic0(lp, lcols.astype(np.int32), lvals, n)

        strict = lcols < lrows
        gdiag = g[~strict]         # one per row, row order
        lower = LevelScheduledTriangular.from_csr(
            *sorted_part(lrows, lcols, strict, n), g[strict],
            gdiag, lower=True, device=dev)
        # L^H: transpose + conjugate of the strict part; diag is real
        upper = LevelScheduledTriangular.from_csr(
            *_host_csr(lcols[strict], lrows[strict], np.conj(g[strict]), n),
            gdiag, lower=False, device=dev)
        return cls(lower, upper, perm, inv)


class RedBlackICPreconditioner(Preconditioner):
    """GATHER-FREE IC(0) for symmetric axis-aligned stencil operators.

    In red-black (checkerboard) ordering, a unit-step stencil has no
    same-color couplings, so the IC(0) factor of the RB-ordered matrix has
    a closed form: red rows of L are purely diagonal (sqrt of the center),
    black rows couple only to red — the factorization AND both triangular
    solves reduce to masked SHIFTED READS of full-length vectors, the same
    access pattern as the stencil SpMV itself.  No host factorization, no
    level schedule, no gathers: the apply is two shifted passes
    (:func:`shift_sum`) and the elementwise work around them.

    Algebra (A = C·I + sum_o a_o S_o with S_o the masked unit shifts,
    parity(f+o) != parity(f) for every term):
      L_rr = sqrt(C)                       (red diagonal)
      L_br = a_o / sqrt(C)                 (black-red couplings)
      L_bb = sqrt(C - sum_o a_o^2 m_o / C) (black diagonal; m_o = Dirichlet
                                            mask — the only data computed)
    This IS the exact IC(0) of the RB-ordered matrix (equality with the
    native sequential ic0 factorization is tested), i.e. the multicolor
    variant of :class:`ICPreconditioner` specialized to stencils.

    Supports :class:`~.stencil.StencilOperator` whose terms are symmetric
    unit steps (|offset| == stride, matching +/- coefficients) and, through
    :meth:`from_dia`, unit-step symmetric DIA matrices.  ``shift`` adds
    ``shift*I`` to the operator before factorization.
    """

    def __init__(self, terms, mcs, center, s_inv, red):
        self.terms = terms          # ((offset, stride, extent), ...)
        self.mcs = mcs              # (n,) pre-masked coefficient per term
        self.center = center
        self.s_inv = s_inv          # (n,) 1/sqrt(diag of L)^2 pointwise
        self.red = red              # (n,) bool parity mask

    @property
    def device(self):
        return self.s_inv.device

    @classmethod
    def from_stencil(cls, st, shift: float = 0.0) -> "RedBlackICPreconditioner":
        from .stencil import StencilOperator

        if not isinstance(st, StencilOperator):
            raise TypeError("RedBlackICPreconditioner wraps a StencilOperator")
        n, dt, dev = st.n, st.dtype, st.device
        by_axis = {}
        for (o, s, e), c in zip(st.terms, st.coeffs):
            if abs(o) != s:
                raise ValueError(
                    f"term (offset={o}, stride={s}): only unit steps "
                    "(|offset| == stride) alternate parity")
            by_axis.setdefault((s, e), {})[int(np.sign(o))] = c
        for (s, e), pair in by_axis.items():
            if set(pair) != {-1, 1}:
                raise ValueError("stencil must have symmetric +/- terms")
            if float(pair[1]) != float(pair[-1]):
                raise ValueError("stencil must be symmetric (a_+o == a_-o)")
        i = torch.arange(n, device=dev)
        red = _parity_red(n, by_axis, dev)
        center = (torch.tensor(st.center, dtype=dt, device=dev)
                  + torch.tensor(shift, dtype=dt, device=dev))
        # e_black = C - sum_o a_o^2 m_o / C ; m_o masks off-grid neighbors;
        # mc_o = a_o m_o is stored as the per-term masked coefficient stream
        acc = torch.zeros(n, dtype=dt, device=dev)
        mcs = []
        for (o, s, e), c in zip(st.terms, st.coeffs):
            c = torch.tensor(c, dtype=dt, device=dev)
            pos = (i // s) % e
            step = o // s
            valid = (pos + step >= 0) & (pos + step < e)
            acc = acc + torch.where(valid, c * c, 0)
            mcs.append(torch.where(valid, c, 0).to(dt))
        e_vec = torch.where(red, center, center - acc / center)
        if bool((e_vec <= 0).any()):
            raise ZeroDivisionError(
                "red-black IC(0) breakdown: non-positive pivot; increase "
                "`shift`")
        return cls(st.terms, tuple(mcs), center, 1.0 / torch.sqrt(e_vec), red)

    @classmethod
    def from_dia(cls, dia, side: int, dims: int,
                 shift: float = 0.0) -> "RedBlackICPreconditioner":
        """Variable-coefficient form: the same closed-form RB IC(0) for a
        unit-step :class:`~.sparse.DIAMatrix` on a ``side^dims`` grid (the
        :func:`~..utils.fixtures.variable_diffusion` family).  The only
        change from :meth:`from_stencil` is that the coefficient streams and
        the center are per-row arrays, and the black pivot divides by the
        NEIGHBOR's center: ``e_b = D_b - sum_o a_o(b)^2 / D_{b+o}``."""
        n, offs, by_off = _unit_step_dia(dia, side, dims)
        d0 = by_off[0]
        center = d0 + torch.tensor(shift, dtype=d0.dtype, device=d0.device)
        strides = sorted({side**k for k in range(dims)})
        red = _parity_red(n, [(s, side) for s in strides], center.device)
        terms, mcs = [], []
        acc = torch.zeros(n, dtype=center.dtype, device=center.device)
        for o in offs:
            c = by_off[o].to(center.dtype)
            _symmetric_partner(by_off, o, c)
            terms.append((int(o), abs(int(o)), side))
            mcs.append(c)
            acc = acc + torch.where(c != 0, c * c / _shifted(center, o), 0)
        e_vec = torch.where(red, center, center - acc)
        if bool((e_vec <= 0).any()):
            raise ZeroDivisionError(
                "red-black IC(0) breakdown: non-positive pivot; increase "
                "`shift`")
        return cls(tuple(terms), tuple(mcs), center,
                   1.0 / torch.sqrt(e_vec), red)

    def _shift_sum(self, u, axis: int = 0):
        """sum_o mc_o * shift(u, o) along the length-n ``axis``."""
        return shift_sum([o for (o, _, _) in self.terms], self.mcs, u, axis)

    def _apply(self, x, axis):
        s, red = self.s_inv, self.red
        if x.ndim == 2:
            s, red = ((s[:, None], red[:, None]) if axis == 0
                      else (s[None, :], red[None, :]))
        # L solve: y_r = x_r s_r ; y_b = (x_b - sum_o a_o u[+o]) s_b with
        # u = y_r s_r at red slots (L_br = a_o s_r)
        u = torch.where(red, x * s * s, 0)
        y = torch.where(red, x * s, (x - self._shift_sum(u, axis)) * s)
        # L^T solve: z_b = y_b s_b ; z_r = (y_r - s_r sum_o a_o v[+o]) s_r
        # with v = z_b at black slots
        v = torch.where(red, 0, y * s)
        z = torch.where(red, (y - s * self._shift_sum(v, axis)) * s, y * s)
        return z.to(x.dtype)

    def ldiv(self, x):
        """P^{-1} x of a 1-D x or each column of an (n, k) x, in x's dtype."""
        return self._apply(x, 0)

    def ldiv_rows(self, Xr):
        """Native (k, n) row-panel apply: one shift pipeline over the whole
        block (vectors as rows, shifts along the minor axis)."""
        return self._apply(Xr, 1)


class EisenstatSSOROperator(LinearOperator):
    """Red-black SSOR(1)-preconditioned operator via **Eisenstat's trick**:
    the whole preconditioned matvec costs TWO gather-free masked shift
    passes — there is NO separate SpMV and no separate preconditioner
    apply.

    Algebra: on the diagonally scaled system ``Ã = D^{-1/2} A D^{-1/2} =
    I + E + E^T`` (E = the black-red strictly-lower block in red-black
    ordering), the SSOR(ω=1) preconditioned operator is

        Â = (I+E)^{-1} Ã (I+E^T)^{-1}        (SPD, a congruence)

    and with ``t = (I+E^T)^{-1} v`` Eisenstat's identity gives

        Â v = t + (I+E)^{-1} (v - t)

    where each inverse is DIRECT in red-black ordering (E couples black
    rows to red columns only): one masked shift pass each.

    Usage:

        Ahat = EisenstatSSOROperator.from_dia(A, side, dims)
        xhat = cg(Ahat, Ahat.rhs_transform(b), reltol=...)
        x = Ahat.solution_transform(xhat)

    No reference counterpart (the reference ships no preconditioners,
    docs/src/preconditioning.md:5-10).
    """

    def __init__(self, terms, mcs, s, red):
        self.terms = terms    # ((offset, stride, extent), ...)
        self.mcs = mcs        # scaled streams: e_o[i] = a_o(i) s[i] s[i+o]
        self.s = s            # (n,) D^{-1/2}
        self.red = red        # (n,) parity mask

    @property
    def shape(self):
        n = self.s.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.s.dtype

    @property
    def device(self):
        return self.s.device

    @classmethod
    def from_dia(cls, dia, side: int, dims: int) -> "EisenstatSSOROperator":
        """Build from a unit-step symmetric DIAMatrix on a side^dims grid
        (validates like :meth:`RedBlackICPreconditioner.from_dia`)."""
        n, offs, by_off = _unit_step_dia(dia, side, dims)
        center = by_off[0]
        if bool((center <= 0).any()):
            raise ZeroDivisionError("non-positive diagonal")
        s = 1.0 / torch.sqrt(center)
        strides = sorted({side**k for k in range(dims)})
        red = _parity_red(n, [(st, side) for st in strides], s.device)
        terms, mcs = [], []
        for o in offs:
            c = by_off[o].to(s.dtype)
            _symmetric_partner(by_off, o, c)
            terms.append((int(o), abs(int(o)), side))
            mcs.append(c * s * _shifted(s, o))
        return cls(tuple(terms), tuple(mcs), s, red)

    def _shift_sum(self, u):
        return shift_sum([o for (o, _, _) in self.terms], self.mcs, u)

    def _red(self, v):
        return self.red if v.ndim == 1 else self.red[:, None]

    def mv(self, v):
        red = self._red(v)
        # t = (I+E^T)^{-1} v: black rows pass through, red rows subtract
        # E^T v_black (the shifted pass reads black slots only — red slots
        # of the operand are zeroed)
        t = torch.where(red, v - self._shift_sum(torch.where(red, 0, v)), v)
        w = v - t                     # zero at black rows
        # (I+E)^{-1} w: red rows pass through, black rows subtract E w_red
        r = torch.where(red, w, -self._shift_sum(w))
        return t + r

    def rmv(self, v):
        return self.mv(v)             # symmetric

    def rhs_transform(self, b):
        """b -> (I+E)^{-1} D^{-1/2} b (one shift pass)."""
        sb = self.s * b
        return torch.where(self.red, sb,
                           sb - self._shift_sum(torch.where(self.red, sb, 0)))

    def solution_transform(self, xhat):
        """x_hat -> D^{-1/2} (I+E^T)^{-1} x_hat (one shift pass)."""
        t = torch.where(self.red,
                        xhat - self._shift_sum(torch.where(self.red, 0, xhat)),
                        xhat)
        return self.s * t
