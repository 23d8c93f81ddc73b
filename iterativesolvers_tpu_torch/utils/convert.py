"""Operator data carried across from the JAX package.

The port's counterpart of loading a model's weights: an operator of the JAX
package is taken apart into numpy arrays and Python tuples (for example
``np.asarray(A.diags[k])``, ``A.offsets``, ``St.terms``,
``float(St.center)``) and rebuilt here on ``device``, or row-sharded on a
mesh of ranks (``parallel/sharded.py``).  The preconditioners and the
reduced red-black system are carried across the same way, from the arrays
the JAX package built (its level schedules, factors and shift streams), so
the port applies the JAX package's own factorization.  Nothing of the JAX
package is imported: the caller hands over plain data.  Values keep their
dtype (an ``ml_dtypes`` bfloat16 array becomes a bfloat16 tensor); index
arrays are stored as the formats store them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..operators.linear_operator import ScaledIdentityPlusOperator
from ..operators.preconditioners import (EisenstatSSOROperator,
                                         ICPreconditioner, ILUPreconditioner,
                                         RedBlackICPreconditioner)
from ..operators.rb_reduce import RBReducedSystem
from ..operators.sparse import (BSRMatrix, CSRMatrix, DIAMatrix, ELLMatrix,
                                HYBMatrix)
from ..operators.stencil import GradientOperator, StencilOperator
from ..ops.triangular import LevelScheduledTriangular
from .dtypes import host_tensor

__all__ = ["dia_from_arrays", "stencil_from_arrays", "csr_from_arrays",
           "ell_from_arrays", "hyb_from_arrays", "bsr_from_arrays",
           "operator_from_arrays", "halo_dia_from_arrays",
           "halo_stencil_from_arrays", "row_sharded_ell_from_arrays",
           "dense_mesh_from_arrays", "triangular_from_arrays",
           "factors_from_arrays", "rbic_from_arrays",
           "eisenstat_from_arrays", "rb_reduced_from_arrays", "host_tensor"]

KINDS = ("dia", "stencil", "gradient", "scaled_identity_plus", "csr", "ell",
         "hyb", "bsr", "dense", "triangular", "ilu", "ic", "rbic",
         "eisenstat", "rb_reduced")


def dia_from_arrays(diags, offsets, shape, device="cuda") -> DIAMatrix:
    """A :class:`DIAMatrix` from a sequence of 1-D host arrays (one per
    offset), the offsets and the shape.  The values keep their dtype."""
    return DIAMatrix([host_tensor(d) for d in diags],
                     tuple(int(o) for o in offsets), tuple(shape),
                     device=device)


def csr_from_arrays(data, indices, indptr, shape, device="cuda") -> CSRMatrix:
    """A :class:`CSRMatrix` from its values, column indices and row
    pointers (the JAX operator's ``data``, ``indices``, ``indptr``)."""
    return CSRMatrix(host_tensor(data), np.asarray(indices),
                     np.asarray(indptr), tuple(shape), device=device)


def ell_from_arrays(data, cols, shape, adj=None, gather_chunk_rows=None,
                    device="cuda") -> ELLMatrix:
    """An :class:`ELLMatrix` from its (n, w) values and columns; ``adj``,
    the keys of this function for a precomputed adjoint, or None."""
    if adj is not None:
        adj = ell_from_arrays(device=device, **adj)
    return ELLMatrix(host_tensor(data), np.asarray(cols), tuple(shape),
                     adj=adj, gather_chunk_rows=gather_chunk_rows,
                     device=device)


def hyb_from_arrays(ell, tail_rows, tail_cols, tail_vals, shape, adj=None,
                    device="cuda") -> HYBMatrix:
    """A :class:`HYBMatrix` from its ELL part (the keys of
    :func:`ell_from_arrays`), its COO tail and shape; ``adj``, the keys of
    this function for a precomputed adjoint, or None."""
    if adj is not None:
        adj = hyb_from_arrays(device=device, **adj)
    return HYBMatrix(ell_from_arrays(device=device, **ell),
                     np.asarray(tail_rows), np.asarray(tail_cols),
                     host_tensor(tail_vals), tuple(shape), adj=adj)


def bsr_from_arrays(blocks, block_cols, block_row_ids, shape,
                    device="cuda") -> BSRMatrix:
    """A :class:`BSRMatrix` from its (nblk, bs, bs) blocks and their block
    columns and block rows."""
    return BSRMatrix(host_tensor(blocks), np.asarray(block_cols),
                     np.asarray(block_row_ids), tuple(shape), device=device)


def stencil_from_arrays(n, center, terms, coeffs, dtype,
                        device="cuda") -> StencilOperator:
    """A :class:`StencilOperator` from its row count, center coefficient,
    (offset, stride, extent) terms, per-term coefficients and dtype."""
    return StencilOperator(
        int(n), _scalar(center), tuple(tuple(int(v) for v in t) for t in terms),
        tuple(_scalar(c) for c in coeffs), dtype=dtype, device=device)


def halo_dia_from_arrays(diags, offsets, shape, mesh):
    """A row-sharded ``HaloDIAOperator`` on ``mesh`` from the whole
    matrix's host arrays (as :func:`dia_from_arrays`): each rank keeps its
    rows, on its device, and the whole matrix never goes to a card."""
    from ..parallel.sharded import HaloDIAOperator

    return HaloDIAOperator(dia_from_arrays(diags, offsets, shape,
                                           device="cpu"), mesh)


def halo_stencil_from_arrays(n, center, terms, coeffs, dtype, mesh):
    """A row-sharded ``HaloStencilOperator`` on ``mesh`` from the data of
    :func:`stencil_from_arrays`."""
    from ..parallel.sharded import HaloStencilOperator

    return HaloStencilOperator(
        stencil_from_arrays(n, center, terms, coeffs, dtype,
                            device=mesh.device), mesh)


def row_sharded_ell_from_arrays(data, cols, shape, mesh, adj=None,
                                gather_chunk_rows=None):
    """A ``RowShardedELLOperator`` on ``mesh`` from the keys of
    :func:`ell_from_arrays` (``adj`` for a precomputed adjoint): each rank
    keeps its rows."""
    from ..parallel.sharded import RowShardedELLOperator

    return RowShardedELLOperator(
        ell_from_arrays(data, cols, shape, adj=adj,
                        gather_chunk_rows=gather_chunk_rows, device="cpu"),
        mesh)


def dense_mesh_from_arrays(mat, mesh):
    """A ``DenseMeshOperator`` on ``mesh`` from the whole square matrix (a
    host array): each rank keeps its rows, at any n."""
    from ..parallel.sharded import DenseMeshOperator

    return DenseMeshOperator(host_tensor(mat), mesh)


def _dense(mat, device="cuda"):
    from ..operators.linear_operator import MatrixOperator

    return MatrixOperator(host_tensor(mat).to(device))


def triangular_from_arrays(rows, cols, vals, diag, n,
                           device="cuda") -> LevelScheduledTriangular:
    """A ``LevelScheduledTriangular`` from its padded level arrays (the JAX
    object's ``rows``, ``cols``, ``vals``), diagonal and row count."""
    return LevelScheduledTriangular(np.asarray(rows), np.asarray(cols),
                                    host_tensor(vals), host_tensor(diag), n,
                                    device=device)


def factors_from_arrays(kind, lower, upper, perm=None, inv=None,
                        device="cuda"):
    """An ``ILUPreconditioner`` (``kind="ilu"``) or ``ICPreconditioner``
    (``"ic"``) from its two sweeps (each the keys of
    :func:`triangular_from_arrays`) and its multicolor permutation, or
    None."""
    cls = {"ilu": ILUPreconditioner, "ic": ICPreconditioner}[kind]
    return cls(triangular_from_arrays(device=device, **lower),
               triangular_from_arrays(device=device, **upper),
               None if perm is None else np.array(perm),
               None if inv is None else np.array(inv))


def _terms(terms):
    return tuple(tuple(int(v) for v in t) for t in terms)


def _on(a, device, dtype=None):
    return host_tensor(a).to(device=device, dtype=dtype)


def rbic_from_arrays(terms, mcs, center, s_inv, red,
                     device="cuda") -> RedBlackICPreconditioner:
    """A ``RedBlackICPreconditioner`` from its (offset, stride, extent)
    terms, masked coefficient streams, center, pivot scales and parity."""
    return RedBlackICPreconditioner(
        _terms(terms), tuple(_on(m, device) for m in mcs),
        _on(center, device), _on(s_inv, device),
        _on(red, device, torch.bool))


def eisenstat_from_arrays(terms, mcs, s, red,
                          device="cuda") -> EisenstatSSOROperator:
    """An ``EisenstatSSOROperator`` from its terms, scaled streams,
    ``D^{-1/2}`` and parity."""
    return EisenstatSSOROperator(
        _terms(terms), tuple(_on(m, device) for m in mcs), _on(s, device),
        _on(red, device, torch.bool))


def rb_reduced_from_arrays(shape3, s_red, s_black, sr_offsets, sr_streams,
                           sb_offsets, sb_streams, lane_red,
                           device="cuda") -> RBReducedSystem:
    """An ``RBReducedSystem`` from its compact layout, scales and the two
    sets of (offset, stream) couplings."""
    return RBReducedSystem(
        tuple(shape3), _on(s_red, device), _on(s_black, device),
        tuple(sr_offsets), tuple(_on(c, device) for c in sr_streams),
        tuple(sb_offsets), tuple(_on(c, device) for c in sb_streams),
        _on(lane_red, device, torch.bool))


def _scalar(c):
    a = np.asarray(c)
    return complex(a) if np.iscomplexobj(a) else float(a)


def operator_from_arrays(spec: dict, device="cuda", mesh=None):
    """Dispatch on ``spec["kind"]``: ``"dia"`` takes the keys of
    :func:`dia_from_arrays`, ``"stencil"`` those of
    :func:`stencil_from_arrays`, ``"csr"``, ``"ell"``, ``"hyb"`` and
    ``"bsr"`` those of :func:`csr_from_arrays`, :func:`ell_from_arrays`,
    :func:`hyb_from_arrays` and :func:`bsr_from_arrays`, ``"gradient"`` a
    ``GradientOperator``'s ``dims`` and ``dtype``,
    ``"scaled_identity_plus"`` the spec of the ``inner`` operator and
    ``sigma`` (a ``ScaledIdentityPlusOperator``); ``"triangular"``,
    ``"ilu"`` / ``"ic"``, ``"rbic"``, ``"eisenstat"`` and ``"rb_reduced"``
    the keys of :func:`triangular_from_arrays`, :func:`factors_from_arrays`,
    :func:`rbic_from_arrays`, :func:`eisenstat_from_arrays` and
    :func:`rb_reduced_from_arrays`; ``"dense"`` a square ``mat``.  With a
    ``mesh`` (a ``row_mesh`` or a ``slice_mesh``) a ``"dia"`` or
    ``"stencil"`` operator is the row-sharded halo operator of that kind on
    the mesh, an ``"ell"`` one the ``RowShardedELLOperator`` and a
    ``"dense"`` one the ``DenseMeshOperator`` (``device`` is then the
    mesh's)."""
    kind = spec.get("kind")
    args = {k: v for k, v in spec.items() if k != "kind"}
    if kind not in KINDS:
        raise ValueError(f"unknown operator kind {kind!r} (expected one of "
                         f"{KINDS})")
    if kind == "scaled_identity_plus":
        return ScaledIdentityPlusOperator(
            operator_from_arrays(args["inner"], device, mesh),
            _scalar(args["sigma"]))
    if kind in ("ilu", "ic"):
        return factors_from_arrays(kind, device=device, **args)
    if mesh is not None:
        build = {"dia": halo_dia_from_arrays,
                 "stencil": halo_stencil_from_arrays,
                 "ell": row_sharded_ell_from_arrays,
                 "dense": dense_mesh_from_arrays}.get(kind)
        if build is None:
            raise ValueError(f"a {kind!r} operator has no row-sharded form")
        return build(mesh=mesh, **args)
    build = {"dia": dia_from_arrays, "stencil": stencil_from_arrays,
             "gradient": GradientOperator, "csr": csr_from_arrays,
             "ell": ell_from_arrays, "hyb": hyb_from_arrays,
             "bsr": bsr_from_arrays, "dense": _dense,
             "triangular": triangular_from_arrays,
             "rbic": rbic_from_arrays, "eisenstat": eisenstat_from_arrays,
             "rb_reduced": rb_reduced_from_arrays}[kind]
    return build(device=device, **args)
