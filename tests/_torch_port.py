"""Helpers shared by the tests that hold the PyTorch port
(``iterativesolvers_tpu_torch``) against the JAX package on the CPU.

Operators of the JAX package are taken apart into numpy arrays and rebuilt
in the port with ``utils/convert.py`` on ``device="cpu"``; results come back
as numpy arrays for comparison.
"""

import numpy as np
import torch

from iterativesolvers_tpu_torch.utils import convert

CPU = "cpu"


def to_torch(a):
    """A copy of a numpy / JAX array as a CPU tensor of its dtype."""
    return convert.host_tensor(np.asarray(a))


def to_numpy(t):
    """A tensor as a numpy array (bfloat16 as f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def port_dia(A):
    """The port's DIAMatrix on the CPU with the values of the JAX ``A``."""
    return convert.dia_from_arrays([np.asarray(d) for d in A.diags],
                                   A.offsets, A.shape, device=CPU)


def port_stencil(St):
    """The port's StencilOperator on the CPU with the data of the JAX ``St``."""
    return convert.stencil_from_arrays(
        St.n, np.asarray(St.center), St.terms,
        [np.asarray(c) for c in St.coeffs], np.asarray(St.center).dtype,
        device=CPU)


def rel(a, b):
    """||a - b|| / ||b|| of two arrays, in f64 (complex128 for complex)."""
    dt = np.result_type(np.asarray(a).dtype, np.asarray(b).dtype, np.float64)
    a = np.asarray(a, dtype=dt)
    b = np.asarray(b, dtype=dt)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def sparse_spec(A):
    """The carry-across spec (``convert.operator_from_arrays``) of a JAX
    CSR, ELL, HYB, BSR or DIA matrix: its arrays as numpy."""
    name = type(A).__name__
    a = np.asarray
    if name == "CSRMatrix":
        return dict(kind="csr", data=a(A.data), indices=a(A.indices),
                    indptr=a(A.indptr), shape=A.shape)
    if name == "ELLMatrix":
        return dict(kind="ell", **_ell_args(A))
    if name == "HYBMatrix":
        return dict(kind="hyb", **_hyb_args(A))
    if name == "BSRMatrix":
        return dict(kind="bsr", blocks=a(A.blocks),
                    block_cols=a(A.block_cols),
                    block_row_ids=a(A.block_row_ids), shape=A.shape)
    if name == "DIAMatrix":
        return dict(kind="dia", diags=[a(d) for d in A.diags],
                    offsets=A.offsets, shape=A.shape)
    raise TypeError(name)


def _ell_args(A):
    out = dict(data=np.asarray(A.data), cols=np.asarray(A.cols),
               shape=A.shape, gather_chunk_rows=A._gather_chunk_rows)
    if A.adj is not None:
        out["adj"] = _ell_args(A.adj)
    return out


def _hyb_args(A):
    ell = _ell_args(A.ell)
    return dict(ell=ell, tail_rows=np.asarray(A.tail_rows),
                tail_cols=np.asarray(A.tail_cols),
                tail_vals=np.asarray(A.tail_vals), shape=A.shape,
                adj=None if A.adj is None else _hyb_args(A.adj))


def port_sparse(A):
    """The port's operator on the CPU with the arrays of the JAX stored
    matrix ``A`` (any of CSR, ELL, HYB, BSR, DIA)."""
    return convert.operator_from_arrays(sparse_spec(A), device=CPU)


def triangular_spec(T):
    """The arrays of a JAX ``LevelScheduledTriangular`` (the keys of
    ``convert.triangular_from_arrays``)."""
    a = np.asarray
    return dict(rows=a(T.rows), cols=a(T.cols), vals=a(T.vals),
                diag=a(T.diag), n=T.n)


def precond_spec(P):
    """The carry-across spec of a JAX ``LevelScheduledTriangular``, ILU /
    IC / red-black IC preconditioner, ``EisenstatSSOROperator`` or
    ``RBReducedSystem``: its arrays as numpy."""
    name = type(P).__name__
    a = np.asarray
    if name == "LevelScheduledTriangular":
        return dict(kind="triangular", **triangular_spec(P))
    if name in ("ILUPreconditioner", "ICPreconditioner"):
        return dict(kind="ilu" if name == "ILUPreconditioner" else "ic",
                    lower=triangular_spec(P.lower_solve),
                    upper=triangular_spec(P.upper_solve),
                    perm=None if P.perm is None else a(P.perm),
                    inv=None if P.inv is None else a(P.inv))
    if name == "RedBlackICPreconditioner":
        return dict(kind="rbic", terms=P.terms, mcs=[a(m) for m in P.mcs],
                    center=a(P.center), s_inv=a(P.s_inv), red=a(P.red))
    if name == "EisenstatSSOROperator":
        return dict(kind="eisenstat", terms=P.terms,
                    mcs=[a(m) for m in P.mcs], s=a(P.s), red=a(P.red))
    if name == "RBReducedSystem":
        return dict(kind="rb_reduced", shape3=P.shape3, s_red=a(P.s_red),
                    s_black=a(P.s_black), sr_offsets=P.sr_offsets,
                    sr_streams=[a(c) for c in P.sr_streams],
                    sb_offsets=P.sb_offsets,
                    sb_streams=[a(c) for c in P.sb_streams],
                    lane_red=a(P.lane_red))
    raise TypeError(name)


def port_precond(P):
    """The port's object on the CPU with the arrays of the JAX ``P``
    (see :func:`precond_spec`)."""
    return convert.operator_from_arrays(precond_spec(P), device=CPU)
