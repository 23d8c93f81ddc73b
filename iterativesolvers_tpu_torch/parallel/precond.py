"""Distributed preconditioning: shard-local block-Jacobi ILU(0)/IC(0) (port
of ``iterativesolvers_tpu/parallel/precond.py``).

The classic distributed preconditioner (reference contract
docs/src/preconditioning.md:5-10 — any ``ldiv``): drop couplings across
rank boundaries and incomplete-factor each rank's diagonal block on its own.
The apply is then local — each rank runs its own level-scheduled triangular
sweeps on its own rows, with no collective — which is what a preconditioner
inside a distributed Krylov iteration must be (the dots and the SpMV already
own the collectives).

Equivalence: with ``nblocks = D`` contiguous row blocks this is the same
operator as ``ILUPreconditioner.block_jacobi(A, D)`` applied on one device.
The JAX package stores every block's factors stacked along a sharded axis
and applies them under ``shard_map``; here each rank (one process of
``torch.distributed``, :class:`~.sharded.RowMesh`) builds and keeps only its
own block's factors, on the mesh's device, with the row blocks of
``HaloDIAOperator`` (rank r owns rows ``[r n/D, (r+1) n/D)``).

Composes with ``ordering="multicolor"`` per block: each rank's sweep
collapses to its block's color count.
"""

from __future__ import annotations

import torch

from ..operators.preconditioners import (ICPreconditioner, ILUPreconditioner,
                                         Preconditioner)
from ..operators.sparse import CSRMatrix, DIAMatrix
from .sharded import RowMesh

__all__ = ["ShardedBlockJacobiPreconditioner"]


def _diagonal_block(A, lo: int, hi: int) -> CSRMatrix:
    """Rows and columns ``[lo, hi)`` of ``A`` as a CSR matrix on the host:
    a DIA matrix's diagonals sliced to the block's rows (its columns off the
    block drop out as columns off a matrix do), anything else through its
    CSR form."""
    nloc = hi - lo
    if isinstance(A, DIAMatrix):
        return DIAMatrix([d[lo:hi] for d in A.diags], A.offsets,
                         (nloc, nloc), device="cpu").to_csr()
    csr = A if isinstance(A, CSRMatrix) else A.to_csr()
    r, c, _ = csr._host_coo()
    keep = (r >= lo) & (r < hi) & (c >= lo) & (c < hi)
    return CSRMatrix.from_coo(r[keep] - lo, c[keep] - lo,
                              csr.data.cpu()[torch.from_numpy(keep)],
                              (nloc, nloc), device="cpu")


class ShardedBlockJacobiPreconditioner(Preconditioner):
    """Shard-local block-Jacobi ILU(0)/IC(0) over a row mesh (see the module
    docstring).  Build with :meth:`ilu` (nonsymmetric solvers) or :meth:`ic`
    (SPD solvers; symmetric apply).  ``ldiv`` takes this rank's block of a
    row-sharded vector and returns it in the vector's dtype."""

    def __init__(self, mesh: RowMesh, nloc: int, local, nlevels: int):
        self.mesh = mesh
        self.nloc = int(nloc)
        self.local = local        # this rank's ILU / IC preconditioner
        self._nlevels = int(nlevels)

    @property
    def nlevels(self):
        """Max sequential fronts per rank's sweep (the ranks run theirs in
        parallel); the maximum over the ranks, reduced once at build."""
        return self._nlevels

    # -- construction ---------------------------------------------------------
    @classmethod
    def _build(cls, factory, A, mesh: RowMesh, ordering: str):
        n, m = A.shape
        if n != m:
            raise ValueError(
                "block-Jacobi factorization needs a square operator")
        D = mesh.size
        if n % D != 0:
            raise ValueError(f"n={n} must divide evenly over {D} devices")
        nloc = n // D
        lo = mesh.rank * nloc
        local = factory(_diagonal_block(A, lo, lo + nloc), ordering=ordering,
                        device=mesh.device)
        levels = mesh.all_gather(torch.tensor([local.nlevels],
                                              device=mesh.device))
        return cls(mesh, nloc, local, max(int(v) for v in levels))

    @classmethod
    def ilu(cls, A, mesh: RowMesh, *, ordering: str = "natural"):
        """Shard-local block-Jacobi ILU(0) (nonsymmetric apply).  ``A`` is
        the whole matrix (a ``DIAMatrix``, a ``CSRMatrix`` or another stored
        format, on any device); each rank takes its diagonal block."""
        return cls._build(ILUPreconditioner.from_operator, A, mesh, ordering)

    @classmethod
    def ic(cls, A, mesh: RowMesh, *, ordering: str = "natural"):
        """Shard-local block-Jacobi IC(0) (symmetric apply — safe for
        cg/minres/lobpcg as long as A's block-diagonal part is SPD)."""
        return cls._build(ICPreconditioner.from_operator, A, mesh, ordering)

    # -- apply ----------------------------------------------------------------
    def ldiv(self, x):
        return self.local.ldiv(x).to(x.dtype)

    def ldiv_rows(self, Xr):
        return self.local.ldiv_rows(Xr).to(Xr.dtype)
