"""Red-black IC(0) of a stencil operator: the port's
``RedBlackICPreconditioner.from_stencil`` and the plain reference."""

from krylov_bench.reference.rbic import rbic


def port(its, op, cfg):
    return its.RedBlackICPreconditioner.from_stencil(op)


def reference(cfg, dtype, device):
    """``M^{-1}`` applied, computed in ``dtype``; the reference covers the
    7-point Laplacian."""
    if cfg["stencil_points"] != 7:
        raise ValueError("the red-black IC(0) reference covers the 7-point "
                         "Laplacian")
    return rbic(cfg["side"], dtype, device)
