"""``poisson7_216``: the port's matrix-free 7-point Laplacian and its plain
reference."""

from krylov_bench.reference.operators import poisson7


def port_operator(its, cfg, device):
    """The port's operator: ``laplacian(side, 3)``, which stores no matrix."""
    return its.laplacian(cfg["side"], cfg["dims"], device=device)


def reference_operator(cfg):
    return poisson7(cfg["side"])
