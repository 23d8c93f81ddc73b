"""``poisson7_4x216``: the 7-point Laplacian on the (864, 216, 216) grid,
split over the ranks as slabs of the slowest axis, and its plain reference
on the whole grid."""

from krylov_bench.reference.brick import poisson7_brick


def port_operator(its, cfg, device, mesh):
    """The port's matrix-free stencil of the grid, in the term order of
    ``laplacian``, as a ``HaloStencilOperator`` on ``mesh``: each rank's
    products cover its rows, with one halo exchange each."""
    nz, ny, nx = cfg["grid"]
    terms, coeffs = [], []
    for stride, extent in ((1, nx), (nx, ny), (nx * ny, nz)):
        terms += [(stride, stride, extent), (-stride, stride, extent)]
        coeffs += [cfg["off_diagonal"]] * 2
    st = its.StencilOperator(nz * ny * nx, cfg["center"], tuple(terms),
                             coeffs, dtype=cfg["dtype"], device=device)
    return its.parallel.HaloStencilOperator(st, mesh)


def reference_operator(cfg):
    return poisson7_brick(cfg["grid"])
