"""The 7-point Laplacian on a grid whose axes differ (a brick), by shifted
slices.

A vector of ``nz * ny * nx`` entries is the grid ``(nz, ny, nx)`` in C
order.  Dirichlet boundaries: a neighbour outside the grid is zero.  On a
cube it is ``operators.poisson7``.
"""

from __future__ import annotations

import torch

from .operators import neighbour_sum6


def poisson7_brick(shape):
    """y = A x of the 7-point Laplacian on the grid ``shape`` (three
    extents): 6 on the diagonal, -1 to each face neighbour."""
    shape = tuple(int(s) for s in shape)

    def apply(x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(shape)
        return (6 * g - neighbour_sum6(g)).reshape(-1)

    return apply
