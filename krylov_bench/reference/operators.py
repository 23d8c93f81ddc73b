"""Matrix-free products of the benchmark's grid operators, by shifted slices.

A vector of ``side**3`` entries is the grid ``(side, side, side)`` in C
order; every operator is symmetric under a swap of axes, so which axis is
which does not matter.  Dirichlet boundaries: a neighbour outside the grid
is zero.
"""

from __future__ import annotations

import torch


def neighbour_sum6(g: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours of each point of the 3-D grid ``g``."""
    out = torch.zeros_like(g)
    for axis in range(3):
        n = g.shape[axis]
        out.narrow(axis, 1, n - 1).add_(g.narrow(axis, 0, n - 1))
        out.narrow(axis, 0, n - 1).add_(g.narrow(axis, 1, n - 1))
    return out


def poisson7(side: int):
    """y = A x of the 7-point Laplacian on a ``side**3`` grid: 6 on the
    diagonal, -1 to each face neighbour (IterativeSolvers.jl
    ``test/laplace_matrix.jl``)."""

    def apply(x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(side, side, side)
        return (6 * g - neighbour_sum6(g)).reshape(-1)

    return apply
