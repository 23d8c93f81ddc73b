"""Red-black IC(0) of the 7-point Laplacian, worked out on the grid.

In red-black order (red: the sum of the grid coordinates is even) the
Laplacian is ``[[C I, B^T], [B, C I]]`` with ``C = 6`` and ``B`` holding
``-1`` for each face neighbour, since every neighbour of a point has the
other colour.  IC(0) keeps the pattern of the matrix, so

    L = [[sqrt(C) I, 0], [B / sqrt(C), D_b]],
    D_b = sqrt(C - (number of in-grid neighbours) / C),

exactly, and ``M = L L^T``.  ``apply`` returns ``M^{-1} x`` by the forward
solve ``L y = x`` and the backward solve ``L^T z = y``.
"""

from __future__ import annotations

import math

import torch

from .operators import neighbour_sum6

CENTER = 6.0


def red_black(side: int, dtype, device):
    """(red mask, D_b) on the ``side**3`` grid, ``D_b`` on every point (only
    its black entries are used)."""
    ax = torch.arange(side, device=device)
    red = ((ax[:, None, None] + ax[None, :, None] + ax[None, None, :]) % 2) == 0
    count = neighbour_sum6(torch.ones((side,) * 3, dtype=torch.float64,
                                      device=device))
    d_black = torch.sqrt(CENTER - count / CENTER).to(dtype)
    return red, d_black


def rbic(side: int, dtype=torch.float64, device="cpu"):
    """``apply(x) = M^{-1} x`` of the red-black IC(0) preconditioner of the
    7-point Laplacian on a ``side**3`` grid, computed in ``dtype``."""
    red, d_black = red_black(side, dtype, device)
    sc = math.sqrt(CENTER)

    def apply(x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(side, side, side).to(dtype)
        # L y = x: red rows first (diagonal), then black rows, which read
        # only red neighbours: y_b = (x_b - sum (-1 / sqrt C) y_r) / D_b
        y_red = torch.where(red, g / sc, 0)
        y = torch.where(red, y_red, (g + neighbour_sum6(y_red) / sc) / d_black)
        # L^T z = y: black rows first, then red rows from black neighbours
        z_black = torch.where(red, 0, y / d_black)
        z = torch.where(red, (y + neighbour_sum6(z_black) / sc) / sc, z_black)
        return z.reshape(-1)

    return apply
