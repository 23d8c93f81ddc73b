"""Faults that the multi-rank tests plant in every rank of a run
(``on_ranks.py --fault <name>``): each is called with the rank and returns
a solve hook, or None where it breaks the program underneath instead."""

import os

import torch

import iterativesolvers_tpu_torch.solvers.cg as port_cg
from iterativesolvers_tpu_torch.parallel.sharded import RowMesh


def unchanged(rank):
    """Every CG step returns its state unchanged (only its counter moves,
    so the solve still ends)."""
    def step(op, Pl, state, live, log_in_place=False):
        return state._replace(k=state.k + live.to(state.k.dtype))
    port_cg._cg_step = step


def half_left_out(rank):
    """Half of each rank's rows of the answer never computed (left at 0)."""
    def hook(solve):
        def broken(b):
            x, steps = solve(b)
            x = x.clone()
            x[x.shape[0] // 2:] = 0
            return x, steps
        return broken
    return hook


def exchange_left_out(rank):
    """The halo exchange between the ranks left out: each rank's product
    reads zeros across its edges, as if no other rank were there."""
    def exchange(self, first, last):
        return torch.zeros_like(last), torch.zeros_like(first)
    RowMesh.exchange = exchange


def altered(rank):
    """The answer altered where it is produced, by 0.1%."""
    def hook(solve):
        def broken(b):
            x, steps = solve(b)
            return x * 1.001, steps
        return broken
    return hook


def rank_dies(rank):
    """Rank 2 ends with code 9 at its third solve, inside the window."""
    calls = [0]

    def hook(solve):
        def dying(b):
            calls[0] += 1
            if rank == 2 and calls[0] == 3:
                os._exit(9)
            return solve(b)
        return dying
    return hook
