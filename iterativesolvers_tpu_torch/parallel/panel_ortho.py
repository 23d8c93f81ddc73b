"""Distributed Krylov-panel orthogonalization: per-rank sweeps + allreduce
(port of ``iterativesolvers_tpu/parallel/panel_ortho.py``).

MGS needs one global dot per panel row, so on a mesh it would take m
allreduces per Arnoldi step.  The communication-optimal distributed
orthogonalization is classical Gram-Schmidt with re-orthogonalization
(CGS2): each pass is

    partial[j] = <V_loc[j], w_loc>      (one streaming sweep over the panel)
    h          = allreduce(partial)     (ONE allreduce of an (m+1,) vector)
    w_loc     -= sum_j h[j] V_loc[j]    (second streaming sweep)

and two passes give MGS-grade orthogonality ("twice is enough"; the DGKS
stability class).  Per Arnoldi step: one allreduce a pass, and one scalar
allreduce for the norm, whatever m.

The two sweeps of an f32 solve (f32 or bf16 panel) are the CUDA kernels of
``ops/cuda_panel_ortho.py`` (the JAX package's Pallas kernels
``_pallas_dots`` / ``_pallas_update``); any other solve dtype (f64) takes
the gemv sweeps, as the JAX package's ``_use_pallas`` sends it to
``_xla_dots`` / ``_xla_update``.  The JAX package's TPU and VMEM gates are
not carried over.

Layout: each rank holds an ``(m1, R, 512)`` block of the panel, its rows of
the Krylov vectors padded with zeros to ``R * 512 >= nloc`` entries (the
last rank's block also to ``nloc`` rows when D does not divide n).  A bf16
panel (GMRES-IR mode) streams half the bytes; all arithmetic is f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_panel_ortho import PANEL_DTYPES, panel_dots, panel_update
from .sharded import RowMesh, row_block

__all__ = [
    "PanelLayout",
    "panel_layout",
    "dist_panel_ortho",
    "vec_to_panel_row",
    "panel_row_to_vec",
]

_LANES = 512
_MAX_CROWS = 512


def _round_up(x, m):
    return -(-x // m) * m


class PanelLayout(NamedTuple):
    n: int          # global rows
    D: int          # shards
    nloc: int       # rows per shard (ceil(n / D); last shard zero-padded)
    R: int          # padded (rows-of-512) per shard
    CR: int         # chunk rows (R % CR == 0)
    nc: int         # chunks per row sweep

    @property
    def n_pad(self) -> int:
        """Global rows after padding to an even per-shard split."""
        return self.nloc * self.D


def panel_layout(n: int, D: int) -> PanelLayout | None:
    """Static per-shard geometry, or None when the layout does not apply
    (D < 1).  When n is not divisible by D the last shard is zero-padded
    to ``nloc = ceil(n / D)`` rows; zero rows are already the panel
    invariant, so the sweeps need no masking.  ``R`` is the JAX package's
    (rounded up to its chunk of 512 rows of 512), so that both packages
    hold the same panel."""
    n, D = int(n), int(D)
    if D < 1:
        return None
    nloc = -(-n // D)
    r_min = -(-nloc // _LANES)
    if r_min >= _MAX_CROWS:
        CR = _MAX_CROWS
        R = _round_up(r_min, CR)
    else:
        R = r_min
        CR = R
    return PanelLayout(n, D, nloc, R, CR, R // CR)


def _acc_dtype(w_dtype):
    """Working/accumulation dtype: the solve's vector dtype, with a bf16 w
    accumulating in f32 (the panel's dtype does not enter: a bf16 panel of
    an f32 solve, GMRES-IR, works in f32)."""
    return torch.float32 if w_dtype == torch.bfloat16 else w_dtype


def _use_kernels(panel_dtype, acc_dtype) -> bool:
    """The kernels are written for f32 working vectors over f32 / bf16
    panel streams; other dtypes (f64, complex) take the gemv sweeps."""
    return acc_dtype == torch.float32 and panel_dtype in PANEL_DTYPES


def _gemv_dots(V, w2d, acc):
    # rows past k are zero by the panel invariant; no mask needed
    Vf = V.reshape(V.shape[0], -1)
    return Vf.to(acc) @ w2d.reshape(-1).to(Vf.dtype).to(acc)


def _gemv_update(V, w2d, h, acc):
    Vf = V.reshape(V.shape[0], -1)
    upd = h.to(Vf.dtype).to(acc) @ Vf.to(acc)
    y = w2d - upd.reshape(w2d.shape).to(w2d.dtype)
    return y, torch.sum(y.to(acc) * y)


def _local_cgs(layout, mesh, passes, use_kernels, acc, V, w_loc, k):
    """Rank-local CGS-with-reorthogonalization + normalization.

    V: (m1, R, 512) panel block; w_loc: this rank's rows of w; k: 0-d int32
    active-row count.  Returns (w2d normalized (R, 512) in ``acc``, h (m1,)
    accumulated coefficients, nrm ()), h and nrm the same on every rank."""
    R = layout.R
    w2d = torch.zeros(R * _LANES, dtype=acc, device=V.device)
    w2d[: w_loc.shape[0]] = w_loc
    w2d = w2d.view(R, _LANES)
    h_tot = torch.zeros(V.shape[0], dtype=acc, device=V.device)
    for _ in range(passes):
        part = panel_dots(V, w2d, k) if use_kernels else _gemv_dots(V, w2d,
                                                                    acc)
        h = mesh.all_reduce(part)
        if use_kernels:
            w2d, ss_part = panel_update(V, w2d, h, k)
        else:
            w2d, ss_part = _gemv_update(V, w2d, h, acc)
        h_tot = h_tot + h.to(acc)
    nrm = torch.sqrt(mesh.all_reduce(ss_part))
    inv = torch.where(nrm == 0, 1.0, 1.0 / nrm).to(w2d.dtype)
    return w2d * inv, h_tot, nrm


def dist_panel_ortho(V, w, k, m1: int, mesh: RowMesh, layout: PanelLayout,
                     *, passes: int = 2):
    """Orthogonalize this rank's rows ``w`` of the row-sharded w against
    rows 0..k of the sharded panel and normalize (distributed CGS2; see the
    module docstring).  Every rank of the mesh calls it together.

    Args:
      V: (m1, R, 512) this rank's panel block.
      w: this rank's rows of the (n,) vector.
      k: 0-d int32 tensor on V's device (or an int): rows 0..k take part.
      m1: panel row count.

    Returns ``(w2d, h, nrm)``: this rank's block of the normalized w in the
    padded panel-row layout (R, 512), the (m1,) accumulated projection
    coefficients and the norm BEFORE normalization, both the same on every
    rank: ``w_original = sum_j h[j] V[j] + nrm * w2d`` (the contract of
    ``ops/cuda_mgs.panel_mgs``).
    """
    if passes < 1:
        raise ValueError(f"dist_panel_ortho needs passes >= 1, got {passes}")
    if V.shape[0] != m1:
        raise ValueError(f"V has {V.shape[0]} rows, not m1 = {m1}")
    if not isinstance(k, torch.Tensor):
        k = torch.tensor(int(k), dtype=torch.int32, device=V.device)
    acc = _acc_dtype(w.dtype)
    return _local_cgs(layout, mesh, passes, _use_kernels(V.dtype, acc), acc,
                      V, w.to(acc), k)


def vec_to_panel_row(v, mesh: RowMesh, layout: PanelLayout):
    """This rank's rows of an (n,) vector -> its (R, 512) block of one panel
    row, zero-padded (rank-local, no communication)."""
    flat = torch.zeros(layout.R * _LANES, dtype=v.dtype, device=v.device)
    flat[: v.shape[0]] = v
    return flat.view(layout.R, _LANES)


def panel_row_to_vec(row2d, mesh: RowMesh, layout: PanelLayout):
    """This rank's (R, 512) block of a panel row -> its rows of the (n,)
    vector (a view, rank-local)."""
    lo, hi = row_block(layout.n, layout.D, mesh.rank)
    return row2d.reshape(-1)[: hi - lo]
