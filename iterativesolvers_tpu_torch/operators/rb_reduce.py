"""Red-black cyclic reduction of the SSOR/Eisenstat system (port of
``iterativesolvers_tpu/operators/rb_reduce.py``).

For a 2-color (red-black) grid the Eisenstat-SSOR preconditioned operator
collapses algebraically: with ``Atilde = D^-1/2 A D^-1/2 = I + E + E^T``
and E strictly lower in RB ordering (black rows x red cols), E^2 = 0, so

    Ahat = (I+E)^{-1} Atilde (I+E^T)^{-1} = I - E E^T

which is IDENTITY on red rows and has NO red-black coupling — the
preconditioned system decouples into ``x_r = b_r`` and the half-size
black system ``(I - E E^T)_bb x_b = b_b`` (classical cyclic reduction /
the Schur complement of the diagonally scaled system).

This module solves the HALF system on COMPACTED black/red vectors:

  * all vectors are length n/2 — every CG vector pass halves;
  * the coupling applications ``w_r = (E^T)_rb v_b`` and ``(E)_br w_r``
    are shifted multiply-adds on the compact arrays
    (``preconditioners.shift_sum``; the x couplings pick parity-dependent
    compact offsets, folded into masked streams at build time — no
    gathers);
  * compaction/expansion are reshape + select (the pair trick along the
    fastest axis) — no gathers anywhere.

The streams are built in f64 with the JAX package's formulas (there numpy on
the host, here torch on the matrix's device, which gives the same values)
and kept in the matrix's dtype.  :meth:`RBReducedSystem.to_dia`
gives the reduced system as an explicit ``DIAMatrix`` (~25 diagonals), whose
products take the DIA kernel.

Requires an even ``side`` (the compact pair layout needs x-parity to
alternate within complete pairs) and the same unit-step symmetric DIA
contract as ``RedBlackICPreconditioner.from_dia``.
"""

from __future__ import annotations

import numpy as np
import torch

from .linear_operator import LinearOperator
from .preconditioners import (_parity_red, _shifted, _symmetric_partner,
                              _unit_step_dia, shift_sum)

__all__ = ["RBReducedSystem"]


class RBReducedSystem(LinearOperator):
    """Half-size black system of the RB-scaled operator (see module doc).

    Usage::

        R = RBReducedSystem.from_dia(A, side, dims)
        bb, br = R.reduce_rhs(b)          # compact black rhs + red part
        xb = cg(R, bb, reltol=...)        # half-size CG
        x = R.expand_solution(xb, br)     # solution of A x = b
    """

    def __init__(self, shape3, s_red, s_black, sr_offsets, sr_streams,
                 sb_offsets, sb_streams, lane_red):
        self.shape3 = tuple(int(v) for v in shape3)   # (planes, rows, side)
        self.s_red = s_red                # (n/2,) D^-1/2 at red, compact
        self.s_black = s_black            # (n/2,) D^-1/2 at black, compact
        self.sr_offsets = tuple(int(o) for o in sr_offsets)
        self.sr_streams = tuple(sr_streams)   # E^T streams, one an offset
        self.sb_offsets = tuple(int(o) for o in sb_offsets)
        self.sb_streams = tuple(sb_streams)   # E streams
        self.lane_red = lane_red          # (planes, rows, side/2) bool:
        # True where the RED element of the (x-pair) sits in lane 0

    # ---------------- construction ----------------

    @classmethod
    def from_dia(cls, dia, side: int, dims: int) -> "RBReducedSystem":
        n, offs, by_off = _unit_step_dia(dia, side, dims)
        side = int(side)
        if side % 2:
            raise ValueError("RBReducedSystem requires an even side")
        center = by_off[0].to(torch.float64)
        if bool((center <= 0).any()):
            raise ZeroDivisionError("non-positive diagonal")
        for o in offs:
            _symmetric_partner(by_off, o, by_off[o])
        dev = center.device
        # numpy's sqrt (correctly rounded; torch's on the CPU is not always):
        # the JAX package's bits, 10M values a round trip at 216^3
        s = torch.from_numpy(1.0 / np.sqrt(center.cpu().numpy())).to(dev)
        red = _parity_red(n, [(side**k, side) for k in range(dims)], dev)
        # compact index: pairs along x; element (.., x) -> (.., x//2); the
        # red-compact and black-compact flat indices coincide with it (each
        # x-pair holds exactly one red and one black element)
        if dims == 1:
            shape3 = (1, 1, side)
        elif dims == 2:
            shape3 = (1, side, side)
        else:
            shape3 = (side**(dims - 2), side, side)

        # scaled streams e_o[i] = a_o(i) s[i] s[i+o] (0 where masked)
        def scaled(o):
            return by_off[o].to(torch.float64) * s * _shifted(s, o)

        # E^T application: w_red[c(i)] = sum_o e_o[i] v_black[c(i+o)],
        # i red.  Collected per compact offset: for one offset each compact
        # index takes at most one entry (one red and one black element a
        # pair), so the indexed add equals the JAX package's np.add.at.
        def build(rows_mask):
            streams = {}
            for o in offs:
                e = scaled(o)
                ii = torch.nonzero(rows_mask & (e != 0)).flatten()
                ci = ii // 2
                d = (ii + o) // 2 - ci
                for dv in torch.unique(d).tolist():
                    sel = d == dv
                    st = streams.setdefault(int(dv), torch.zeros(
                        n // 2, dtype=torch.float64, device=dev))
                    st.index_add_(0, ci[sel], e[ii[sel]])
            offsets = tuple(sorted(streams))
            return offsets, tuple(streams[o] for o in offsets)

        sr_off, sr_st = build(red)        # red rows gather black neighbors
        sb_off, sb_st = build(~red)       # black rows gather red neighbors

        # lane_red: for each x-pair, is the red element in lane 0?
        lane_red = red[::2].reshape(shape3[0], shape3[1], side // 2)
        dt = dia.dtype
        return cls(shape3, s[red].to(dt), s[~red].to(dt),
                   sr_off, tuple(x.to(dt) for x in sr_st),
                   sb_off, tuple(x.to(dt) for x in sb_st),
                   lane_red.contiguous())

    # ---------------- compact layout helpers ----------------

    @property
    def nh(self) -> int:
        p, r, side = self.shape3
        return p * r * side // 2

    @property
    def shape(self):
        return (self.nh, self.nh)

    @property
    def dtype(self):
        return self.s_red.dtype

    @property
    def device(self):
        return self.s_red.device

    def split(self, v):
        """(n,) grid vector -> (red_compact, black_compact), no gathers."""
        p, r, side = self.shape3
        pair = v.reshape(p, r, side // 2, 2)
        lr = self.lane_red
        red = torch.where(lr, pair[..., 0], pair[..., 1])
        black = torch.where(lr, pair[..., 1], pair[..., 0])
        return red.reshape(-1), black.reshape(-1)

    def merge(self, red, black):
        """Inverse of :meth:`split`."""
        p, r, side = self.shape3
        lr = self.lane_red
        red = red.reshape(p, r, side // 2)
        black = black.reshape(p, r, side // 2)
        lane0 = torch.where(lr, red, black)
        lane1 = torch.where(lr, black, red)
        return torch.stack([lane0, lane1], dim=-1).reshape(-1)

    def to_red(self, vb):
        """w_r = (E^T)_rb v_b on compact vectors ((nh,) or (nh, k))."""
        return shift_sum(self.sr_offsets, self.sr_streams, vb)

    def to_black(self, wr):
        """(E)_br w_r on compact vectors."""
        return shift_sum(self.sb_offsets, self.sb_streams, wr)

    # ---------------- the reduced operator ----------------

    def mv(self, vb):
        """(I - E E^T)_bb v_b — ~one SpMV-equivalent over n/2."""
        return vb - self.to_black(self.to_red(vb))

    def rmv(self, vb):
        return self.mv(vb)                # symmetric

    # ---------------- transforms ----------------

    def reduce_rhs(self, b):
        """b -> (compact black rhs of the reduced system, compact red
        part), i.e. the black/red components of (I+E)^{-1} D^{-1/2} b."""
        br, bb = self.split(b)
        br = self.s_red * br
        bb = self.s_black * bb
        return bb - self.to_black(br), br

    def expand_solution(self, xb, br):
        """(black solution, red rhs part) -> x with A x = b.

        xhat_r = bhat_r = br (identity red rows), then
        x = D^{-1/2} (I+E^T)^{-1} xhat."""
        xr = br - self.to_red(xb)
        return self.merge(self.s_red * xr, self.s_black * xb)

    # ---------------- explicit Schur DIA form ----------------

    def to_dia(self):
        """The reduced black system ``(I - E E^T)_bb`` as an explicit
        ``DIAMatrix`` on the compact index space (~25 diagonals: pairwise
        sums of the two 7-offset stream sets), on this operator's device.

        On one card the two-pass form (:meth:`mv`) reads 18 half-length
        streams against ~27; the DIA form drops into
        ``parallel.HaloDIAOperator`` for a solve on a mesh of ranks, and its
        products take the DIA kernel (a launch a group of 16 diagonals)."""
        from .sparse import DIAMatrix

        nh = self.nh
        acc = {}
        # (E E^T)_bb[c, c+d] = sum_{o1+o2=d} sb_o1[c] * sr_o2[c + o1]
        sr = [c.to(torch.float64) for c in self.sr_streams]
        for o1, cb in zip(self.sb_offsets, self.sb_streams):
            cbh = cb.to(torch.float64)
            for o2, crh in zip(self.sr_offsets, sr):
                d = int(o1 + o2)
                prod = cbh * _shifted(crh, o1)
                acc[d] = prod if d not in acc else acc[d] + prod
        offsets = sorted(acc)
        rows = torch.arange(nh, device=self.device)
        data = []
        for d in offsets:
            v = -acc[d]
            if d == 0:
                v = v + 1.0
            # structural zeros where the column falls off the matrix — the
            # halo operators rely on this to make wrap-around reads inert
            v = torch.where((rows + d >= 0) & (rows + d < nh), v, 0.0)
            data.append(v.to(self.dtype))
        return DIAMatrix(tuple(data), tuple(offsets), (nh, nh),
                         device=self.device)
