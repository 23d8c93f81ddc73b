"""Convergence history / observability.

A copy of ``iterativesolvers_tpu/utils/history.py`` (numpy only), kept in the
port so that the port imports nothing of the JAX package.  The reference
mutates a ``ConvergenceHistory`` dict inside the solver loop
(``nextiter!``/``push!``/``shrink!``, src/history.jl:127-216).  The solver
loop runs on the device without a host sync per step, so logging is instead
done into **pre-allocated device buffers** (the analogue of ``reserve!``,
src/history.jl:163-186) and materialized into this host-side object after the
loop exits (the analogue of ``shrink!``, src/history.jl:193-203).

Counters mirror the reference fields (src/history.jl:54-66):
  * ``mvps``  — number of A*v products
  * ``mtvps`` — number of A'*v products
  * ``iters`` — iterations run
  * ``restart`` — restart window (GMRES-style solvers), else None
  * ``isconverged``
  * ``data``  — dict of per-iteration series (e.g. ``:resnorm``)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["ConvergenceHistory"]


class ConvergenceHistory:
    """Per-run solver statistics and per-iteration logs.

    ``partial=True`` mirrors the reference's ``PartialHistory`` (only the last
    value of each series is kept); solvers here always log full series on
    device and slice at materialization, so ``partial`` only controls what is
    retained in ``data``.
    """

    def __init__(self, partial: bool = False, restart: Optional[int] = None):
        self.partial = partial
        self.restart = restart
        self.mvps: int = 0
        self.mtvps: int = 0
        self.iters: int = 0
        self.isconverged: bool = False
        self.data: Dict[str, Any] = {}

    # -- accessors (src/history.jl:238-252) ---------------------------------
    def nprods(self) -> int:
        return self.mvps + self.mtvps

    def niters(self) -> int:
        return self.iters

    def nrests(self) -> int:
        if self.restart in (None, 0):
            return 1
        return int(np.ceil(self.iters / self.restart))

    # -- dict-like access over logged series (src/history.jl:94-125) --------
    def __getitem__(self, key: str):
        return self.data[key]

    def __setitem__(self, key: str, value) -> None:
        self.data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def keys(self):
        return self.data.keys()

    # -- materialization from device log buffers ----------------------------
    def set_series(self, key: str, buf, nvalid: int) -> None:
        """Install a per-iteration series from a fixed-size device buffer.

        ``buf`` has static length >= nvalid; entries past ``nvalid`` are
        scratch (the analogue of ``shrink!``).  With ``partial=True`` only the
        final value is retained.
        """
        arr = np.asarray(buf)[: int(nvalid)]
        self.data[key] = arr[-1:] if (self.partial and arr.size) else arr

    def __repr__(self) -> str:  # ~ show(io, ch) src/history.jl:254-260
        flag = "converged" if self.isconverged else "not converged"
        return (
            f"ConvergenceHistory({flag}, iters={self.iters}, "
            f"mvps={self.mvps}, mtvps={self.mtvps}, "
            f"keys={sorted(self.data.keys())})"
        )

    # -- plotting (reference uses RecipesBase, src/history.jl:269-325) ------
    def plot(self, key: str = "resnorm", width: int = 60, height: int = 12) -> str:
        """ASCII convergence plot with restart separators ('|')."""
        y = np.asarray(self.data[key], dtype=float)
        if y.size == 0:
            return "(empty history)"
        logy = np.log10(np.maximum(y, np.finfo(float).tiny))
        lo, hi = float(logy.min()), float(logy.max())
        span = max(hi - lo, 1e-12)
        cols = np.linspace(0, y.size - 1, num=min(width, y.size)).astype(int)
        rows = []
        for r in range(height, -1, -1):
            level = lo + span * r / height
            line = []
            for c in cols:
                if self.restart and c and c % self.restart == 0:
                    line.append("|")
                elif abs(logy[c] - level) <= span / (2 * height):
                    line.append("*")
                else:
                    line.append(" ")
            rows.append(f"1e{level:+06.1f} {''.join(line)}")
        rows.append(" " * 8 + f"iterations 0..{y.size - 1}  [{key}]")
        return "\n".join(rows)

    def plotable_keys(self):
        """Series the plot recipes draw: 1-D/2-D numeric with >= 2 points
        (the analogue of ``plotable``, src/history.jl:264-265)."""
        out = []
        for key in sorted(self.data.keys()):
            val = np.asarray(self.data[key])
            if (
                val.ndim in (1, 2)
                and val.shape[0] >= 2
                and np.issubdtype(val.dtype, np.number)
            ):
                out.append(key)
        return out

    def to_mpl(self, keys=None, *, sep_kw=None, **subplots_kw):
        """Matplotlib figure with one subplot per plottable series and
        vertical restart separators — the plotting-ecosystem equivalent of
        the reference's Plots.jl recipes (src/history.jl:269-325: one
        subplot per key, ``:restart`` separators via vline).

        2-D series (e.g. LOBPCG/svdl per-vector residuals, (iters, k))
        draw one line per column.  Residual-like series get a log y-axis.
        Returns the ``matplotlib.figure.Figure``; matplotlib is imported
        lazily and is NOT a package dependency.
        """
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if keys is None:
            keys = self.plotable_keys()
        keys = [k for k in keys if k in self.data]
        if not keys:
            raise ValueError("no plottable series in this history")
        subplots_kw.setdefault("figsize", (7, 2.4 * len(keys)))
        fig, axes = plt.subplots(len(keys), 1, squeeze=False, **subplots_kw)
        sep_kw = dict(color="0.6", linestyle=":", linewidth=0.8) | (sep_kw or {})
        for ax, key in zip(axes[:, 0], keys):
            y = np.asarray(self.data[key], dtype=float)
            x = np.arange(1, y.shape[0] + 1)
            if y.ndim == 1:
                ax.plot(x, y, marker=".", markersize=3)
            else:
                for col in range(y.shape[1]):
                    ax.plot(x, y[:, col], linewidth=0.9)
            if self.restart:
                for r in range(self.restart, y.shape[0], self.restart):
                    ax.axvline(r, **sep_kw)
            pos = y[np.isfinite(y) & (y > 0)]
            if pos.size and (pos.max() / max(pos.min(), 1e-300)) > 1e3:
                ax.set_yscale("log")
            ax.set_ylabel(key)
            ax.grid(True, alpha=0.25)
        axes[-1, 0].set_xlabel("iteration")
        title = "converged" if self.isconverged else "not converged"
        fig.suptitle(f"ConvergenceHistory ({title}, {self.iters} iters)")
        fig.tight_layout()
        return fig

    def plot_all(self, width: int = 60, height: int = 8) -> str:
        """One stacked panel per plottable series — the analogue of the
        reference's whole-history recipe (one subplot per key,
        src/history.jl:269-300).  Scalars and non-numeric entries are
        skipped, like ``plotable`` (src/history.jl:264-265)."""
        panels = []
        for key in sorted(self.data.keys()):
            val = np.asarray(self.data[key])
            if val.ndim != 1 or val.size < 2 or not np.issubdtype(
                val.dtype, np.number
            ):
                continue
            panels.append(self.plot(key, width=width, height=height))
        return ("\n" + "-" * (width + 9) + "\n").join(panels) or "(no series)"
