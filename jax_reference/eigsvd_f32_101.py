"""The JAX package's own LOBPCG and svdl at 101^3 in f32, on the CPU: the
reference for the port's ``chip_smoke.py`` phase 14.

    python3 jax_reference/eigsvd_f32_101.py [--side 101] [--runs NAME ...]

``lobpcg``: the 16 smallest eigenpairs of ``laplace_dia(side, 3)`` (f32 and
int8 diagonals), tol 1e-4, at most 150 iterations, X0 normal from numpy's
``default_rng(0)`` (``benchmarks/tpu_eigen_bench.py:37-57``).  ``svdl``: the
6 largest singular values of ``GradientOperator((side,) * 3)``, tol 1e-3, at
most 100 restarts, start from ``PRNGKey(0)``
(``benchmarks/tpu_svdl_1m_gradient.py:38-50``).  Each through the XLA path
the package takes off the TPU.  Prints one JSON line per run: iterations,
whether it converged, and the values against their analytic counterparts.
Needs JAX; host CPU only.
"""

import argparse
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import iterativesolvers_tpu as its  # noqa: E402
from iterativesolvers_tpu.utils import fixtures  # noqa: E402

RUNS = ("lobpcg_f32", "lobpcg_int8", "svdl_gradient")


def lobpcg(side, tag):
    A = fixtures.laplace_dia(side, 3, dtype=np.float32)
    if tag == "int8":
        A = its.compress_values(A)
    n = A.shape[0]
    X0 = np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32)
    lam_true = 3 * 2 * (1 - np.cos(np.pi / (side + 1)))
    r = its.lobpcg(A, X0, largest=False, tol=1e-4, maxiter=150)
    lam0 = float(np.asarray(r.lam)[0])
    return {"iters": r.iterations, "converged": r.converged, "lam0": lam0,
            "lam0_analytic": lam_true,
            "lam0_rel_err": abs(lam0 - lam_true) / lam_true,
            "max_residual_norm": float(np.max(np.asarray(r.residual_norms))),
            "lam": [float(v) for v in np.asarray(r.lam)]}


def svdl(side):
    G = its.GradientOperator((side,) * 3, dtype=np.float32)
    vals, L, h = its.svdl(G, nsv=6, tol=1e-3, maxiter=100, log=True,
                          key=jax.random.PRNGKey(0))
    lam_ax = 4 * np.sin((side - 1) * np.pi / (2 * side)) ** 2
    sig_max = float(np.sqrt(3 * lam_ax))
    sv = [float(v) for v in np.asarray(vals)]
    return {"iters": h.iters, "converged": h.isconverged, "values": sv,
            "sigma_max_analytic": sig_max,
            "sigma_max_rel_err": abs(sv[0] - sig_max) / sig_max}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=101)
    ap.add_argument("--runs", nargs="*", default=list(RUNS), choices=RUNS)
    args = ap.parse_args()
    for name in args.runs:
        t0 = time.perf_counter()
        row = (svdl(args.side) if name == "svdl_gradient"
               else lobpcg(args.side, name.split("_")[1]))
        row["cpu_s"] = time.perf_counter() - t0
        print(json.dumps({name: row}), flush=True)


if __name__ == "__main__":
    main()
