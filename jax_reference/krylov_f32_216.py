"""The JAX package's own MINRES, pipelined CG, Chebyshev, QMR, BiCGStab(2),
IDR(8) and power method at 216^3 in f32, on the CPU: the reference for the
port's ``chip_smoke.py`` phase 13.

    python3 jax_reference/krylov_f32_216.py [--side 216] [--runs NAME ...]
                                            [--out FILE]

Each run as phase 13 makes it, through the XLA path the package takes off
the TPU: MINRES, pipelined CG, QMR, BiCGStab(2) and IDR(8) on the
Laplacian stencil with b = 1 (reltol 1e-5, at most 1000 steps; 4000
products for BiCGStab), pipelined CG, IDR(8) and Chebyshev (with its
Gershgorin bounds) on the shifted Laplacian (center 7), QMR, BiCGStab(2) and IDR(8)
on the advection-diffusion stencil (beta = 1000) with the fixture's b for
248 steps (l-cycles), powm on the Laplacian for 248 steps from a normal
start.
Prints one JSON line per run: steps, whether it converged, the true
relative residual evaluated in f64 and, on the Laplacian with b = 1,
``|x - x64| / |x64|`` against the f64 CG solve.  Needs JAX; host CPU only.
"""

import argparse
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import iterativesolvers_tpu as its  # noqa: E402
from iterativesolvers_tpu.utils import fixtures  # noqa: E402

CAP = 248
RUNS = ("minres", "pipelined_cg", "pipelined_cg_shifted", "chebyshev",
        "qmr_laplacian", "bicgstabl_laplacian", "idrs_laplacian",
        "idrs_shifted", "qmr", "bicgstabl", "idrs", "powm")


def advection_rhs(N):
    """The fixture's b (utils/fixtures.advection_diffusion), without its
    DIA matrix."""
    xs = np.linspace(0.0, 1.0, N + 2)[1:N + 1]
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    F = (np.exp(X * Y * Z) * np.sin(np.pi * X) * np.sin(np.pi * Y)
         * np.sin(np.pi * Z))
    return F.reshape(-1, order="F")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=216)
    ap.add_argument("--runs", nargs="*", default=list(RUNS))
    ap.add_argument("--out")
    args = ap.parse_args()
    N = args.side
    n = N**3
    St32, St64 = (its.laplacian(N, 3, dtype=dt)
                  for dt in (np.float32, np.float64))
    Sh32, Sh64 = (its.StencilOperator(n, 7.0, St32.terms, [-1.0] * 6,
                                      dtype=dt)
                  for dt in (np.float32, np.float64))
    Ad32, Ad64 = (its.advection_diffusion_stencil(N, dtype=dt)
                  for dt in (np.float32, np.float64))
    b1 = np.ones(n, np.float32)
    b_adv = advection_rhs(N).astype(np.float32)
    x64 = None
    if any(r in ("minres", "pipelined_cg") or r.endswith("_laplacian")
           for r in args.runs):
        x64 = np.asarray(its.cg(St64, np.ones(n), reltol=1e-5))
    lmin, lmax = its.gershgorin_bounds(Sh32)
    x0 = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    x0 /= np.linalg.norm(x0)
    conv = dict(reltol=1e-5, maxiter=1000, log=True)
    cases = {
        "minres": (lambda: its.minres(St32, b1, **conv), St64, b1),
        "pipelined_cg": (lambda: its.pipelined_cg(St32, b1, **conv), St64,
                         b1),
        "pipelined_cg_shifted": (lambda: its.pipelined_cg(Sh32, b1, **conv),
                                 Sh64, b1),
        "qmr_laplacian": (lambda: its.qmr(St32, b1, **conv), St64, b1),
        "bicgstabl_laplacian": (lambda: its.bicgstabl(
            St32, b1, 2, reltol=1e-5, max_mv_products=4000, log=True), St64,
            b1),
        "idrs_laplacian": (lambda: its.idrs(St32, b1, s=8, **conv), St64,
                           b1),
        "idrs_shifted": (lambda: its.idrs(Sh32, b1, s=8, **conv), Sh64, b1),
        "chebyshev": (lambda: its.chebyshev(Sh32, b1, lmin, lmax, **conv),
                      Sh64, b1),
        "qmr": (lambda: its.qmr(Ad32, b_adv, maxiter=CAP, log=True), Ad64,
                b_adv),
        "bicgstabl": (lambda: its.bicgstabl(Ad32, b_adv, 2,
                                            max_mv_products=4 * CAP,
                                            log=True), Ad64, b_adv),
        "idrs": (lambda: its.idrs(Ad32, b_adv, s=8, maxiter=CAP, log=True),
                 Ad64, b_adv),
    }
    apply64 = {id(op): jax.jit(op.mv) for op in (St64, Sh64, Ad64)}
    lines = []
    for name in args.runs:
        t0 = time.perf_counter()
        if name == "powm":
            lam, x, h = its.powm(St32, x0=x0, tol=0.0, maxiter=CAP - 1,
                                 log=True)
            row = {"run": name, "iters": h.iters,
                   "rayleigh_quotient": float(lam),
                   "lambda_max": 6 + 6 * np.cos(np.pi / (N + 1))}
        else:
            solve, op64, b = cases[name]
            x, h = solve()
            x = np.asarray(x, np.float64)
            r = b - np.asarray(apply64[id(op64)](x))
            row = {"run": name, "iters": h.iters,
                   "converged": h.isconverged,
                   "true_rel_residual": float(np.linalg.norm(r)
                                              / np.linalg.norm(b))}
            if op64 is St64:
                row["x_rel_diff_f64"] = float(np.linalg.norm(x - x64)
                                              / np.linalg.norm(x64))
        row.update(side=N, s=time.perf_counter() - t0)
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
