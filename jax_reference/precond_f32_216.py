"""The JAX package's own preconditioned f32 solves on the CPU: the reference
for the port's ``chip_smoke.py`` phase 16.

    python3 jax_reference/precond_f32_216.py [--side 216] [--ilu-side 100]
                                             [--stat-n 10000]
                                             [--legs NAME ...] [--out FILE]

1. ``benchmarks/tpu_precond_win.py:44-99`` at ``side``^3: CG on
   ``variable_diffusion(side, 3, contrast=1e4, smooth=2, seed=7)`` in f32,
   reltol 1e-5, maxiter 20000, with each leg's chunk: none (256), jacobi
   (256), rbic as ``Pl`` (32), eisenstat (32) and rb_reduced (64).  Each leg
   on b = 1 and on the normal b of ``numpy.random.default_rng(seed)`` for
   seeds 1 and 2 (drawn in f64, rounded to f32); on b = 1 also the same leg
   in f64.
2. ILU(0), natural and multicolor, as ``Pl`` of GMRES(20) on
   ``advection_diffusion(ilu_side)`` in f32 (the factor from its CSR, the
   DIA matrix as the operator, the fixture's b), reltol 1e-5, maxiter 600;
   and the same solve in f64.
3. ``benchmarks/run_all.py:270-296``'s stationary workload: the six
   variants' 20 sweeps on ``random_sparse(n, n, 5 / n, seed=2,
   symmetrize=True, shift=4)`` (n = ``stat_n``) with b = 1 in f32, and the
   same sweeps on the f64 matrix; x's 2-norm, 1-norm and first entries.

Prints one JSON line a run: steps, convergence, the true relative residual
``|b - A x| / |b|`` evaluated in f64, seconds, and for an f32 run with an
f64 twin ``|x - x64| / |x64|``.  Runs through the XLA path the package takes
off the TPU.  Needs JAX; host CPU only.
"""

import argparse
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import iterativesolvers_tpu as its  # noqa: E402
from iterativesolvers_tpu.utils import fixtures  # noqa: E402

LEGS = ("none", "jacobi", "rbic", "eisenstat", "rb_reduced")
CHUNK = {"none": 256, "jacobi": 256, "rbic": 32, "eisenstat": 32,
         "rb_reduced": 64}
SEEDS = (1, 2)
RELTOL, MAXITER = 1e-5, 20000
ILU = dict(restart=20, reltol=1e-5, maxiter=600)
STATIONARY = (("jacobi", (), {}), ("gauss_seidel", (), {}),
              ("sor", (1.1,), {}), ("ssor", (1.1,), {}),
              ("gs_multicolor", (), {"ordering": "multicolor"}),
              ("sor_multicolor", (1.1,), {"ordering": "multicolor"}))
HEAD = 16


def rhs_of(seed, n):
    """b = 1 (seed None) or a normal b from numpy's generator of ``seed``,
    drawn in f64."""
    if seed is None:
        return np.ones(n)
    return np.random.default_rng(seed).standard_normal(n)


def solve_leg(A, side, leg, b):
    """(x, history) of one leg of tpu_precond_win.py on ``A`` (its dtype)."""
    kw = dict(reltol=RELTOL, maxiter=MAXITER, log=True, chunk=CHUNK[leg])
    if leg == "none":
        return its.cg(A, b, **kw)
    if leg == "jacobi":
        d, _ = A.diagonal()
        return its.cg(A, b, Pl=its.DiagonalPreconditioner(d), **kw)
    if leg == "rbic":
        P = its.RedBlackICPreconditioner.from_dia(A, side, 3)
        return its.cg(A, b, Pl=P, **kw)
    if leg == "eisenstat":
        Ah = its.EisenstatSSOROperator.from_dia(A, side, 3)
        xh, h = its.cg(Ah, Ah.rhs_transform(b), **kw)
        return Ah.solution_transform(xh), h
    R = its.RBReducedSystem.from_dia(A, side, 3)
    bb, br = R.reduce_rhs(b)
    xb, h = its.cg(R, bb, **kw)
    return R.expand_solution(xb, br), h


def emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=216)
    ap.add_argument("--ilu-side", type=int, default=100)
    ap.add_argument("--stat-n", type=int, default=10_000)
    ap.add_argument("--legs", nargs="*",
                    default=list(LEGS) + ["ilu", "stationary"])
    ap.add_argument("--out")
    args = ap.parse_args()
    side = args.side
    n = side**3
    legs = [leg for leg in args.legs if leg in LEGS]
    if legs:
        A32, A64 = (fixtures.variable_diffusion(side, 3, contrast=1e4,
                                                smooth=2, seed=7, dtype=dt)
                    for dt in (np.float32, np.float64))
        apply64 = jax.jit(A64.mv)

        def true_res(x, b):
            r = b - np.asarray(apply64(np.asarray(x, np.float64)))
            return float(np.linalg.norm(r) / np.linalg.norm(b))

        for leg in legs:
            x64 = None
            for seed in (None,) + SEEDS:
                b = rhs_of(seed, n)
                runs = (("f64", A64), ("f32", A32)) if seed is None else (
                    ("f32", A32),)
                for label, A in runs:
                    bt = b.astype(A.dtype)
                    t0 = time.perf_counter()
                    x, h = solve_leg(A, side, leg, jnp.asarray(bt))
                    x = np.asarray(x)
                    row = {"workload": "precond_win", "side": side,
                           "leg": leg, "dtype": label,
                           "b": "ones" if seed is None else f"seed {seed}",
                           "iters": h.iters, "converged": h.isconverged,
                           "true_rel_residual": true_res(
                               x, bt.astype(np.float64)),
                           "s": time.perf_counter() - t0}
                    if label == "f64":
                        x64 = x
                    elif seed is None:
                        row["x_rel_diff_f64"] = float(
                            np.linalg.norm(x.astype(np.float64) - x64)
                            / np.linalg.norm(x64))
                    emit(row, args.out)
        del A32, A64
    if "ilu" in args.legs:
        N = args.ilu_side
        for ordering in ("natural", "multicolor"):
            x64 = None
            for dt in (np.float64, np.float32):
                A, b = fixtures.advection_diffusion(N, dtype=dt)
                t0 = time.perf_counter()
                P = its.ILUPreconditioner.from_operator(A.to_csr(),
                                                        ordering=ordering)
                build_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                x, h = its.gmres(A, jnp.asarray(b), Pl=P, log=True, **ILU)
                x = np.asarray(x).astype(np.float64)
                A64, b64 = fixtures.advection_diffusion(N, dtype=np.float64)
                r = b64 - np.asarray(A64.mv(jnp.asarray(x)))
                row = {"workload": "ilu_gmres", "side": N,
                       "ordering": ordering, "nlevels": P.nlevels,
                       "dtype": np.dtype(dt).name[:1] + str(
                           8 * np.dtype(dt).itemsize),
                       "iters": h.iters, "restarts": h.restarts,
                       "converged": h.isconverged,
                       "true_rel_residual": float(np.linalg.norm(r)
                                                  / np.linalg.norm(b64)),
                       "build_s": build_s, "s": time.perf_counter() - t0}
                if dt == np.float64:
                    x64 = x
                else:
                    row["x_rel_diff_f64"] = float(np.linalg.norm(x - x64)
                                                  / np.linalg.norm(x64))
                emit(row, args.out)
    if "stationary" in args.legs:
        n = args.stat_n
        mats = {dt: fixtures.random_sparse(n, n, 5.0 / n, seed=2, dtype=dt,
                                           symmetrize=True, shift=4.0)
                for dt in (np.float32, np.float64)}
        for name, extra, kw in STATIONARY:
            fn = getattr(its, name.replace("gs_", "gauss_seidel_").replace(
                "_multicolor", ""))
            xs = {dt: np.asarray(fn(A, np.ones(n, dt), *extra, maxiter=20,
                                    **kw)).astype(np.float64)
                  for dt, A in mats.items()}
            x32, x64 = xs[np.float32], xs[np.float64]
            r = 1.0 - np.asarray(mats[np.float64].mv(jnp.asarray(x32)))
            emit({"workload": "stationary", "n": n, "method": name,
                  "sweeps": 20, "x_norm2": float(np.linalg.norm(x32)),
                  "x_norm1": float(np.abs(x32).sum()),
                  "x_head": [float(v) for v in x32[:HEAD]],
                  "true_rel_residual": float(np.linalg.norm(r)
                                             / np.sqrt(n)),
                  "x_rel_diff_f64": float(np.linalg.norm(x32 - x64)
                                          / np.linalg.norm(x64))}, args.out)


if __name__ == "__main__":
    main()
