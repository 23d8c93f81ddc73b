"""The JAX package's own f32 CG on the 216^3 Laplacian, on the CPU.

    python3 jax_reference/cg_f32_216.py [--side 216] [--out FILE]

Runs ``iterativesolvers_tpu.cg`` on ``laplacian(side, 3)`` with b = 1 and
``reltol=1e-5`` in f32, and the same solve in f64 (x64 enabled), through the
XLA path the package takes off the TPU (no Pallas kernel, no interpret
mode).  Prints one JSON line: the steps of each solve, the true relative
residual ``|b - A x| / |b|`` of each (evaluated in f64) and the f32
solution's ``|x - x64| / |x64|``.  This is the reference's own f32 floor on
the system the port's ``chip_smoke.py`` solves; it needs JAX and runs on the
host CPU only.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=216)
    ap.add_argument("--reltol", type=float, default=1e-5)
    ap.add_argument("--out")
    args = ap.parse_args()
    n = args.side**3
    A32 = its.laplacian(args.side, 3, dtype=np.float32)
    A64 = its.laplacian(args.side, 3, dtype=np.float64)
    apply64 = jax.jit(A64.mv)
    b64 = np.ones(n, np.float64)

    def true_res(x):
        r = b64 - np.asarray(apply64(np.asarray(x, np.float64)))
        return float(np.linalg.norm(r) / np.linalg.norm(b64))

    out = {"side": args.side, "n": n, "reltol": args.reltol,
           "backend": jax.default_backend()}
    for label, A in (("f64", A64), ("f32", A32)):
        t0 = time.perf_counter()
        x, h = its.cg(A, np.ones(n, A.dtype), reltol=args.reltol, log=True)
        x = np.asarray(x)
        out[label] = {"iters": h.iters, "converged": h.isconverged,
                      "true_rel_residual": true_res(x),
                      "s": time.perf_counter() - t0}
        out[f"x_{label}"] = x
    x32, x64 = out.pop("x_f32").astype(np.float64), out.pop("x_f64")
    out["f32"]["x_rel_diff_f64"] = float(np.linalg.norm(x32 - x64)
                                         / np.linalg.norm(x64))
    out["f64_rounded_to_f32_true_rel_residual"] = true_res(
        x64.astype(np.float32))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
