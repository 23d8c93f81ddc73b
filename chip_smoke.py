#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``iterativesolvers_tpu_torch``) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. Card: the ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build: every kernel under ``iterativesolvers_tpu_torch/csrc`` by ``nvcc``.
3. Kernel parity at 216^3 (10,077,696 rows): each kernel against its plain
   PyTorch version on the card, on the same inputs.
4. The main path: CG through ``cg(...)`` on the 216^3 Laplacian over the four
   operator paths of ``bench.py`` (matrix-free stencil; stored DIA with f32,
   bf16 and int8 diagonals).  Each run converges, agrees with the others and
   with an f64 solve, reaches the true residual of the same f32 solve through
   the plain version (no kernel), and launched its kernel once per CG step,
   masked steps included.
5. Timing with CUDA events: CG per-iteration time on each path (504- minus
   248-iteration solves, as ``bench.py``), and each kernel beside its byte
   bound, its plain version and ``torch.sparse`` CSR SpMV of the same matrix.
6. Trace: one 504-step solve per path under ``torch.profiler``: the device's
   busy time and share of the solve, and the kernels that take it.

It prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
It imports no JAX and nothing of the JAX package.
"""

import json
import statistics
import subprocess
import sys
import time

SIDE = 216
RELTOL = 1e-5
CHUNK = 256
# True relative residual |b - A x| / |b|, evaluated in f64.  The recurrence
# residual of an f32 CG solve reaches reltol, but on this system its true
# residual stops near 3e-3: the solution is ~1e3 against b = 1, so each f32
# product and update rounds at ~1e-4 of |b|, and the recurrence drifts from
# the true residual over ~400 steps (the script prints the floor of rounding
# the f64 solution to f32 alone).  So the f32 paths are held to 1e-2, and
# the same solve in f64 to 1e-3.  A second witness: the f32 solve through
# the plain version (no kernel) stops at the same floor, and each kernel
# path must come within PLAIN_RES_FACTOR of it.
TRUE_RES_F32 = 1e-2
TRUE_RES_F64 = 1e-3
PLAIN_RES_FACTOR = 1.1
# |x - x64| / |x64| of every f32 solution against the f64 solve: the
# solutions are far closer than their residuals suggest (about 1.5e-6 with
# the kernels and 3.2e-6 through the plain version on an H100)
X_F64_REL = 1e-5
# f32 y: FMA contraction in the kernel changes the rounding against the plain
# version; a dot is summed in another order; bf16 keeps 8 mantissa bits and
# rounds at other points.
TOL_Y_F32 = 1e-6
TOL_DOT = 1e-5
TOL_Y_BF16 = 2e-2
# NVIDIA's data sheet for the H100 SXM, the card this was written for:
# memory rate (bytes/s) and f32 rate outside the tensor cores (FLOP/s), at
# the full 700 W power limit
H100_SXM = ("H100 80GB HBM3", 3.35e12, 67e12)


def time_ms(torch, fn, reps=20, batches=5):
    """Device time of one call of ``fn``: the median over ``batches`` of the
    mean over ``reps`` back-to-back calls, after one warm-up; and the batch
    means themselves."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples), samples


def check(name, got, want, tol, kind="y"):
    """Max abs error of ``got`` against ``want``; raises past ``tol`` times
    max|want| (``kind="y"``) or |want| (``kind="dot"``)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"  {name}: max_abs_err {err:.3e} (limit {tol * scale:.3e})")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: error {err} > {tol} * {scale}")
    return err


def laplace_csr(torch, A):
    """The DIA matrix ``A`` as an f32 torch CSR tensor (for library_ms)."""
    n = A.shape[0]
    i = torch.arange(n, device="cuda")
    cols = torch.stack([i + o for o in A.offsets], dim=1)
    vals = torch.stack([d.float() for d in A.diags], dim=1)
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], (n, n),
                                   check_invariants=False)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
                 "drives the port on a GPU and has nothing to run here")

    from torch.profiler import ProfilerActivity, profile

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.ops import _build
    from iterativesolvers_tpu_torch.ops.cuda_spmv import (
        dia_spmv, dia_spmv_dot, dia_spmv_plain)
    from iterativesolvers_tpu_torch.ops.cuda_stencil import (
        stencil_apply, stencil_apply_plain)
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps
    from iterativesolvers_tpu_torch.utils.fixtures import laplace_dia

    # ---- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {kind}")
    if H100_SXM[0] not in kind:
        raise RuntimeError(f"the bounds use H100 SXM rates; this is {kind!r}")
    _, bw, flops = H100_SXM

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, {sorted(libs)}")

    # ---- 3. kernel parity at 216^3 ----------------------------------------
    print("parity at 216^3:")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = SIDE**3
    x32 = torch.randn(n, generator=g, device="cuda")
    err = {}
    for label, St in (("laplacian", its.laplacian(SIDE, 3)),
                      ("advection_diffusion",
                       its.advection_diffusion_stencil(SIDE))):
        args = (St.n, St.center, St.terms, St.coeffs)
        for dt, tol in ((torch.float32, TOL_Y_F32), (torch.bfloat16, TOL_Y_BF16)):
            x = x32.to(dt)
            tag = f"stencil {label} {str(dt)[6:]}"
            check(f"{tag} mv", St.mv(x), stencil_apply_plain(*args, x), tol)
            check(f"{tag} rmv", St.rmv(x),
                  stencil_apply_plain(*args, x, conj=True), tol)
            y, d = St.mv_dot(x)
            yp, dp = stencil_apply_plain(*args, x, with_dot=True)
            e = check(f"{tag} mv_dot y", y, yp, tol)
            check(f"{tag} mv_dot dot", d, dp, TOL_DOT, kind="dot")
            if label == "laplacian" and dt == torch.float32:
                err["stencil"] = e
    A = laplace_dia(SIDE, 3, dtype="float32")
    dias = {"f32": A, "bf16": its.compress_values(A, torch.bfloat16),
            "int8": its.compress_values(A, torch.int8)}
    for label, Ad in dias.items():
        if label != "f32" and Ad.dtype == torch.float32:
            raise AssertionError(f"compress_values kept f32 for {label}")
        check(f"dia_spmv {label}", dia_spmv(Ad.diags, Ad.offsets, x32),
              dia_spmv_plain(Ad.diags, Ad.offsets, x32), TOL_Y_F32)
        y, d = dia_spmv_dot(Ad.diags, Ad.offsets, x32, x32)
        yp, dp = dia_spmv_plain(Ad.diags, Ad.offsets, x32, x32)
        err[label] = check(f"dia_spmv_dot {label} y", y, yp, TOL_Y_F32)
        check(f"dia_spmv_dot {label} dot", d, dp, TOL_DOT, kind="dot")
    torch.cuda.synchronize()

    # ---- 4. the main path: CG at 216^3 on the four operator paths ---------
    St = its.laplacian(SIDE, 3)
    paths = {"stencil": St, "dia_f32": dias["f32"], "dia_bf16": dias["bf16"],
             "dia_int8": dias["int8"]}
    counters = (stencil_apply, dia_spmv, dia_spmv_dot)
    b = torch.ones(n, device="cuda")
    A64 = A.astype(torch.float64)

    def true_res(x):
        b64 = b.double()
        r = b64 - A64.mv(x.double())
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))

    def rel_diff(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    runs, secs = {}, {}
    print(f"CG on the {SIDE}^3 Laplacian, reltol {RELTOL}:")
    x64, h64 = its.cg(A64, b.double(), reltol=RELTOL, log=True, chunk=CHUNK)
    print(f"  f64 DIA (plain path): {h64}, true relative residual "
          f"{true_res(x64):.3e}")
    if not (h64.isconverged and true_res(x64) <= TRUE_RES_F64):
        raise AssertionError("f64 CG did not reach the true residual")
    print(f"  f32 floor: the f64 solution rounded to f32 has true relative "
          f"residual {true_res(x64.float()):.3e}")
    # the same f32 solve with the f32 DIA product of the plain version: it
    # launches no kernel, and its true residual is the floor of f32 CG here
    plain_op = its.FunctionOperator(
        lambda v: dia_spmv_plain(A.diags, A.offsets, v), A.shape,
        torch.float32)
    for f in counters:
        f.launches = 0
    x_pl, h_pl = its.cg(plain_op, b, reltol=RELTOL, log=True, chunk=CHUNK)
    res_pl = true_res(x_pl)
    print(f"  f32 DIA through the plain version: {h_pl}, true relative "
          f"residual {res_pl:.3e}, |x - x64| / |x64| {rel_diff(x_pl, x64):.3e}")
    if any(f.launches for f in counters):
        raise AssertionError("the plain-version solve launched a kernel")
    if not (h_pl.isconverged and res_pl <= TRUE_RES_F32):
        raise AssertionError("f32 CG through the plain version did not reach "
                             "the true residual")
    for name, op in paths.items():
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        x, h = its.cg(op, b, reltol=RELTOL, log=True, chunk=CHUNK)
        torch.cuda.synchronize()
        secs_run = time.perf_counter() - t0
        counts = {f.__name__: f.launches for f in counters}
        steps = chunked_steps(h.iters, CHUNK)
        kernel = "stencil_apply" if name == "stencil" else "dia_spmv_dot"
        want = {f.__name__: (steps if f.__name__ == kernel else 0)
                for f in counters}
        rel, err64 = true_res(x), rel_diff(x, x64)
        print(f"  {name}: {h}, {secs_run:.3f} s, true relative residual "
              f"{rel:.3e} (plain version {res_pl:.3e}), |x - x64| / |x64| "
              f"{err64:.3e}, launches {counts} for {steps} steps")
        if not h.isconverged:
            raise AssertionError(f"CG did not converge on {name}")
        if not (rel <= min(TRUE_RES_F32, PLAIN_RES_FACTOR * res_pl)
                and torch.isfinite(x).all()):
            raise AssertionError(f"{name}: true relative residual {rel}")
        if not err64 <= X_F64_REL:
            raise AssertionError(f"{name}: |x - x64| / |x64| = {err64}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        runs[name] = (x, h, counts[kernel])
        secs[name] = secs_run
    x_st, h_st, _ = runs["stencil"]
    for name, (x, h, _) in runs.items():
        diff = rel_diff(x, x_st)
        print(f"  {name} vs stencil: iters {h.iters} vs {h_st.iters}, "
              f"relative solution difference {diff:.3e}")
        if abs(h.iters - h_st.iters) > 2 or not diff <= 1e-4:
            raise AssertionError(f"{name} disagrees with the stencil path")

    # ---- 5. timing --------------------------------------------------------
    samples = {}

    def timed(label, fn, reps=20, batches=5):
        ms, samples[label] = time_ms(torch, fn, reps, batches)
        return ms

    def solve(op, maxiter):
        # no convergence: exactly maxiter steps, as bench.py times them
        return its.cg(op, b, reltol=0.0, abstol=1e-30, maxiter=maxiter,
                      chunk=CHUNK)

    per_iter = {}
    for name, op in paths.items():
        t_long = timed(f"cg {name} maxiter=504", lambda: solve(op, 504), 1)
        t_short = timed(f"cg {name} maxiter=248", lambda: solve(op, 248), 1)
        per_iter[name] = (t_long - t_short) / (504 - 248) * 1e3
    print(json.dumps({
        "cg_us_per_iter": per_iter, "timed_iters": 504 - 248,
        "cg_to_reltol": {k: {"iters": h.iters, "s": secs[k]}
                         for k, (_, h, _) in runs.items()},
        "n": n, "device": kind}))

    # ---- 6. trace: where the time of a CG step goes ------------------------
    # one profiled 504-step solve per path; the device's busy time is the sum
    # of its kernels' times, set against the untimed solve's median above
    trace = {}
    for name, op in paths.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve(op, 504)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name[:60]
                by_kernel[key] = (by_kernel.get(key, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
        if not by_kernel:
            raise AssertionError(f"the trace of {name} holds no device time")
        busy = sum(by_kernel.values())
        wall = statistics.median(samples[f"cg {name} maxiter=504"])
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        trace[name] = {"steps": 504, "wall_ms": wall,
                       "traced_wall_ms": traced_ms, "device_busy_ms": busy,
                       "busy_share": busy / wall, "top_device_ms": dict(top)}
    print(json.dumps({"trace": trace}))

    csr = laplace_csr(torch, A)
    library_ms = timed("torch.sparse CSR @ x", lambda: csr @ x32)
    nnz_off = sum(n - abs(o) for o in A.offsets if o != 0)
    kernels = [{
        "name": "stencil_apply",
        "route": "cuda",
        "source": "iterativesolvers_tpu_torch/csrc/stencil.cu",
        "replaces": "iterativesolvers_tpu/ops/pallas_stencil.py:230",
        "launches": runs["stencil"][2],
        "max_abs_err": err["stencil"],
        "ms": timed("stencil_apply", lambda: St.mv_dot(x32)),
        "plain_ms": timed("stencil_apply plain", lambda: stencil_apply_plain(
            St.n, St.center, St.terms, St.coeffs, x32, with_dot=True),
            reps=5),
        # read x, write y; one FMA per product (center included), the dot's
        "bytes": 8 * n,
        "flops": 2 * (n + nnz_off) + 2 * n,
        "library_ms": library_ms,
    }]
    for label in ("f32", "bf16", "int8"):
        Ad = dias[label]
        kernels.append({
            "name": f"dia_spmv_dot[{label} diagonals]",
            "route": "cuda",
            "source": "iterativesolvers_tpu_torch/csrc/dia_spmv.cu",
            "replaces": "iterativesolvers_tpu/ops/pallas_spmv.py:149",
            "launches": runs[f"dia_{label}"][2],
            "max_abs_err": err[label],
            "ms": timed(f"dia_spmv_dot {label}", lambda: Ad.mv_dot(x32)),
            "plain_ms": timed(f"dia_spmv_dot {label} plain",
                              lambda: dia_spmv_plain(Ad.diags, Ad.offsets,
                                                     x32, x32), reps=5),
            # every diagonal, x (= u) once, y once; one FMA per in-range
            # product and the dot's FMA
            "bytes": sum(d.numel() * d.element_size() for d in Ad.diags)
            + 8 * n,
            "flops": 2 * (n + nnz_off) + 2 * n,
            "library_ms": library_ms,
        })
    for k in kernels:
        byte_ms = k.pop("bytes") / bw * 1e3
        op_ms = k.pop("flops") / flops * 1e3
        k["bound_ms"] = max(byte_ms, op_ms)
        k["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    print(json.dumps({"timing_samples_ms": samples}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
