#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``iterativesolvers_tpu_torch``) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. Card: the ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build: every kernel under ``iterativesolvers_tpu_torch/csrc`` by ``nvcc``;
   ``ptxas -v``'s registers, stack frame and spills of the sweep kernels
   (panel MGS, the fused Arnoldi step), none of which may spill or use a
   stack, and of every instance of the DIA and stencil kernels, none of
   which may spill.
3. Kernel parity at 216^3 (10,077,696 rows): each kernel against its plain
   PyTorch version on the card, on the same inputs; f32 ``stencil_apply``'s
   y against ``dia_spmv``'s on f32, bf16 and int8 diagonals, bit for bit;
   each kernel with a dot twice on the same inputs, the same bits.
4. The main path: CG through ``cg(...)`` on the 216^3 Laplacian over the four
   operator paths of ``bench.py`` (matrix-free stencil; stored DIA with f32,
   bf16 and int8 diagonals).  Each run converges, agrees with the others and
   with an f64 solve, reaches the true residual of the same f32 solve through
   the plain version (no kernel), and launched its kernel once per CG step,
   masked steps included.  Then the spread of sound orders of CG's dot (the
   kernel's, torch.sum's, an f64 sum) on b = 1 and two seeded b, each within
   the limits set from it, and a control (a dot without one block's rows)
   that the limits must reject.
5. Timing with CUDA events: CG per-iteration time on each path (504- minus
   248-iteration solves, as ``bench.py``), and each kernel beside its byte
   bound, its plain version and ``torch.sparse`` CSR SpMV of the same matrix.
6. Trace: one 504-step solve per path under ``torch.profiler``: the device's
   busy time and share of the solve, and the kernels that take it.
7. GMRES kernel parity at 216^3: panel MGS, the panel stencil SpMV and the
   fused Arnoldi step against their plain versions, on f32 and bf16 panels;
   the two sweep kernels also on half their grid (part of the working
   vector then spills to device memory) and twice on the same inputs (the
   same bits).
8. The GMRES main path: ``gmres(...)`` GMRES(20) on the 216^3 Laplacian, the
   workload of ``bench.py``'s second metric (reltol 0, 500 and 240 steps),
   on five routes: stencil with a bf16 panel (the headline) and an f32 panel
   (the fused kernel), stored DIA with f32, bf16 and int8 diagonals and a
   bf16 panel.  Per-iteration time, true residual, launches per step and per
   cycle, and the witness: the same stencil solves with the kernels routed
   off through the solver's dispatch functions, and the spread of the
   500-step solves over runs that change only their rounding.
9. Converging solves on the shifted Laplacian (center 7): f32 panel (fused),
   bf16 panel (two kernels), and the stored f32 DIA matrix, each against its
   witness.
10. The fused step against the two-kernel route, and bf16 against f32
    panels: per-iteration time of each, in turns on one card.
11. Timing of every kernel beside its bound, its plain version and a
    library call where one computes the same function (the DIA and stencil
    kernels also with their device time, one call between CUDA events
    behind a sleep kernel, and their wrapper's host time a call); a
    ``torch.profiler`` trace of GMRES steps.
12. Distributed: the two CGS2 sweeps (``panel_dots``, ``panel_update``)
    against their plain versions and timed at the D = 2 shard shape; then
    two rank processes of this script (``--dist-rank``, started here) on the
    one card over gloo run GMRES(20) at reltol 0 on the row-sharded 216^3
    stencil with its launch counts, its witness (the sweeps' plain
    versions), its step time and a trace; converging GMRES(10) on the
    shifted Laplacian (f32 and bf16 panels) and CG, each against its witness
    and the single-card solves of phases 4 and 9; and pipelined CG on the
    shifted Laplacian, one allreduce a step (CG's three counted beside it),
    against the same solve on one card.
13. The Krylov solvers at 216^3 through their public calls: MINRES (on the
    stencil and the int8 DIA matrix), QMR and BiCGStab(2) on the Laplacian,
    held to the JAX package's own f32 runs; pipelined CG (stencil and int8
    DIA), IDR(8) and Chebyshev (Gershgorin bounds) on the shifted
    Laplacian; powm on the Laplacian against its analytic lambda_max; and
    the runs that f32 leaves rounding-bound in both packages, recorded:
    pipelined CG and IDR(8) on the Laplacian, QMR, BiCGStab(2) and IDR(8)
    on the advection-diffusion stencil.  Each with its launches (one kernel a
    product), true residual, kernel-free witness, time a step and the
    card's busy share.
14. The row-panel products and the block, least-squares, eigen and SVD
    solvers: ``mv_rows`` of a (16, n) panel on the 216^3 and 101^3 stencils
    and the 101^3 f32 and int8 DIA matrices (the kernel once a row, each row
    the same bits as ``mv`` of it, against the plain batched version, both
    timed); block CG with 8 right-hand sides on the 216^3 stencil; LOBPCG
    (16 smallest) on the 101^3 DIA matrix, f32 and int8 diagonals; svdl (6
    largest) on the 101^3 gradient (3,090,903 x 1,030,301, no kernel) and
    the 216^3 stencil; LSQR and LSMR on the shifted 216^3 stencil and the
    damped 101^3 gradient.  Each against its analytic values or an f64
    solve and a kernel-free witness, with its launches, time a step, host
    synchronisations and the card's busy share.
15. The stored formats: the 216^3 Laplacian's COO triplets through the
    native sort into ``CSRMatrix`` (equal to the numpy version), its CSR,
    ELL and HYB products against the DIA kernel's, ``auto_format`` back to
    ``laplace_dia``'s diagonals bit for bit, CG on that DIA matrix (phase
    4's steps and x, the DIA kernel once a step) and on the CSR itself;
    the JAX package's three 1M-row format-selection matrices (DIA, ELL
    after RCM, BSR picked, CG converged, the true residual and each pick's
    product held against the eager CSR's, a DIA pick's also against the
    plain version); a 27-point stencil at 100^3 whose DIA pick takes the
    DIA kernel in two launches a product; its MatrixMarket corpus (the
    native parse against the Python parser, CG / GMRES(60) / LSQR / LSMR /
    BSR CG in f32 and f64 with their bars, the picks); its sprand
    GMRES(15), LSQR / LSMR and svdl on a 600,000 x 400,000 BSR matrix
    against scipy's ``svds`` (in a process of its own).  Each product timed
    beside its byte bound and cuSPARSE's ``A @ x``, the same bits on two
    runs; each solve's time a step and busy share.
16. The preconditioners, the reduced system and the stationary methods:
    ``tpu_precond_win.py``'s CG legs on the 216^3 variable-diffusion f32
    DIA matrix (none, Jacobi, RB-IC as ``Pl``, Eisenstat, the reduced
    system and its 25-diagonal DIA form, two launches a product) on b = 1
    and two seeded b, each held to the JAX package's own f32 run on a CPU
    (``jax_reference/precond_f32_216.py``) and to its f64 twin on the card;
    CG on the int8 216^3 Laplacian with and without RB-IC; LOBPCG with
    IC(0) (natural, multicolor) and RB-IC at 101^3 against the analytic
    eigenvalues; ILU(0) GMRES(20) (natural, multicolor) at 100^3 and IC(0)
    GMRES(20) on a ``.mtx`` Laplacian; the six stationary variants on the
    10k sprand matrix and Gauss-Seidel / SOR(1.1), natural and multicolor,
    at 216^3 against f64 sweeps; two rank processes on the card over gloo
    (started early, building while the card works) running CG with the
    shard-local block-Jacobi IC(0) against one card's IC(0) of the same
    block-diagonal matrix (built and run by a third process), and the
    reduced system's DIA form in a halo operator against the one-card
    solve.  Each run with its launches held
    to the expected set, true residual in f64 through a kernel-free
    product, time a step, the card's busy share of its first 64 steps and
    its builders' host seconds; the eager level sweep (us a level) and
    shift passes against their byte bounds.
17. The rest of ``parallel/``: two rank processes (``--mesh-rank``) on the
    card over gloo run ``mv_rows`` of a (16, n) panel through the halo
    stencil (the stencil kernel once a row a rank, one exchange a panel)
    and the halo DIA operator at 216^3, each rank's rows against one card's
    ``mv_rows``; block CG (k = 8) at 216^3; LOBPCG (16 smallest) on the
    100^3 stencil; svdl (6 largest) at 216^3; LSQR and LSMR on the shifted
    216^3 stencil; CG on phase 15's 1M-row scrambled ELL pick and LSQR on
    the 100^3 gradient's ELL (with its adjoint and with the reduce-scatter
    adjoint) through ``RowShardedELLOperator``; GMRES(20) on an 8191 x 8191
    dense f32 ``DenseMeshOperator`` (the padded last shard, the CGS2
    kernels) with its witness; CG through ``shard_dia`` (the halo DIA
    operator itself) and through ``shard_ell`` (the ELL operator itself)
    beside one card's CG on the same ELL matrix; then four ranks
    (``--slice-rank``) on a (2, 2) ``slice_mesh`` run CG at 216^3 with its
    all-reduces counted at both levels.  Each run against the same run on
    one card made in the phase, its f64 or analytic reference and true
    residual, with its launches, collectives a step, ms a step and the
    ranks' set-up seconds; ``measure_bandwidth``'s triad beside the data
    sheet's 3.35 TB/s.

It prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
It imports no JAX and nothing of the JAX package.
"""

import argparse
import contextlib
import json
import math
import pathlib
import re
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
# |x - x64| / |x64| of every f32 solution against the f64 solve, set from
# the spread of sound summation orders of CG's dot (phase 4, PERF.md): on an
# H100, f32 CG at 216^3 ends 1.48e-6 (the first design's order), 6.8e-6
# (the kernels' free grid), 1.30e-5 (an f64 sum) and 2.67e-5 (torch.sum)
# from x64, and the JAX package's own f32 CG (CPU) 2.84e-5: twice the
# largest.  Its steps follow the last bits of the dot and of the stencil's
# sum: 408-419 over those orders (JAX 409), 474 on the bf16 DIA path's own
# grid, 476 with the stencil summed center first; paths, orders and
# witnesses agree within 1.5 times that width (68 steps).
X_F64_REL = 6e-5
CG_STEP_SPREAD = 100
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


# cycles of the sleep kernel that holds the stream while the host enqueues
# one timed call (~1 ms on an H100: more than a wrapper's host time)
BLOCKER_CYCLES = 2_000_000


def kernel_timing(torch, fn, reps=20, host_reps=50):
    """``{"ms", "device_ms", "host_us", "samples"}`` of one call of ``fn``:
    ``ms`` and ``samples`` as :func:`time_ms` (wrapper and kernel: the host
    may set the pace); ``device_ms`` the median of ``reps`` single calls,
    each between two CUDA events recorded behind a sleep kernel, so that the
    host has enqueued the call before the card reaches it (every kernel the
    call launches included); ``host_us`` the host time of one call,
    ``host_reps`` calls enqueued without a synchronisation."""
    ms, samples = time_ms(torch, fn, reps)
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(BLOCKER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    device = statistics.median(a.elapsed_time(b) for a, b in pairs)
    t0 = time.perf_counter()
    for _ in range(host_reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"ms": ms, "device_ms": device, "host_us": host / host_reps * 1e6,
            "samples": samples}


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


# a trace that comes back with no device time is taken again, up to this
# many times in all: CUPTI at times hands back a whole session with no device
# activity (a 24-step trace of pipelined CG on the H100, PERF.md)
TRACE_TRIES = 3


def profiled(torch, fn, name, mesh=None):
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity):
    (result, device time (ms) by kernel name cut to 60 characters).  A trace
    that holds no device time is taken again, up to TRACE_TRIES runs, then
    raises.  With a ``mesh``, rank 0 traces and the other ranks run ``fn``
    untraced for its collectives; the ranks agree on a retry through one
    all-reduce, and the others get None for the device times."""
    from torch.profiler import ProfilerActivity, profile

    tracing = mesh is None or mesh.rank == 0
    for _ in range(TRACE_TRIES):
        by_kernel = None
        if tracing:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    key = e.name[:60]
                    by_kernel[key] = (by_kernel.get(key, 0.0)
                                      + e.time_range.elapsed_us() / 1e3)
        else:
            out = fn()
        again = tracing and not by_kernel
        if mesh is not None:
            flag = torch.tensor([float(again)], device="cuda")
            again = bool(mesh.all_reduce(flag).item())
        if not again:
            return out, by_kernel
        print(f"  (the trace of {name} holds no device time: taken again)",
              flush=True)
    raise AssertionError(f"the trace of {name} holds no device time "
                         f"in {TRACE_TRIES} runs")


# ---- the dot's rounding: the spread of sound orders (phase 4) ---------------
# f32 CG at 216^3 follows the last bits of <u, Au>: the same y with another
# sound summation order takes other steps and ends elsewhere within f32's
# reach.  Phase 4 runs f32 CG with the stencil's y and each of these dots, on
# b = 1 and on normal b from torch.Generator seeds SPREAD_B_SEEDS, each
# against the f64 solve of its b; and a control whose dot drops the rows of
# one block of the kernel's grid, which the limits must reject.
SPREAD_B_SEEDS = (1, 2)
SOUND_ORDERS = ("kernel", "torch.sum", "f64 sum")
# a solve that has not converged by then has failed (the sound ones take
# ~410 steps)
SPREAD_MAXITER = 1000


def dot_orders(torch, St, grid):
    """name -> dot(u, y) of the spread: None for the kernel's own (the
    stencil's ``mv_dot``), torch.sum's, an f64 sum rounded once, and the
    control: torch.sum without the rows of block ``grid // 2`` of the
    stencil kernel's grid-stride loop (thread P of ``grid`` blocks of 256
    takes runs P, P + 256 grid, ... of STENCIL_RUN rows)."""
    from iterativesolvers_tpu_torch.ops.cuda_stencil import STENCIL_RUN

    run = torch.arange(St.n, device="cuda") // STENCIL_RUN
    keep = ((run % (256 * grid)) // 256 != grid // 2).float()
    return {"kernel": None,
            "torch.sum": lambda u, y: torch.sum(u * y),
            "f64 sum": lambda u, y: torch.sum(u.double() * y.double()).float(),
            "control (one block dropped)": lambda u, y: torch.sum(u * y * keep)}


def dot_order_spread(torch, its, St, A64, grid):
    """f32 CG (reltol RELTOL) on the stencil ``St`` with each of
    :func:`dot_orders`, for each b: steps, the true relative residual and
    ``|x - x64| / |x64|`` against the f64 solve (the DIA matrix ``A64``, the
    plain path) of the same b.  Returns {(order, b): row}."""
    n = St.n
    rhs = {"b = 1": torch.ones(n, device="cuda")}
    for seed in SPREAD_B_SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        rhs[f"normal b, seed {seed}"] = torch.randn(n, generator=g,
                                                    device="cuda")

    class Dotted(its.FunctionOperator):
        """The stencil's y (the kernel without its dot) and another dot."""

        def __init__(self, dot):
            super().__init__(St.mv, St.shape, torch.float32)
            self._dot = dot

        def mv_dot(self, x):
            y = St.mv(x)
            return y, self._dot(x, y)

    ops = {name: St if dot is None else Dotted(dot)
           for name, dot in dot_orders(torch, St, grid).items()}
    table = {}
    print(f"f32 CG at {SIDE}^3 with other dot orders (steps, true relative "
          f"residual, |x - x64| / |x64|):")
    for bname, bv in rhs.items():
        b64 = bv.double()
        x64 = its.cg(A64, b64, reltol=RELTOL, chunk=CHUNK,
                     maxiter=SPREAD_MAXITER)
        for oname, op in ops.items():
            x, h = its.cg(op, bv, reltol=RELTOL, log=True, chunk=CHUNK,
                          maxiter=SPREAD_MAXITER)
            r = b64 - A64.mv(x.double())
            row = {"iters": h.iters, "converged": h.isconverged,
                   "true_rel_residual": float(torch.linalg.vector_norm(r)
                                              / torch.linalg.vector_norm(b64)),
                   "x_rel_diff_f64": float(
                       torch.linalg.vector_norm(x.double() - x64)
                       / torch.linalg.vector_norm(x64))}
            print(f"  {oname}, {bname}: {row['iters']} steps, "
                  f"{row['true_rel_residual']:.4e}, {row['x_rel_diff_f64']:.4e}"
                  f"{'' if h.isconverged else ' (not converged)'}")
            table[oname, bname] = row
        del x64
    return table


def check_spread(table):
    """Phase 4's limits on the spread: every sound order converges within
    CG_STEP_SPREAD steps of the kernel's on its b, to X_F64_REL of x64 and
    TRUE_RES_F32; the control must fail one of them.  Returns the table by
    "order / b" for the JSON line."""
    bad, control = [], {}
    for (order, bname), row in table.items():
        k = table["kernel", bname]
        fails = [what for what, ok in (
            ("converged", row["converged"]),
            ("steps", abs(row["iters"] - k["iters"]) <= CG_STEP_SPREAD),
            ("x", row["x_rel_diff_f64"] <= X_F64_REL),
            ("true residual", row["true_rel_residual"] <= TRUE_RES_F32))
            if not ok]
        if order in SOUND_ORDERS:
            bad += [f"{order}, {bname}: {f}" for f in fails]
        else:
            control[bname] = fails
    print(f"  the control fails the limits by: {control}")
    if bad:
        raise AssertionError(f"a sound order fails the limits: {bad}")
    if not all(control.values()):
        raise AssertionError(f"the control passes the limits: {control}")
    return {f"{o} / {b}": row for (o, b), row in table.items()}


# steps of phase 6's traced CG solves (a trace's cost grows with its
# events): the chunked loop's first five phases, 8 + 16 + ... + 128, which
# it runs whole (a maxiter between runs to the end of its phase, masked)
CG_TRACE = 248

# ---- GMRES (phases 7-11) ---------------------------------------------------
GM_RESTART = 20
GM_LONG, GM_SHORT = 500, 240      # bench.py's differential: 25 and 12 cycles
GM_TRACE = 2 * GM_RESTART         # steps of a traced GMRES(20) twin: 2 cycles
# Witness limits (phase 8): each kernel route against the same solve with
# the kernels routed off.  Over the first cycle the residual estimates agree
# within WITNESS_EST_REL of the largest and x within WITNESS_X_REL on both
# panels.  After 500 steps, for b = 1 and the SPREAD_SEEDS b, the f32 route
# and each of its rounding variants (``rounding_variants``) agree within
# WITNESS_RES_FACTOR in true residual and WITNESS_X_REL in x.  A bf16
# panel's 500-step residual depends on rounding: with only the sum order
# changed the same kernel reads 0.399 and 0.233 at b = 1, its plain
# versions 0.305 and the witness 0.179 (PERF.md, Findings).  So the bf16
# route is held within BF16_SPREAD of the range its three rounding variants
# span, which a fault that costs convergence outright would leave.
WITNESS_EST_REL = 1e-4
WITNESS_RES_FACTOR = 1.05
WITNESS_X_REL = 1e-3
BF16_SPREAD = 1.5
SPREAD_SEEDS = (1, 2)
# the stored DIA matrix is the stencil's matrix: its x against the stencil
# route's with the same panel
DIA_X_REL = 1e-3
# converging solves (phase 9) against their witnesses
CONV_X_REL = 1e-4
# kernel parity (phase 7): each h_j is a dot of a unit row with w, summed in
# another order, so h within TOL_H * |w|; nrm within TOL_NRM relative; a row
# stored in bf16 within one bf16 step at its largest value, 2^-7 of it
# (the f32 values it rounds may differ in the last bits)
TOL_H = 1e-5
TOL_NRM = 1e-5
TOL_ROW_BF16 = 2.0 ** -7


def sweep_resources(build):
    """``ptxas -v`` of the sweep kernels: {(kernel, panel): resources}.
    Raises if an instance is missing, spills or has a stack frame (a
    register array gone to local memory)."""
    out = {}
    for lib, kern in (("panel_mgs", "panel_mgs_kernel"),
                      ("arnoldi", "fused_arnoldi_kernel")):
        for name, res in build.kernel_resources(lib).items():
            m = re.search(kern + r"I(f|13__nv_bfloat16)E", name)
            if m:
                key = (kern.replace("_kernel", ""),
                       "f32" if m.group(1) == "f" else "bf16")
                out[key] = res
                print(f"  ptxas {key}: {res}")
    want = {(k, d) for k in ("panel_mgs", "fused_arnoldi")
            for d in ("f32", "bf16")}
    if set(out) != want:
        raise AssertionError(f"sweep kernels in the ptxas report: {sorted(out)}")
    bad = [k for k, r in out.items()
           if r.get("spill_stores", 1) or r.get("spill_loads", 1)
           or r.get("stack", 1)]
    if bad:
        raise AssertionError(f"sweep kernels spill or use a stack: {bad}")
    return out


def spmv_resources(build):
    """``ptxas -v`` of every instance of the DIA and stencil kernels (the
    stencil kernel also in ``arnoldi.cu``, as ``stencil_panel_mv``):
    {mangled name: resources}.  Raises if one is missing or spills."""
    out = {}
    for lib, kern, count in (("dia_spmv", "dia_kernel", 6),
                             ("stencil", "stencil_kernel", 4),
                             ("arnoldi", "stencil_kernel", 2)):
        found = {name: res for name, res in build.kernel_resources(lib).items()
                 if kern in name}
        for name, res in found.items():
            print(f"  ptxas {lib} {name}: {res}")
        if len(found) != count:
            raise AssertionError(f"{lib}: {len(found)} instances of {kern} in "
                                 f"the ptxas report, expected {count}")
        out.update({f"{lib}:{name}": res for name, res in found.items()})
    bad = [k for k, r in out.items()
           if r.get("spill_stores", 1) or r.get("spill_loads", 1)]
    if bad:
        raise AssertionError(f"DIA or stencil kernels spill: {bad}")
    return out


@contextlib.contextmanager
def half_grid(cm, ca):
    """The two sweep kernels on half their cooperative grid: twice the
    chunk a block, part of it in the spill tier at 216^3."""
    def half(f):
        return lambda *a: max(1, f(*a) // 2)

    with routed(cm, _grid=half(cm._grid)), \
            routed(ca, _fused_grid=half(ca._fused_grid)):
        yield


@contextlib.contextmanager
def routed(gm, **decisions):
    """Replace dispatch functions of ``solvers/gmres.py`` for the duration
    (the kernel-free witness, or one route forced); restored on exit."""
    saved = {name: getattr(gm, name) for name in decisions}
    for name, fn in decisions.items():
        setattr(gm, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(gm, name, fn)


def kernels_off(gm):
    """Every GMRES kernel routed off: plain PyTorch orthogonalization and
    ``op.mv`` (the operator's own kernel) in every step."""
    return routed(gm, _fused_setup=lambda *a: None,
                  _stencil_panel_setup=lambda *a: None,
                  _use_panel_mgs=lambda *a: False)


def check_h(name, h, hp, wn, nrm, nrmp):
    """h within TOL_H * |w| and nrm within TOL_NRM relative."""
    eh = float((h - hp).abs().max())
    en = abs(float(nrm) - float(nrmp))
    print(f"  {name}: h max_abs_err {eh:.3e} (limit {TOL_H * wn:.3e}), "
          f"nrm abs err {en:.3e} (limit {TOL_NRM * float(nrmp):.3e})")
    if not (eh <= TOL_H * wn and en <= TOL_NRM * float(nrmp)):
        raise AssertionError(f"{name}: h or nrm off")


def gmres_parity(torch, its, cm, ca, n):
    """Phase 7.  Returns the panels (f32 and bf16, rows 0..19 orthonormal),
    a w, the max abs errors for the kernels line and, by panel, the sweep
    kernels' residency on their full grid."""
    m1 = GM_RESTART + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    Q, _ = torch.linalg.qr(torch.randn(n, m1 - 1, generator=g, device="cuda"))
    V32 = torch.zeros(m1, n, device="cuda")
    V32[: m1 - 1] = Q.T
    del Q
    panels = {"f32": V32, "bf16": V32.to(torch.bfloat16)}
    w = torch.randn(n, generator=g, device="cuda")
    wn = float(torch.linalg.vector_norm(w))

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    def check_step(tag, Va, Vb, V, k, do, h, nrm, hp, nrmp, wn):
        """The step's checks: h and nrm, rows other than k + 1 bit-unchanged,
        row k + 1 against the plain version's (do = 1) or zeros (do = 0);
        returns the row's max abs error (0 for do = 0)."""
        check_h(tag, h, hp, wn, nrm, nrmp)
        if h[k + 1:].any():
            raise AssertionError(f"{tag}: h past k is not zero")
        if not (torch.equal(Va[: k + 1], V[: k + 1])
                and torch.equal(Va[k + 2:], V[k + 2:])):
            raise AssertionError(f"{tag}: a row other than k+1 changed")
        if do:
            return check(f"{tag} row k+1", Va[k + 1], Vb[k + 1],
                         TOL_Y_F32 if V.dtype == torch.float32
                         else TOL_ROW_BF16)
        if Va[k + 1].any():
            raise AssertionError(f"{tag}: the masked step wrote a row")
        return 0.0

    err = {}
    print("GMRES kernels, parity at 216^3 (panel of 21 rows):")
    for label, V in panels.items():
        for k in (0, 9, 19):
            for do in (1, 0):
                tag = f"panel_mgs {label} panel k={k} do={do}"
                Va, Vb = V.clone(), V.clone()
                h, nrm = cm.panel_mgs(Va, w, i32(k), i32(do))
                hp, nrmp = cm.panel_mgs_plain(Vb, w, i32(k), i32(do))
                e = check_step(tag, Va, Vb, V, k, do, h, nrm, hp, nrmp, wn)
                err[f"panel_mgs {label}"] = max(
                    e, err.get(f"panel_mgs {label}", 0.0))
                del Va, Vb
    for op_label, op in (("laplacian", its.laplacian(SIDE, 3)),
                         ("advection_diffusion",
                          its.advection_diffusion_stencil(SIDE))):
        args = (op.n, op.center, op.terms, op.coeffs)
        for label, V in panels.items():
            e = check(f"stencil_panel_mv {op_label} {label} panel",
                      ca.stencil_panel_mv(*args, V, i32(5)),
                      ca.stencil_panel_mv_plain(*args, V, i32(5)), TOL_Y_F32)
            if op_label == "laplacian":
                err[f"stencil_panel_mv {label}"] = e
    St = its.laplacian(SIDE, 3)
    args = (St.n, St.center, St.terms, St.coeffs)
    for label, V in panels.items():
        for k, do in ((19, 1), (19, 0), (9, 1)):
            tag = f"fused_arnoldi {label} panel k={k} do={do}"
            Va, Vb = V.clone(), V.clone()
            h, nrm = ca.fused_arnoldi(*args, Va, i32(k), i32(do))
            hp, nrmp = ca.fused_arnoldi_plain(*args, Vb, i32(k), i32(do))
            wk = float(torch.linalg.vector_norm(
                ca.stencil_panel_mv_plain(*args, V, i32(k))))
            e = check_step(tag, Va, Vb, V, k, do, h, nrm, hp, nrmp, wk)
            err[f"fused_arnoldi {label}"] = max(
                e, err.get(f"fused_arnoldi {label}", 0.0))
            del Va, Vb
    # (kernel, plain version, |w| of the step at panel V and k)
    steps = {"panel_mgs": (lambda V, k, do: cm.panel_mgs(V, w, k, do),
                           lambda V, k, do: cm.panel_mgs_plain(V, w, k, do),
                           lambda V, k: wn),
             "fused_arnoldi": (
                 lambda V, k, do: ca.fused_arnoldi(*args, V, k, do),
                 lambda V, k, do: ca.fused_arnoldi_plain(*args, V, k, do),
                 lambda V, k: float(torch.linalg.vector_norm(
                     ca.stencil_panel_mv_plain(*args, V, i32(k)))))}
    residency = {}
    dev = torch.cuda.current_device()
    for label, V in panels.items():
        code, es = cm._DTYPE_CODE[V.dtype], V.element_size()
        smem = cm._smem(code, dev)
        full = cm.plan_residency(n, cm._grid(code, n, dev), es, smem)
        with half_grid(cm, ca):
            half = cm.plan_residency(n, cm._grid(code, n, dev), es, smem)
        print(f"  residency, {label} panel: full grid {full} (on chip "
              f"{full.onchip_share:.4f}); half grid {half} (on chip "
              f"{half.onchip_share:.4f})")
        if not (full.spill == 0 and half.spill > 0):
            raise AssertionError(f"{label}: the full grid must hold w on "
                                 f"chip and the half grid spill")
        residency[label] = full
        for name, (kernel, plain, wnorm) in steps.items():
            # half the grid: the spill tier at full size
            with half_grid(cm, ca):
                for k, do in ((19, 1), (9, 1), (19, 0)):
                    tag = f"{name} {label} panel, half grid, k={k} do={do}"
                    Va, Vb = V.clone(), V.clone()
                    h, nrm = kernel(Va, i32(k), i32(do))
                    hp, nrmp = plain(Vb, i32(k), i32(do))
                    e = check_step(tag, Va, Vb, V, k, do, h, nrm, hp, nrmp,
                                   wnorm(V, k))
                    err[f"{name} {label}"] = max(e, err[f"{name} {label}"])
                    del Va, Vb
            # the same inputs twice: the same bits
            outs = []
            for _ in range(2):
                Va = V.clone()
                h, nrm = kernel(Va, i32(19), i32(1))
                outs.append((h, nrm, Va[20].clone()))
                del Va
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            print(f"  {name} {label} panel, two runs on the same inputs: "
                  f"{'the same bits' if same else 'DIFFERENT bits'}")
            if not same:
                raise AssertionError(f"{name} {label}: not reproducible")
    torch.cuda.synchronize()
    return panels, w, err, residency


def rounding_variants(gm):
    """The kernel route of a GMRES solve and three ways to run the same
    solve that change only its rounding: the kernels on half their
    cooperative grid (every grid-wide sum in another order), the kernels'
    plain versions on the card (the kernels' formulas in torch's sum
    order), and the kernel-free witness (the JAX package's formulas: w /
    nrm, no FMA)."""
    from iterativesolvers_tpu_torch.ops import cuda_arnoldi as ca
    from iterativesolvers_tpu_torch.ops import cuda_mgs as cm

    return {"kernels": contextlib.nullcontext,
            "kernels, half grid": lambda: half_grid(cm, ca),
            "plain versions": lambda: routed(
                gm, panel_mgs=cm.panel_mgs_plain,
                stencil_panel_mv=ca.stencil_panel_mv_plain,
                fused_arnoldi=ca.fused_arnoldi_plain),
            "witness": lambda: kernels_off(gm)}


def gmres_rounding_spread(torch, gm, counters, routes, solve, true_res,
                          rel_diff, runs, b):
    """Phase 8, the witness: the 500-step stencil solves of both panels,
    for b = 1 and two seeded b in [0.5, 1.5), in each rounding variant.
    The f32 panel must agree across variants (WITNESS_RES_FACTOR,
    WITNESS_X_REL); a bf16 panel's 500-step residual depends on rounding,
    and the kernel route is held to the spread of the other variants
    (BF16_SPREAD)."""
    n = b.shape[0]
    rhs = {"b = 1": b}
    for seed in SPREAD_SEEDS:
        g = torch.Generator(device=b.device).manual_seed(seed)
        rhs[f"b seed {seed}"] = 0.5 + torch.rand(n, generator=g,
                                                 device=b.device)
    panel_kernels = {"panel_mgs", "stencil_panel_mv", "fused_arnoldi"}
    variants = rounding_variants(gm)
    table, bad = {}, []
    print(f"  rounding spread of the {GM_LONG}-step stencil solves "
          f"(true relative residual; |x - x_kernels| / |x_kernels|):")
    for bname, bv in rhs.items():
        for name in ("stencil_bf16", "stencil_f32"):
            op, panel = routes[name]
            row = {}
            for vname, ctx in variants.items():
                if vname == "kernels" and bname == "b = 1":
                    x = runs[name][0]
                else:
                    for f in counters:
                        f.launches = 0
                    with ctx():
                        x = solve(op, GM_LONG, panel, rhs=bv)
                    torch.cuda.synchronize()
                    launched = sum(f.launches for f in counters
                                   if f.__name__ in panel_kernels)
                    if (launched > 0) != vname.startswith("kernels"):
                        raise AssertionError(f"{name} {vname}: panel kernel "
                                             f"launches {launched}")
                if not torch.isfinite(x).all():
                    raise AssertionError(f"{name} {vname}: x not finite")
                row[vname] = (x, true_res(x, bv))
            xk, rk = row["kernels"]
            cell = {v: {"true_rel_residual": r, "x_rel_diff": rel_diff(x, xk)}
                    for v, (x, r) in row.items()}
            table[f"{name}, {bname}"] = cell
            print(f"    {name}, {bname}: " + "; ".join(
                f"{v} {c['true_rel_residual']:.4e} ({c['x_rel_diff']:.2e})"
                for v, c in cell.items()))
            others = sorted(c["true_rel_residual"] for v, c in cell.items()
                            if v != "kernels")
            if panel is None:
                if not all(c["x_rel_diff"] <= WITNESS_X_REL
                           and max(rk, c["true_rel_residual"])
                           <= WITNESS_RES_FACTOR * min(rk,
                                                       c["true_rel_residual"])
                           for c in cell.values()):
                    bad.append(f"{name}, {bname}")
            elif not (others[0] / BF16_SPREAD <= rk
                      <= others[-1] * BF16_SPREAD):
                bad.append(f"{name}, {bname}")
            del row
    if bad:
        raise AssertionError(f"kernel route outside its witnesses: {bad}")
    return table


def gmres_main_path(torch, its, gm, counters, ops, b, true_res, rel_diff,
                    timed):
    """Phase 8: bench.py's GMRES workload through ``gmres(...)`` on five
    routes, its launch counts, its witness and its per-iteration time."""
    bf16 = torch.bfloat16
    routes = {"stencil_bf16": (ops["stencil"], bf16),
              "stencil_f32": (ops["stencil"], None),
              "dia_f32": (ops["dia_f32"], bf16),
              "dia_bf16": (ops["dia_bf16"], bf16),
              "dia_int8": (ops["dia_int8"], bf16)}
    cycles = GM_LONG // GM_RESTART
    expect = {"stencil_bf16": {"stencil_panel_mv": GM_LONG,
                               "panel_mgs": GM_LONG, "stencil_apply": cycles},
              "stencil_f32": {"fused_arnoldi": GM_LONG,
                              "stencil_apply": cycles}}
    for name in ("dia_f32", "dia_bf16", "dia_int8"):
        expect[name] = {"dia_spmv": GM_LONG + cycles, "panel_mgs": GM_LONG}

    def solve(op, maxiter, panel, log=False, rhs=None):
        # no convergence: exactly maxiter steps, as bench.py times them
        return its.gmres(op, b if rhs is None else rhs, restart=GM_RESTART,
                         reltol=0.0, abstol=1e-30, maxiter=maxiter,
                         panel_dtype=panel, ir_stall_exit=False, log=log)

    def run(name, op, panel, want):
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        x, h = solve(op, GM_LONG, panel, log=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {f.__name__: f.launches for f in counters}
        want = {f.__name__: want.get(f.__name__, 0) for f in counters}
        res = true_res(x)
        print(f"  {name}: {h}, {secs:.3f} s, true relative residual "
              f"{res:.4e}, launches {counts}")
        if not (h.iters == GM_LONG and h.mvps == GM_LONG + cycles
                and torch.isfinite(x).all()):
            raise AssertionError(f"{name}: {h}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        return x, h, counts, res

    print(f"GMRES({GM_RESTART}) on the {SIDE}^3 Laplacian, {GM_LONG} steps, "
          f"reltol 0:")
    runs = {name: run(name, op, panel, expect[name])
            for name, (op, panel) in routes.items()}
    x_st = runs["stencil_bf16"][0]
    for name in ("dia_f32", "dia_bf16", "dia_int8"):
        d = rel_diff(runs[name][0], x_st)
        print(f"  {name} vs stencil_bf16: |x - x_st| / |x_st| {d:.3e}")
        if not d <= DIA_X_REL:
            raise AssertionError(f"{name} disagrees with the stencil route")
    witness = {}
    for name in ("stencil_bf16", "stencil_f32"):
        op, panel = routes[name]
        # the first cycle, kernels on and off
        x1, h1 = solve(op, GM_RESTART, panel, log=True)
        with kernels_off(gm):
            x1w, h1w = solve(op, GM_RESTART, panel, log=True)
        est = float(abs(h1["resnorm"] - h1w["resnorm"]).max()
                    / h1w["resnorm"].max())
        d1 = rel_diff(x1, x1w)
        print(f"  {name} vs its witness, first cycle: estimates within "
              f"{est:.3e}, |x - x_w| / |x_w| {d1:.3e}")
        if not (est <= WITNESS_EST_REL and d1 <= WITNESS_X_REL):
            raise AssertionError(f"{name}: first cycle off its witness")
        witness[name] = {"first_cycle_estimates_rel": est,
                         "first_cycle_x_rel_diff": d1}
    spread = gmres_rounding_spread(torch, gm, counters, routes, solve,
                                   true_res, rel_diff, runs, b)
    # the step is host-bound and its host time varies from solve to solve:
    # 3 solves of each length, and the mean step of the 500-step solve
    # beside the differential
    per_iter, per_step = {}, {}
    for name, (op, panel) in routes.items():
        t_long = timed(f"gmres {name} maxiter={GM_LONG}",
                       lambda: solve(op, GM_LONG, panel), 1, 3)
        t_short = timed(f"gmres {name} maxiter={GM_SHORT}",
                        lambda: solve(op, GM_SHORT, panel), 1, 3)
        per_iter[name] = (t_long - t_short) / (GM_LONG - GM_SHORT) * 1e3
        per_step[name] = t_long / GM_LONG * 1e3
    out = {"gmres_us_per_iter": per_iter,
           "gmres_us_per_step_of_500": per_step,
           "timed_iters": GM_LONG - GM_SHORT,
           "true_rel_residual_500": {k: r[3] for k, r in runs.items()},
           "witness": witness, "rounding_spread": spread}
    print(json.dumps(out))
    return runs, out, solve, routes


def gmres_converging(torch, its, gm, St, b):
    """Phase 9: the shifted Laplacian (center 7), on which restarted GMRES
    converges, through three routes, each against its witness.  Returns the
    results and, by panel dtype, the stencil routes' (x, history)."""
    n = St.n
    Sh = its.StencilOperator(n, 7.0, St.terms, St.coeffs)
    Sh64 = its.StencilOperator(n, 7.0, St.terms, St.coeffs,
                               dtype=torch.float64)
    b64 = b.double()

    def true_res(x):
        r = b64 - Sh64.mv(x.double())
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))

    cases = [("stencil, f32 panel (fused)", Sh, None, 1e-5, 2e-5),
             ("stencil, bf16 panel (two kernels)", Sh, torch.bfloat16, 1e-4,
              2e-4),
             ("stored f32 DIA, f32 panel", Sh.to_dia(), None, 1e-5, 2e-5)]
    out, xs = {}, {}
    print("GMRES(10) on the shifted Laplacian (center 7):")
    for name, op, panel, reltol, bound in cases:
        kw = dict(restart=10, reltol=reltol, panel_dtype=panel, log=True)
        x, h = its.gmres(op, b, **kw)
        with kernels_off(gm):
            xw, hw = its.gmres(op, b, **kw)
        torch.cuda.synchronize()
        res, d = true_res(x), float(torch.linalg.vector_norm(x - xw)
                                    / torch.linalg.vector_norm(xw))
        print(f"  {name}: {h}, restarts {h.restarts}, true relative residual "
              f"{res:.3e} (limit {bound}); witness {hw}, |x - x_w| / |x_w| "
              f"{d:.3e}")
        if not (h.isconverged and h.restarts >= 1 and res <= bound):
            raise AssertionError(f"{name} did not converge as required")
        if not (abs(h.iters - hw.iters) <= 1 and d <= CONV_X_REL):
            raise AssertionError(f"{name} disagrees with its witness")
        out[name] = {"iters": h.iters, "restarts": h.restarts,
                     "true_rel_residual": res, "witness_iters": hw.iters,
                     "x_rel_diff": d}
        if op is Sh:
            xs[panel] = (x, h)
    print(json.dumps({"gmres_converging": out}))
    return out, xs


def gmres_fused_ab(torch, gm, counters, St, solve, timed):
    """Phase 10: per-iteration time of the fused step and of the two-kernel
    route, on f32 and on bf16 panels, in turns (A B B A)."""
    bf16 = torch.bfloat16
    cases = {"f32 fused": (None, {}, "fused_arnoldi"),
             "f32 two kernels": (None, {"_fused_setup": lambda *a: None},
                                 "stencil_panel_mv"),
             "bf16 two kernels": (bf16, {}, "stencil_panel_mv"),
             "bf16 fused": (bf16, {"_fused_setup": gm._stencil_panel_setup},
                            "fused_arnoldi")}
    times = {name: [] for name in cases}
    for name in list(cases) + list(reversed(cases)):
        panel, decisions, kernel = cases[name]
        for f in counters:
            f.launches = 0
        with routed(gm, **decisions):
            t_long = timed(f"ab {name} {GM_LONG}",
                           lambda: solve(St, GM_LONG, panel), 1, 2)
            t_short = timed(f"ab {name} {GM_SHORT}",
                            lambda: solve(St, GM_SHORT, panel), 1, 2)
        launched = {f.__name__: f.launches for f in counters}
        if not launched[kernel] or launched[
                {"fused_arnoldi": "stencil_panel_mv",
                 "stencil_panel_mv": "fused_arnoldi"}[kernel]]:
            raise AssertionError(f"{name}: launches {launched}")
        times[name].append((t_long - t_short) / (GM_LONG - GM_SHORT) * 1e3)
    out = {name: statistics.mean(t) for name, t in times.items()}
    print(json.dumps({"fused_vs_two_kernels_us_per_iter": out,
                      "samples": times}))
    return out


def dispatch_count(torch, fn):
    """The torch ops ``fn()`` dispatches (each costs host time; most launch
    a kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


def gmres_trace(torch, solve, routes, samples):
    """Where the time of a GMRES step goes: one profiled GM_TRACE-step
    solve per route, its device busy time a step against the untraced
    240-step solve's median time a step; and the torch ops a step
    dispatches (two cycles less one, over a cycle's steps:
    a cycle boundary's share included)."""
    trace = {}
    for name, (op, panel) in routes.items():
        ops = [dispatch_count(torch, lambda c=c: solve(op, c * GM_RESTART,
                                                       panel))
               for c in (1, 2)]
        _, by_kernel = profiled(
            torch, lambda: solve(op, GM_TRACE, panel), name)
        busy = sum(by_kernel.values())
        wall = statistics.median(samples[f"gmres {name} maxiter={GM_SHORT}"])
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        trace[name] = {"steps": GM_TRACE, "wall_ms_240": wall,
                       "device_busy_ms": busy,
                       "busy_share": busy / GM_TRACE / (wall / GM_SHORT),
                       "device_us_per_step": busy / GM_TRACE * 1e3,
                       "torch_ops_per_step": (ops[1] - ops[0]) / GM_RESTART,
                       "top_device_ms": dict(top)}
    print(json.dumps({"gmres_trace": trace}))
    return trace


# ---- distributed GMRES and CG (phase 12) -------------------------------------
# D ranks, one process each, all on the one card over gloo: NCCL refuses two
# ranks on one card ("Duplicate GPU detected").  Gloo reduces CUDA tensors,
# and the halo slabs go through host buffers (RowMesh.exchange), so the
# collectives run through the host: the phase measures the kernels and the
# correctness of the path, not an interconnect.
DIST_RANKS = 2
DIST_COLLECTIVE_TIMEOUT = 300     # seconds a collective may wait
DIST_TIMEOUT = 900                # seconds the ranks may take in all
DIST_REPS = 2                     # timed solves of each length
# the 500-step f32 route against the same solve with the two sweeps routed
# to their plain versions on the card: WITNESS_RES_FACTOR, WITNESS_X_REL.
# The converging solves against their distributed witness: +-1 step and
# CONV_X_REL; against phase 9's single-card MGS solve: at most one restart
# cycle of GMRES(10) apart and x within DIST_CONV_X_REL (CGS2 against MGS
# at reltol 1e-5 / 1e-4 on a matrix of condition ~13).
DIST_CONV_X_REL = {"f32": 1e-3, "bf16": 1e-2}
# shard-shape parity: each part[j] a dot of (half) a unit row with w, summed
# in another order: within TOL_H * |w|; y within TOL_Y_F32 of max|y|; ss
# within TOL_NRM relative
PANEL_KS = (0, 9, 19)


def panel_ortho_parity(torch, cpo, panels, n, D):
    """The two sweeps against their plain versions on the card at rank 0's
    shard shape: rank 0's block of phase 7's panels, (21, R, 512)."""
    from iterativesolvers_tpu_torch.parallel import panel_layout

    lay = panel_layout(n, D)
    m1, N = GM_RESTART + 1, lay.R * 512
    blocks = {}
    for label, V in panels.items():
        Vb = torch.zeros(m1, N, dtype=V.dtype, device="cuda")
        Vb[:, :lay.nloc] = V[:, :lay.nloc]
        blocks[label] = Vb.view(m1, lay.R, 512)
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.zeros(N, device="cuda")
    w[:lay.nloc] = torch.randn(lay.nloc, generator=g, device="cuda")
    w = w.view(lay.R, 512)
    wn = float(torch.linalg.vector_norm(w))
    err = {}
    print(f"panel_ortho kernels, parity at the D = {D} shard shape "
          f"({m1}, {lay.R}, 512):")
    for label, V in blocks.items():
        for k in PANEL_KS:
            kt = torch.tensor(k, dtype=torch.int32, device="cuda")
            part = cpo.panel_dots(V, w, kt)
            partp = cpo.panel_dots_plain(V, w, kt)
            e = float((part - partp).abs().max())
            print(f"  panel_dots {label} k={k}: max_abs_err {e:.3e} (limit "
                  f"{TOL_H * wn:.3e})")
            if not (e <= TOL_H * wn and not part[k + 1:].any()):
                raise AssertionError(f"panel_dots {label} k={k} off")
            h = torch.randn(m1, generator=g, device="cuda")
            y, ss = cpo.panel_update(V, w, h, kt)
            yp, ssp = cpo.panel_update_plain(V, w, h, kt)
            ey = check(f"panel_update {label} k={k} y", y, yp, TOL_Y_F32)
            es = abs(float(ss) - float(ssp))
            print(f"  panel_update {label} k={k} ss: abs err {es:.3e} "
                  f"(limit {TOL_NRM * float(ssp):.3e})")
            if not es <= TOL_NRM * float(ssp):
                raise AssertionError(f"panel_update {label} k={k} ss off")
            for name, e_ in (("panel_dots", e), ("panel_update", ey)):
                key = f"{name} {label}"
                err[key] = max(e_, err.get(key, 0.0))
    torch.cuda.synchronize()
    return blocks, w, err


def panel_ortho_timing(torch, cpo, blocks, w, timed, bound):
    """Each sweep at k = 19 and 9 beside its byte bounds, its plain version
    and, on an f32 panel, the cuBLAS call of the same function (the dots:
    ``V @ w``; the update without its sum of squares: ``addmv``)."""
    out = {}
    m1 = blocks["f32"].shape[0]
    N = w.numel()
    wf = w.reshape(-1)
    h = torch.linspace(-1, 1, m1, device="cuda")
    ks = {k: torch.tensor(k, dtype=torch.int32, device="cuda")
          for k in (19, 9)}
    for label, V in blocks.items():
        es = V.element_size()
        Vf = V.view(m1, -1)
        # (kernel, plain, library, bytes and operations past the 20 rows'
        # reads and FMAs at k = 19: w read; w read, y written and y^2 summed)
        calls = {
            "panel_dots": (lambda k: cpo.panel_dots(V, w, k),
                           lambda: cpo.panel_dots_plain(V, w, ks[19]),
                           lambda: Vf @ wf, 4 * N, 0),
            "panel_update": (lambda k: cpo.panel_update(V, w, h, k),
                             lambda: cpo.panel_update_plain(V, w, h, ks[19]),
                             lambda: torch.addmv(wf, Vf.t(), h, alpha=-1),
                             8 * N, 2 * N)}
        for name, (kernel, plain, lib, extra, extra_ops) in calls.items():
            b_ms, b_by = bound(20 * es * N + extra, 2 * 20 * N + extra_ops)
            out[name, label] = {
                "ms": timed(f"{name} {label} k=19", lambda: kernel(ks[19])),
                "ms_k9": timed(f"{name} {label} k=9", lambda: kernel(ks[9])),
                "plain_ms": timed(f"{name} {label} plain", plain, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_k9": bound(10 * es * N + extra,
                                     2 * 10 * N + extra_ops)[0],
                "library_ms": (timed(f"{name} {label} library", lib)
                               if label == "f32" else None)}
    return out


def dist_rank(args):
    """One rank of phase 12 (``--dist-rank``): runs the distributed solves
    on the card, writes its results to ``args.out`` (rank 0 also the
    gathered solutions)."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke rank: torch.cuda.is_available() is false")
    from iterativesolvers_tpu_torch.parallel import row_mesh

    mesh = row_mesh("gloo", "cuda:0",
                    init_method=f"file://{args.rendezvous}",
                    rank=args.dist_rank, world_size=args.world,
                    timeout=DIST_COLLECTIVE_TIMEOUT)
    try:
        res, xs = dist_solves(torch, mesh)
    finally:
        mesh.close()
    with open(f"{args.out}/rank{args.dist_rank}.json", "w") as f:
        json.dump(res, f)
    if args.dist_rank == 0:
        torch.save(xs, f"{args.out}/x.pt")


def dist_solves(torch, mesh):
    """Phase 12 on one rank: GMRES(20) at reltol 0 (the main path, its
    witness, its timing and a trace), converging GMRES(10) on the shifted
    Laplacian, and CG, all on the row-sharded 216^3 stencil.  Returns the
    results and (rank 0) the gathered solutions, on the host."""

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.ops import cuda_panel_ortho as cpo
    from iterativesolvers_tpu_torch.ops.cuda_stencil import stencil_apply
    from iterativesolvers_tpu_torch.parallel import (HaloStencilOperator,
                                                     gather_vector)
    from iterativesolvers_tpu_torch.parallel import panel_ortho as po
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    dev = mesh.device
    St = its.laplacian(SIDE, 3, device=dev)
    op = HaloStencilOperator(St, mesh)
    b = torch.ones(op.n_local, device=dev)
    counters = (cpo.panel_dots, cpo.panel_update, stencil_apply)
    res, xs = {"rank": mesh.rank}, {}

    def sync():
        torch.cuda.synchronize()
        mesh.all_reduce(torch.zeros(1, device=dev))

    def counted(fn):
        """fn() with every count set to 0 just before; the counts after."""
        for f in counters:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {f.__name__: f.launches for f in counters}

    def gmres(A, **kw):
        return its.gmres(A, b, log=True, **kw)

    def bench(maxiter):
        # bench.py's workload: no convergence, exactly maxiter steps
        return gmres(op, restart=GM_RESTART, reltol=0.0, abstol=1e-30,
                     maxiter=maxiter, panel_dtype=None, ir_stall_exit=False)

    def plain_sweeps():
        return routed(po, panel_dots=cpo.panel_dots_plain,
                      panel_update=cpo.panel_update_plain)

    def keep(name, x):
        full = gather_vector(x, mesh)
        if mesh.rank == 0:
            xs[name] = full.cpu()

    bench(GM_RESTART)                         # warm-up: one cycle
    sync()
    # the main path: GMRES(20), 500 steps, reltol 0
    t0 = time.perf_counter()
    (x, h), counts = counted(lambda: bench(GM_LONG))
    res["gmres_500"] = {"iters": h.iters, "mvps": h.mvps, "launches": counts,
                        "s": time.perf_counter() - t0,
                        "resnorm_last": float(h["resnorm"][-1])}
    keep("gmres_500", x)
    with plain_sweeps():
        (xw, hw), counts_w = counted(lambda: bench(GM_LONG))
    res["gmres_500_witness"] = {"iters": hw.iters, "launches": counts_w,
                                "resnorm_last": float(hw["resnorm"][-1])}
    keep("gmres_500_witness", xw)
    del x, xw
    # per-step time: DIST_REPS solves of each length, rank 0's clock
    times = {}
    for m in (GM_LONG, GM_SHORT):
        times[m] = []
        for _ in range(DIST_REPS):
            sync()
            t0 = time.perf_counter()
            bench(m)
            sync()
            times[m].append(time.perf_counter() - t0)
    t_long, t_short = (statistics.median(times[m]) for m in (GM_LONG,
                                                             GM_SHORT))
    res["timing"] = {"solve_s": times,
                     "us_per_iter": (t_long - t_short)
                     / (GM_LONG - GM_SHORT) * 1e6,
                     "us_per_step_of_500": t_long / GM_LONG * 1e6}
    # one traced GM_TRACE-step solve (rank 0 traces; rank 1 runs it
    # alongside), against the 240-step solve's time a step
    sync()
    _, by_kernel = profiled(torch, lambda: bench(GM_TRACE),
                            "distributed gmres", mesh)
    if mesh.rank == 0:
        busy = sum(by_kernel.values())
        sweeps = {name: sum(v for k, v in by_kernel.items() if name in k)
                  for name in ("panel_dots_kernel", "reduce_rows",
                               "panel_update_kernel", "stencil_kernel")}
        res["trace"] = {
            "steps": GM_TRACE, "wall_ms_240": t_short * 1e3,
            "rank0_device_busy_ms": busy, "rank0_busy_share": busy
            / GM_TRACE / (t_short * 1e3 / GM_SHORT),
            "us_per_step": {k: v / GM_TRACE * 1e3 for k, v in sweeps.items()},
            "top_device_ms": dict(sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:8])}
    sync()
    # converging GMRES(10) on the shifted Laplacian, f32 and bf16 panels
    Sh = HaloStencilOperator(its.StencilOperator(St.n, 7.0, St.terms,
                                                 St.coeffs, device=dev), mesh)
    for label, panel, reltol in (("f32", None, 1e-5),
                                 ("bf16", torch.bfloat16, 1e-4)):
        # as phase 9 runs it on one card
        kw = dict(restart=10, reltol=reltol, panel_dtype=panel)
        (x, h), counts = counted(lambda: gmres(Sh, **kw))
        with plain_sweeps():
            xw, hw = gmres(Sh, **kw)
        res[f"converging_{label}"] = {
            "iters": h.iters, "restarts": h.restarts,
            "converged": h.isconverged, "launches": counts,
            "witness_iters": hw.iters, "witness_converged": hw.isconverged}
        keep(f"converging_{label}", x)
        keep(f"converging_{label}_witness", xw)
    def reduced(fn):
        """fn() with the mesh's allreduces counted: (its result, count)."""
        calls = [0]
        orig = mesh.all_reduce

        def count(t):
            calls[0] += 1
            return orig(t)

        mesh.all_reduce = count
        try:
            out = fn()
        finally:
            del mesh.all_reduce      # the class's method again
        return out, calls[0]

    # CG on the Laplacian and pipelined CG on the shifted Laplacian (f32
    # pipelined CG does not converge on the Laplacian, phase 13) to reltol
    # 1e-5, with their allreduces counted
    for name, solver, A in (("cg", its.cg, op),
                            ("pipelined_cg", its.pipelined_cg, Sh)):
        ((x, h), counts), red = reduced(lambda: counted(lambda: solver(
            A, b, reltol=RELTOL, log=True, chunk=CHUNK,
            maxiter=KRYLOV_MAXITER)))
        res[name] = {"iters": h.iters, "converged": h.isconverged,
                     "launches": counts, "allreduces": red,
                     "steps": chunked_steps(h.iters, CHUNK)}
        keep(name, x)
    return res, xs


def run_ranks(torch):
    """Phase 12's ranks: DIST_RANKS processes of this script on the card
    (file rendezvous, a timeout on every collective and on the ranks).
    Returns each rank's results and rank 0's gathered solutions (host).
    A rank that fails fails the phase."""
    import tempfile

    print(f"distributed: GMRES and CG on {DIST_RANKS} ranks over gloo on one "
          f"card, the {SIDE}^3 Laplacian row-sharded (n_local "
          f"{SIDE**3 // DIST_RANKS}):")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--world", str(DIST_RANKS), "--rendezvous", f"{tmp}/rendezvous",
               "--out", tmp]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--dist-rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(DIST_RANKS)]
        logs = []
        try:
            for p in procs:
                left = DIST_TIMEOUT - (time.perf_counter() - t0)
                logs.append(p.communicate(timeout=max(left, 1))[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(f"rank {r} output:\n{log[-6000:]}")
                raise AssertionError(f"rank {r} exited {p.returncode}")
        ranks = []
        for r in range(DIST_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
        xs = torch.load(f"{tmp}/x.pt")
    print(f"  ranks took {secs:.1f} s")
    return ranks, xs, secs


def check_ranks(torch, its, ranks, xs, secs, true_res, rel_diff, refs):
    """Phase 12's checks: the ranks' launches and agreement, the main path
    against its witness, and the converging solves and CG against their
    witness and the single-card solves in ``refs``."""
    n = SIDE**3
    x64 = refs["cg"][3]
    dev = x64.device
    xs = {k: v.to(dev) for k, v in xs.items()}
    r0 = ranks[0]
    cycles = GM_LONG // GM_RESTART
    want = {"panel_dots": 2 * GM_LONG, "panel_update": 2 * GM_LONG,
            "stencil_apply": GM_LONG + cycles}
    want_w = dict(want, panel_dots=0, panel_update=0)
    for r in ranks:
        g, gw = r["gmres_500"], r["gmres_500_witness"]
        print(f"  rank {r['rank']}: {GM_LONG} steps, launches {g['launches']}"
              f"; witness launches {gw['launches']}")
        if not (g["iters"] == GM_LONG and g["mvps"] == GM_LONG + cycles
                and g["launches"] == want and gw["launches"] == want_w):
            raise AssertionError(f"rank {r['rank']}: {g}, {gw}, expected "
                                 f"launches {want} / {want_w}")
        for key in ("gmres_500", "converging_f32", "converging_bf16", "cg",
                    "pipelined_cg"):
            if r[key]["iters"] != r0[key]["iters"]:
                raise AssertionError(f"ranks disagree on {key}")
    out = {"ranks": DIST_RANKS, "backend": "gloo", "ranks_s": secs,
           "timing": r0["timing"], "trace": r0["trace"]}
    # the main path against its witness (the two sweeps' plain versions)
    res, res_w = true_res(xs["gmres_500"]), true_res(xs["gmres_500_witness"])
    d = rel_diff(xs["gmres_500"], xs["gmres_500_witness"])
    print(f"  GMRES({GM_RESTART}) {GM_LONG} steps, f32 panel: true relative "
          f"residual {res:.5e}, witness {res_w:.5e}, |x - x_w| / |x_w| "
          f"{d:.3e}; {r0['timing']['us_per_iter']:.1f} us per iteration, "
          f"{r0['timing']['us_per_step_of_500']:.1f} us per step of "
          f"{GM_LONG}")
    if not (max(res, res_w) <= WITNESS_RES_FACTOR * min(res, res_w)
            and d <= WITNESS_X_REL):
        raise AssertionError("distributed GMRES off its witness")
    out["gmres_500"] = {"true_rel_residual": res,
                        "witness_true_rel_residual": res_w, "x_rel_diff": d,
                        "resnorm_last": r0["gmres_500"]["resnorm_last"]}
    # converging GMRES(10) on the shifted Laplacian
    St = its.laplacian(SIDE, 3, device=dev)
    Sh64 = its.StencilOperator(n, 7.0, St.terms, St.coeffs,
                               dtype=torch.float64, device=dev)
    b64 = torch.ones(n, dtype=torch.float64, device=dev)

    def shifted_res(x):
        return float(torch.linalg.vector_norm(b64 - Sh64.mv(x.double()))
                     / torch.linalg.vector_norm(b64))

    for label, panel in (("f32", None), ("bf16", torch.bfloat16)):
        c = r0[f"converging_{label}"]
        x, xw = xs[f"converging_{label}"], xs[f"converging_{label}_witness"]
        x1, h1 = refs["converging"][panel]
        dw, d1 = rel_diff(x, xw), rel_diff(x, x1)
        res = shifted_res(x)
        print(f"  converging GMRES(10), {label} panel: {c['iters']} steps, "
              f"{c['restarts']} restarts, true relative residual {res:.3e}, "
              f"launches {c['launches']}; witness {c['witness_iters']} steps,"
              f" |x - x_w| / |x_w| {dw:.3e}; single card {h1.iters} steps, "
              f"|x - x_1| / |x_1| {d1:.3e} (limit {DIST_CONV_X_REL[label]})")
        if not (c["converged"] and c["witness_converged"]
                and c["launches"]["panel_dots"] > 0):
            raise AssertionError(f"converging {label}: {c}")
        if not (abs(c["iters"] - c["witness_iters"]) <= 1
                and dw <= CONV_X_REL):
            raise AssertionError(f"converging {label} off its witness")
        if not (abs(c["iters"] - h1.iters) <= 10
                and d1 <= DIST_CONV_X_REL[label]):
            raise AssertionError(f"converging {label} off the single card")
        out[f"converging_{label}"] = dict(
            c, true_rel_residual=res, witness_x_rel_diff=dw,
            single_card_iters=h1.iters, single_card_x_rel_diff=d1)
    # CG to reltol 1e-5
    c = r0["cg"]
    x1, h1, res_pl, x64 = refs["cg"]
    res, d1, d64 = true_res(xs["cg"]), rel_diff(xs["cg"], x1), rel_diff(
        xs["cg"], x64)
    print(f"  CG: {c['iters']} steps (single card {h1.iters}, difference "
          f"{c['iters'] - h1.iters}), true relative residual {res:.3e} "
          f"(single card {true_res(x1):.3e}, plain {res_pl:.3e}), "
          f"|x - x_1| / |x_1| {d1:.3e}, |x - x64| / |x64| {d64:.3e}, "
          f"launches {c['launches']} for {c['steps']} steps")
    if not (c["converged"]
            and res <= min(TRUE_RES_F32, PLAIN_RES_FACTOR * res_pl)):
        raise AssertionError(f"distributed CG: true relative residual {res}")
    if c["launches"]["stencil_apply"] != c["steps"]:
        raise AssertionError(f"distributed CG launches {c['launches']}")
    out["cg"] = dict(c, true_rel_residual=res, single_card_iters=h1.iters,
                     x_rel_diff_single_card=d1, x_rel_diff_f64=d64)
    # pipelined CG on the shifted Laplacian: one allreduce a step (CG
    # three), against the same solve on one card
    p = r0["pipelined_cg"]
    x1, h1 = its.pipelined_cg(
        its.StencilOperator(n, 7.0, St.terms, St.coeffs, device=dev),
        torch.ones(n, device=dev), reltol=RELTOL, maxiter=KRYLOV_MAXITER,
        log=True, chunk=CHUNK)
    res = shifted_res(xs["pipelined_cg"])
    d1 = rel_diff(xs["pipelined_cg"], x1)
    print(f"  pipelined CG: {p['iters']} steps (single card {h1.iters}), "
          f"true relative residual {res:.3e}, |x - x_1| / |x_1| {d1:.3e}, "
          f"allreduces {p['allreduces']} for {p['steps']} steps (CG "
          f"{c['allreduces']} for {c['steps']}), launches {p['launches']}")
    if not (p["converged"] and res <= SHIFTED_TRUE_RES
            and abs(p["iters"] - h1.iters) <= CG_STEP_SPREAD
            and d1 <= WITNESS_KRYLOV_X_REL):
        raise AssertionError(f"distributed pipelined CG: {p}")
    if not (p["allreduces"] == 1 + p["steps"]
            and c["allreduces"] == 1 + 3 * c["steps"]
            and p["launches"]["stencil_apply"] == 1 + p["steps"]):
        raise AssertionError(f"allreduces or launches: CG {c}, pipelined {p}")
    out["pipelined_cg"] = dict(p, true_rel_residual=res,
                               single_card_iters=h1.iters,
                               x_rel_diff_single_card=d1)
    print(json.dumps({"distributed": out}))
    return out, r0


# ---- the Krylov solvers at 216^3 (phase 13) ----------------------------------
# Held runs converge to reltol RELTOL within KRYLOV_MAXITER steps (4
# KRYLOV_MAXITER products for BiCGStab(2)) and are held to their true
# residual, their distance from x64 and their witness (the same solver on
# the kernels' plain versions: steps within CG_STEP_SPREAD).  The limits of
# the Laplacian runs (b = 1) come from the JAX package's own f32 runs of the
# same solvers on the CPU (jax_reference/krylov_f32_216.py, PERF.md): twice
# its true relative residual and four times its |x - x64| / |x64|, the
# witness within that of x.  On the shifted Laplacian (condition 13, x of
# b's size) the true residual reaches 10 reltol and the witness 1e-4.
# Recorded runs are f32 solves that are rounding-bound in both packages
# (pipelined CG and IDR(8) on the Laplacian; QMR, BiCGStab(2) and IDR(8) on
# the advection-diffusion stencil at the fixture's beta = 1000, capped at
# KRYLOV_CAP steps: run_chunked's warm-up phases, none masked): held to
# their launches and a finite x, their true residual and witness printed
# beside the JAX package's own.
KRYLOV_MAXITER = 1000
KRYLOV_CAP = 248
POWM_STEPS = 248
# solver: (true relative residual, |x - x64| / |x64|) of the JAX package's
# own f32 solve of the 216^3 Laplacian with b = 1
JAX_LAPLACIAN_F32 = {"minres": (2.264e-2, 1.688e-4),
                     "qmr": (2.390e-2, 1.601e-4),
                     "bicgstabl": (3.798e-3, 6.265e-5)}
SHIFTED_TRUE_RES = 1e-4
WITNESS_KRYLOV_X_REL = 1e-4
# powm's Rayleigh quotient lies below lambda_max (f32 rounding: 1e-5) and
# above lambda_max less POWM_GAP_FACTOR times the gap the power method
# leaves after its steps from a start with equal weights on every
# eigenvector (powm_expected)
POWM_GAP_FACTOR = 3.0


def advection_rhs(torch, N):
    """The fixture's b of advection_diffusion(N) (utils/fixtures.py):
    exp(xyz) sin(pi x) sin(pi y) sin(pi z) on the interior points, x
    fastest, made on the card in f64 and rounded to f32."""
    xs = torch.linspace(0.0, 1.0, N + 2, dtype=torch.float64,
                        device="cuda")[1:N + 1]
    X, Y, Z = torch.meshgrid(xs, xs, xs, indexing="ij")
    F = (torch.exp(X * Y * Z) * torch.sin(torch.pi * X)
         * torch.sin(torch.pi * Y) * torch.sin(torch.pi * Z))
    return F.permute(2, 1, 0).reshape(-1).float()


def powm_expected(side, steps):
    """lambda_max of the side^3 Laplacian (6 + 6 cos(pi / (side + 1))) and
    the Rayleigh quotient of its power method's last step after ``steps``
    steps from a start with equal weight on every eigenvector (the mean
    weight of a normal start): sum l^(2s-1) / sum l^(2s-2) over the
    eigenvalues l = mu_i + mu_j + mu_k, mu_i = 2 - 2 cos(i pi / (side + 1))."""
    import numpy as np

    mu = 2 - 2 * np.cos(np.arange(1, side + 1) * np.pi / (side + 1))
    lmax = 6 + 6 * np.cos(np.pi / (side + 1))
    lam = (mu[:, None, None] + mu[None, :, None]
           + mu[None, None, :]).ravel() / lmax
    w = lam ** (2 * steps - 2)
    return lmax, float(lmax * (w * lam).sum() / w.sum())


def krylov_cases(torch, its, St, Ad):
    """Phase 13's runs: name -> (solve(op, cap) -> (x, h) (``cap`` steps
    at most, by default the run's own), operator, b, the f64 operator of
    the true residual, kernel, launches(steps run), kind: "laplacian"
    (held, against x64), "shifted" (held), "recorded" or "powm").  One
    kernel launch a product, masked steps included."""
    n = St.n
    b1 = torch.ones(n, device="cuda")
    A64 = its.StencilOperator(n, St.center, St.terms, St.coeffs,
                              dtype=torch.float64)
    Sh = its.StencilOperator(n, 7.0, St.terms, St.coeffs)
    Sh64 = its.StencilOperator(n, 7.0, St.terms, St.coeffs,
                               dtype=torch.float64)
    ShD = its.compress_values(Sh.to_dia(), torch.int8)
    Adv = its.advection_diffusion_stencil(SIDE)
    Adv64 = its.advection_diffusion_stencil(SIDE, dtype=torch.float64)
    b_adv = advection_rhs(torch, SIDE)
    lmin, lmax = its.gershgorin_bounds(Sh)
    if (lmin, lmax) != (1.0, 13.0) or ShD.dtype != torch.int8:
        raise AssertionError(f"shifted Laplacian: bounds {lmin, lmax}, "
                             f"DIA {ShD.dtype}")
    g = torch.Generator(device="cuda").manual_seed(4)
    x0 = torch.randn(n, generator=g, device="cuda")
    x0 /= torch.linalg.vector_norm(x0)

    def powm(op, cap=POWM_STEPS - 1):
        lam, x, h = its.powm(op, x0=x0, tol=0.0, maxiter=cap, log=True)
        h.lam = float(lam)
        return x, h

    K = KRYLOV_MAXITER
    conv = dict(reltol=RELTOL, log=True)
    one, two, four = (lambda s: s), (lambda s: 2 * s), (lambda s: 4 * s)
    return {
        "minres stencil": (
            lambda op, cap=K: its.minres(op, b1, maxiter=cap, **conv), St,
            b1, A64, "stencil_apply", one, "laplacian"),
        "minres int8 DIA": (
            lambda op, cap=K: its.minres(op, b1, maxiter=cap, **conv), Ad,
            b1, A64, "dia_spmv", one, "laplacian"),
        "qmr stencil": (
            lambda op, cap=K: its.qmr(op, b1, maxiter=cap, **conv), St, b1,
            A64, "stencil_apply", two, "laplacian"),
        "bicgstabl(2) stencil": (
            lambda op, cap=K: its.bicgstabl(op, b1, 2,
                                            max_mv_products=4 * cap, **conv),
            St, b1, A64, "stencil_apply", four, "laplacian"),
        "idrs(8) shifted stencil": (
            lambda op, cap=K: its.idrs(op, b1, s=8, maxiter=cap, **conv),
            Sh, b1, Sh64, "stencil_apply", one, "shifted"),
        "pipelined_cg shifted stencil": (
            lambda op, cap=K: its.pipelined_cg(op, b1, maxiter=cap, **conv),
            Sh, b1, Sh64, "stencil_apply", lambda s: 1 + s, "shifted"),
        "pipelined_cg shifted int8 DIA": (
            lambda op, cap=K: its.pipelined_cg(op, b1, maxiter=cap, **conv),
            ShD, b1, Sh64, "dia_spmv", lambda s: 1 + s, "shifted"),
        "chebyshev shifted stencil": (
            lambda op, cap=K: its.chebyshev(op, b1, lmin, lmax, maxiter=cap,
                                            **conv), Sh, b1, Sh64,
            "stencil_apply", one, "shifted"),
        "pipelined_cg stencil": (
            lambda op: its.pipelined_cg(op, b1, maxiter=K, **conv), St, b1,
            A64, "stencil_apply", lambda s: 1 + s, "recorded"),
        "idrs(8) stencil": (
            lambda op: its.idrs(op, b1, s=8, maxiter=K, **conv), St, b1, A64,
            "stencil_apply", one, "recorded"),
        "qmr advection stencil": (
            lambda op: its.qmr(op, b_adv, maxiter=KRYLOV_CAP, log=True), Adv,
            b_adv, Adv64, "stencil_apply", two, "recorded"),
        "bicgstabl(2) advection stencil": (
            lambda op: its.bicgstabl(op, b_adv, 2,
                                     max_mv_products=4 * KRYLOV_CAP,
                                     log=True), Adv, b_adv, Adv64,
            "stencil_apply", four, "recorded"),
        "idrs(8) advection stencil": (
            lambda op: its.idrs(op, b_adv, s=8, maxiter=KRYLOV_CAP,
                                log=True), Adv, b_adv, Adv64,
            "stencil_apply", one, "recorded"),
        "powm stencil": (powm, St, None, None, "stencil_apply", one, "powm"),
    }


def krylov_phase(torch, its, St, Ad, x64, counters):
    """Phase 13: the runs of :func:`krylov_cases` through the solvers'
    public calls: launches, true residual (f64), distance from x64 (f64 CG,
    phase 4) on the Laplacian, witness, us per step (l-cycle for BiCGStab;
    CUDA events around the solve) and, for the held runs, the card's busy
    share from a trace of its first TRACE_STEPS steps."""

    from iterativesolvers_tpu_torch.ops.cuda_spmv import dia_spmv_plain
    from iterativesolvers_tpu_torch.ops.cuda_stencil import stencil_apply_plain
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    def plain(op):
        """``op`` with its kernel routed off: the kernel's plain version."""
        if isinstance(op, its.StencilOperator):
            a = (op.n, op.center, op.terms, op.coeffs)
            return its.FunctionOperator(
                lambda v: stencil_apply_plain(*a, v), op.shape, op.dtype,
                rmatvec=lambda v: stencil_apply_plain(*a, v, conj=True))
        return its.FunctionOperator(
            lambda v: dia_spmv_plain(op.diags, op.offsets, v), op.shape,
            torch.float32)

    def rel(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    out, bad = {}, []
    print(f"the Krylov solvers at {SIDE}^3:")
    cases = krylov_cases(torch, its, St, Ad)
    for name, (solve, op, rhs, op64, kernel, launches, kind) in cases.items():
        for f in counters:
            f.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x, h = solve(op)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end)
        ran = chunked_steps(h.iters)
        counts = {f.__name__: f.launches for f in counters}
        want = {f.__name__: launches(ran) if f.__name__ == kernel else 0
                for f in counters}
        for f in counters:
            f.launches = 0
        xw, hw = solve(plain(op))
        torch.cuda.synchronize()
        if any(f.launches for f in counters):
            raise AssertionError(f"{name}: the witness launched a kernel")
        dw = rel(x, xw)
        row = {"kind": kind, "iters": h.iters, "converged": h.isconverged,
               "mvps": h.mvps, "mtvps": h.mtvps, "launches": counts[kernel],
               "expected_launches": want[kernel], "steps_run": ran,
               "wall_ms": wall, "us_per_step": wall / ran * 1e3,
               "witness_iters": hw.iters, "witness_x_rel_diff": dw}
        ok = counts == want and bool(torch.isfinite(x).all())
        if kind != "recorded":
            (_, ht), by_kernel, _ = syncs_and_trace(
                torch, lambda: solve(op, TRACE_STEPS), name)
            tsteps = chunked_steps(ht.iters)
            busy = sum(by_kernel.values())
            row.update(traced_steps=tsteps, device_busy_ms=busy,
                       busy_share=busy / tsteps * ran / wall,
                       top_device_ms=dict(sorted(by_kernel.items(),
                                                 key=lambda kv: -kv[1])[:5]))
            ok = ok and abs(h.iters - hw.iters) <= CG_STEP_SPREAD
        if kind == "powm":
            lmax_, expect = powm_expected(SIDE, h.iters)
            row.update(rayleigh_quotient=h.lam, lambda_max=lmax_,
                       expected_quotient=expect, witness_quotient=hw.lam)
            ok = ok and dw <= WITNESS_KRYLOV_X_REL and (
                lmax_ - POWM_GAP_FACTOR * (lmax_ - expect)
                <= h.lam <= lmax_ * (1 + 1e-5))
            what = (f"Rayleigh quotient {h.lam:.6f} (lambda_max "
                    f"{lmax_:.6f}, expected after {h.iters} steps "
                    f"{expect:.6f})")
        else:
            b64 = rhs.double()
            res, res_w = (float(torch.linalg.vector_norm(
                b64 - op64.mv(v.double())) / torch.linalg.vector_norm(b64))
                for v in (x, xw))
            row.update(true_rel_residual=res, witness_true_rel_residual=res_w)
            what = f"true relative residual {res:.4e} (witness {res_w:.4e})"
            if kind == "laplacian":
                jres, jx = JAX_LAPLACIAN_F32[name.split()[0].split("(")[0]]
                d64, dw64 = rel(x, x64), rel(xw, x64)
                row.update(x_rel_diff_f64=d64, witness_x_rel_diff_f64=dw64,
                           limits={"true_rel_residual": 2 * jres,
                                   "x_rel_diff": 4 * jx})
                what += (f", |x - x64| / |x64| {d64:.3e} (witness "
                         f"{dw64:.3e}; limits {2 * jres:.3e}, {4 * jx:.3e})")
                ok = ok and h.isconverged and max(res, res_w) <= 2 * jres \
                    and max(d64, dw64, dw) <= 4 * jx
            elif kind == "shifted":
                ok = ok and h.isconverged and max(res, res_w) <= \
                    SHIFTED_TRUE_RES and dw <= WITNESS_KRYLOV_X_REL
        print(f"  {name}: {h}, {what}, launches {counts} ({ran} steps run), "
              f"{row['us_per_step']:.1f} us a step"
              + (f", busy {row['busy_share']:.3f}" if "busy_share" in row
                 else "")
              + f"; witness {hw.iters} steps, |x - x_w| / |x_w| {dw:.3e}")
        if not ok:
            bad.append(name)
        out[name] = row
        del x, xw
    print(json.dumps({"krylov": out}))
    if bad:
        raise AssertionError(f"Krylov runs off their limits: {bad}")
    return out


# ---- phase 14: mv_rows, block CG, LOBPCG, svdl, LSQR and LSMR ---------------
# The JAX package's published eigen/SVD workloads at full size
# (benchmarks/tpu_eigen_bench.py:37-57, benchmarks/tpu_svdl_1m_gradient.py:
# 38-50) and the 216^3 main-path operators.
ROWS = 16                 # rows of an mv_rows panel; LOBPCG's block
EIG_SIDE = 101            # 1,030,301 rows
BLOCK_K = 8               # block CG's right-hand sides
LOBPCG_TOL, LOBPCG_MAXITER = 1e-4, 150
# lambda_0 against 6 (1 - cos(pi / 102)) (the JAX package's own run on its
# TPU: 7.0e-5, BENCH_NOTES.md:26-32); f32 against int8 diagonals (the same
# products, bit for bit, phase 3); the kernel-free witness
LAM_REL, LAM_AGREE, WITNESS_LAM_REL = 1e-3, 1e-5, 1e-4
SVDL_NSV, SVDL_TOL, SVDL_MAXITER = 6, 1e-3, 100
# sigma_max against the analytic value (the JAX package's own run on the
# gradient: 4.9e-6, BENCH_NOTES.md:629-637); the kernel-free witness
SIGMA_REL, WITNESS_SIGMA_REL = 1e-4, 1e-4
LSQ_TOL, LSQ_MAXITER, GRAD_LSQ_MAXITER = 1e-5, 300, 100
# a least-squares run's true residual and |x - x64| / |x64| against its
# witness's (the kernel-free solve on the stencil; on the gradient, which
# has no kernel, the f64 solve with the f32 run's stopping rule)
LSQ_RES_FACTOR, LSQ_X_FACTOR = 2.0, 4.0
# LOBPCG's and svdl's traced solves stop after this many iterations (whole
# phases of their loops); their busy share is the trace's device time an
# iteration over the timed solve's wall time an iteration
TRACE_ITERS = 24


def lobpcg_products(iters):
    """mv_rows calls of one lobpcg batch of ``iters`` iterations: one at the
    start, one in the first iteration, then one a step of the main loop in
    phases of 8 (masked steps included)."""
    main = iters - 1
    return 1 + min(iters, 1) + (-(-main // 8) * 8 if main > 0 else 0)


def svdl_products(iters, k, j):
    """mv (and rmv) calls of one svdl run of ``iters`` macro-iterations: k
    to build, k - j a macro-iteration in phases of 4 (masked ones
    included)."""
    return k + (k - j) * -(-iters // 4) * 4


def syncs_and_trace(torch, fn, name):
    """Run ``fn`` once under ``torch.profiler`` (``profiled``) with CUDA's
    sync debug mode on: (result, device busy ms by kernel, host
    synchronisations counted by torch's sync warnings)."""
    import warnings

    def counted():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, sum("synchroniz" in str(w.message) for w in caught)

    (out, syncs), by_kernel = profiled(torch, counted, name)
    return out, by_kernel, syncs


def timed_run(torch, fn):
    """(result, ms) of one call of ``fn`` between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def block_phase(torch, its, St, A64, x64, counters, bound):
    """Phase 14.  ``St`` the 216^3 stencil, ``A64`` its f64 DIA matrix and
    ``x64`` its f64 CG solution of b = 1 (phase 4); ``counters`` the
    kernels' wrappers.  Returns the runs' rows by name, the mv_rows A/B and
    the launches, each of these two by kernel key: the counter's name, and
    for the DIA kernel the diagonals' dtype (``dia_spmv[int8]``)."""
    import numpy as np

    from iterativesolvers_tpu_torch.ops.cuda_spmv import (dia_spmv,
                                                          dia_spmv_plain)
    from iterativesolvers_tpu_torch.ops.cuda_stencil import (
        stencil_apply, stencil_apply_plain)
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps
    from iterativesolvers_tpu_torch.utils.fixtures import laplace_dia

    def reset():
        for f in counters:
            f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in counters}

    def rel(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    def plain(op):
        """``op`` with its kernel routed off: the kernel's plain version."""
        if isinstance(op, its.StencilOperator):
            a = (op.n, op.center, op.terms, op.coeffs)
            return its.FunctionOperator(
                lambda v: stencil_apply_plain(*a, v), op.shape, op.dtype,
                rmatvec=lambda v: stencil_apply_plain(*a, v, conj=True))
        return its.FunctionOperator(
            lambda v: dia_spmv_plain(op.diags, op.offsets, v), op.shape,
            torch.float32)

    def plain_rows(op, X):
        """The plain batched version: the plain product of the columns X.T
        (elementwise, so each row the same bits as the row's product)."""
        if isinstance(op, its.StencilOperator):
            return stencil_apply_plain(op.n, op.center, op.terms, op.coeffs,
                                       X.T).T
        return dia_spmv_plain(op.diags, op.offsets, X.T).T

    def row_kernel(op):
        """The kernel of one row, x into out."""
        if isinstance(op, its.StencilOperator):
            return lambda x, y: stencil_apply(op.n, op.center, op.terms,
                                              op.coeffs, x, out=y)
        return lambda x, y: dia_spmv(op.diags, op.offsets, x, out=y)

    def padded_rows(X):
        """X's values in a panel whose rows start on 16-byte boundaries (a
        view of a buffer with rows padded to whole 16-byte vectors)."""
        k, n = X.shape
        out = X.new_empty((k, -(-n // 4) * 4))[:, :n]
        out.copy_(X)
        return out

    runs, bad, launches = {}, [], {}
    t_start = time.perf_counter()

    def record(name, row, ok, key=None):
        row["phase_s"] = time.perf_counter() - t_start
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.4e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if not isinstance(v, dict)), flush=True)
        runs[name] = row
        if key is not None:
            launches.setdefault(key, {})[name] = row["launches"]
        if not ok:
            bad.append(name)

    A101 = laplace_dia(EIG_SIDE, 3, dtype="float32")
    dia101 = {"f32": A101, "int8": its.compress_values(A101, torch.int8)}
    St101 = its.laplacian(EIG_SIDE, 3)
    print(f"phase 14: mv_rows at ({ROWS}, n), block CG, LOBPCG, svdl, LSQR "
          "and LSMR:")

    # -- mv_rows: parity, launches and the kernel loop against the plain
    #    batched version, and against the same loop on rows that start on
    #    16-byte boundaries (at 101^3, n is odd: mv_rows's rows of a
    #    contiguous panel take the kernels' per-row loads)
    ab = {}
    g = torch.Generator(device="cuda").manual_seed(14)
    for name, op, kernel, key in (
            (f"stencil {SIDE}^3", St, "stencil_apply", "stencil_apply"),
            (f"stencil {EIG_SIDE}^3", St101, "stencil_apply",
             "stencil_apply"),
            (f"dia_f32 {EIG_SIDE}^3", dia101["f32"], "dia_spmv",
             "dia_spmv[f32]"),
            (f"dia_int8 {EIG_SIDE}^3", dia101["int8"], "dia_spmv",
             "dia_spmv[int8]")):
        n = op.shape[0]
        X = torch.randn(ROWS, n, generator=g, device="cuda")
        reset()
        Y = op.mv_rows(X)
        torch.cuda.synchronize()
        c = counts()
        same = all(torch.equal(Y[i], op.mv(X[i].clone()))
                   for i in range(ROWS))
        err = check(f"mv_rows {name}", Y, plain_rows(op, X), TOL_Y_F32)
        t = kernel_timing(torch, lambda: op.mv_rows(X), reps=10)
        t.pop("samples")
        plain_ms, _ = time_ms(torch, lambda: plain_rows(op, X), reps=3,
                              batches=3)
        Xa, Ya, run = padded_rows(X), padded_rows(X), row_kernel(op)

        def aligned_loop():
            for i in range(ROWS):
                run(Xa[i], Ya[i])

        ta = kernel_timing(torch, aligned_loop, reps=10)
        diag = sum(d.numel() * d.element_size() for d in getattr(
            op, "diags", ()))
        b_ms, b_by = bound(diag + 8 * ROWS * n, 2 * ROWS * 7 * n)
        row = {"launches": c[kernel], "expected_launches": ROWS,
               "rows_same_bits_as_mv": same, "max_abs_err": err, **t,
               "plain_batched_ms": plain_ms, "aligned_rows_ms": ta["ms"],
               "aligned_rows_device_ms": ta["device_ms"], "bound_ms": b_ms,
               "bound_by": b_by, "loop_over_plain": t["ms"] / plain_ms}
        ab.setdefault(key, {})[name] = row
        record(f"mv_rows {name}", row,
               same and c[kernel] == ROWS and sum(c.values()) == ROWS, key)
        del X, Y, Xa, Ya

    # -- block CG on the 216^3 stencil: k = 8, column 0 = 1, columns 1-7
    #    normal from seed 14
    n = St.n
    B = torch.randn(n, BLOCK_K, generator=g, device="cuda")
    B[:, 0] = 1.0
    reset()
    (X, h), wall = timed_run(torch, lambda: its.block_cg(
        St, B, reltol=RELTOL, log=True))
    c = counts()
    ran = chunked_steps(h.iters)
    want = BLOCK_K * (1 + ran)
    tol_col = RELTOL * torch.linalg.vector_norm(B, dim=0).cpu().numpy()
    col_steps = [int(np.argmax(h["resnorm"][:, j] <= tol_col[j])) + 1
                 for j in range(BLOCK_K)]
    cg_steps, xerr = [], []
    St64 = its.StencilOperator(n, St.center, St.terms, St.coeffs,
                               dtype=torch.float64)
    for j in (0, 1):
        _, hj = its.cg(St, B[:, j], reltol=RELTOL, log=True)
        ref = x64 if j == 0 else its.cg(St64, B[:, j].double(),
                                        reltol=RELTOL)
        cg_steps.append(hj.iters)
        xerr.append(rel(X[:, j], ref))
    (_, _), by_kernel, syncs = syncs_and_trace(
        torch, lambda: its.block_cg(St, B, reltol=RELTOL, log=True),
        "block_cg")
    busy = sum(by_kernel.values())
    row = {"iters": h.iters, "converged": h.isconverged,
           "column_steps": col_steps, "cg_steps_columns_0_1": cg_steps,
           "x_rel_diff_f64_columns_0_1": xerr, "launches": c["stencil_apply"],
           "expected_launches": want, "steps_run": ran, "wall_ms": wall,
           "us_per_step": wall / ran * 1e3, "busy_share": busy / wall,
           "host_syncs": syncs}
    ok = (h.isconverged and bool(h["converged_per_rhs"].all())
          and c["stencil_apply"] == want and sum(c.values()) == want
          and all(abs(col_steps[j] - cg_steps[j]) <= CG_STEP_SPREAD
                  for j in (0, 1))
          and max(xerr) <= X_F64_REL and bool(torch.isfinite(X).all()))
    record(f"block_cg stencil {SIDE}^3 k={BLOCK_K}", row, ok,
           "stencil_apply")
    del X, B

    # -- LOBPCG on the 101^3 DIA matrix, f32 and int8 diagonals
    N = A101.shape[0]
    X0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N, ROWS)).astype(np.float32)).cuda()
    lam_true = 3 * 2 * (1 - np.cos(np.pi / (EIG_SIDE + 1)))
    lams = {}
    for tag, op in dia101.items():
        reset()
        r, wall = timed_run(torch, lambda: its.lobpcg(
            op, X0, tol=LOBPCG_TOL, maxiter=LOBPCG_MAXITER))
        c = counts()
        want = ROWS * lobpcg_products(r.iterations)
        lam0 = float(r.lam[0])
        lams[tag] = r.lam.double()
        rt, by_kernel, syncs = syncs_and_trace(
            torch, lambda: its.lobpcg(op, X0, tol=LOBPCG_TOL,
                                      maxiter=TRACE_ITERS),
            f"lobpcg {tag}")
        busy = sum(by_kernel.values()) / rt.iterations * r.iterations
        syncs /= rt.iterations
        row = {"iters": r.iterations, "converged": r.converged,
               "lam0": lam0, "lam0_analytic": lam_true,
               "lam0_rel_err": abs(lam0 - lam_true) / lam_true,
               "max_residual_norm": float(r.residual_norms.max()),
               "launches": c["dia_spmv"], "expected_launches": want,
               "wall_ms": wall, "us_per_step": wall / r.iterations * 1e3,
               "busy_share": busy / wall, "host_syncs_per_iter": syncs}
        ok = (abs(lam0 - lam_true) <= LAM_REL * lam_true
              and c["dia_spmv"] == want and sum(c.values()) == want
              and bool(torch.isfinite(r.lam).all()))
        if tag == "f32":
            reset()
            w = its.lobpcg(plain(op), X0, tol=LOBPCG_TOL,
                           maxiter=LOBPCG_MAXITER)
            dw = float(((w.lam.double() - lams[tag]).abs()
                        / lams[tag].abs()).max())
            row.update(witness_iters=w.iterations, witness_lam_rel_diff=dw)
            ok = ok and dw <= WITNESS_LAM_REL and not any(counts().values())
        record(f"lobpcg dia_{tag} {EIG_SIDE}^3 nev={ROWS}", row, ok,
               f"dia_spmv[{tag}]")
    agree = float(((lams["f32"] - lams["int8"]).abs()
                   / lams["f32"].abs()).max())
    print(f"  lobpcg f32 against int8 diagonals: max relative difference "
          f"{agree:.3e} (limit {LAM_AGREE})")
    runs["lobpcg f32 vs int8"] = {"lam_rel_diff": agree}
    if not agree <= LAM_AGREE:
        bad.append("lobpcg f32 vs int8")
    del X0

    # -- svdl: the 101^3 gradient (no kernel) and the 216^3 stencil
    G = its.GradientOperator((EIG_SIDE,) * 3)
    sig_grad = float(np.sqrt(3 * 4 * np.sin((EIG_SIDE - 1) * np.pi
                                            / (2 * EIG_SIDE)) ** 2))
    sig_st = 6 * (1 - np.cos(SIDE * np.pi / (SIDE + 1)))
    k, j = 2 * SVDL_NSV, SVDL_NSV
    for name, op, sig_true, kernel in (
            (f"svdl gradient {EIG_SIDE}^3 ({3 * N} x {N})", G, sig_grad,
             None),
            (f"svdl stencil {SIDE}^3", St, sig_st, "stencil_apply")):
        def solve(o, maxiter=SVDL_MAXITER):
            return its.svdl(o, nsv=SVDL_NSV, tol=SVDL_TOL, maxiter=maxiter,
                            log=True,
                            key=torch.Generator(device="cuda").manual_seed(0))
        reset()
        (vals, _, h), wall = timed_run(torch, lambda: solve(op))
        c = counts()
        want = 2 * svdl_products(h.iters, k, j) if kernel else 0
        smax = float(vals[0])
        (_, _, ht), by_kernel, syncs = syncs_and_trace(
            torch, lambda: solve(op, TRACE_ITERS), name)
        busy = sum(by_kernel.values()) / ht.iters * h.iters
        syncs /= ht.iters
        row = {"iters": h.iters, "converged": h.isconverged,
               "sigma_max": smax, "sigma_max_analytic": sig_true,
               "sigma_max_rel_err": abs(smax - sig_true) / sig_true,
               "values": [float(v) for v in vals],
               "launches": c.get(kernel, 0) if kernel else 0,
               "expected_launches": want, "wall_ms": wall,
               "us_per_step": wall / h.iters * 1e3, "busy_share": busy / wall,
               "host_syncs_per_iter": syncs}
        ok = (abs(smax - sig_true) <= SIGMA_REL * sig_true
              and sum(c.values()) == want
              and (kernel is None or c[kernel] == want)
              and bool(torch.isfinite(vals).all()))
        if kernel:
            reset()
            wv, _, wh = solve(plain(op))
            dw = float((wv.double() - vals.double()).abs().max() / smax)
            row.update(witness_iters=wh.iters, witness_rel_diff=dw)
            ok = ok and dw <= WITNESS_SIGMA_REL and not any(counts().values())
        record(name, row, ok, kernel)

    # -- LSQR and LSMR: the shifted 216^3 stencil (center 7), b = 1; the
    #    101^3 gradient, b = G x_true, damped
    Sh = its.StencilOperator(n, 7.0, St.terms, St.coeffs)
    Sh64 = its.StencilOperator(n, 7.0, St.terms, St.coeffs,
                               dtype=torch.float64)
    b1 = torch.ones(n, device="cuda")
    x_sh64 = its.cg(Sh64, b1.double(), reltol=1e-12)
    xt = torch.randn(N, generator=g, device="cuda")
    xt -= xt.mean()
    bg = G.mv(xt)
    G64 = its.GradientOperator((EIG_SIDE,) * 3, dtype=torch.float64)
    kw64 = dict(atol=1e-14, btol=1e-14, maxiter=1000)
    x_g64 = {"lsqr": its.lsqr(G64, bg.double(), damp=1.0, **kw64),
             "lsmr": its.lsmr(G64, bg.double(), lam=1.0, **kw64)}

    def sh_res(x):
        r = b1.double() - Sh64.mv(x.double())
        return float(torch.linalg.vector_norm(r) / n**0.5)

    def grad_res(x):
        # the damped normal equations' residual, relative to |G^T b|
        x = x.double()
        r = G64.rmv(bg.double() - G64.mv(x)) - x
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(G64.rmv(bg.double())))

    for solver in ("lsqr", "lsmr"):
        damp = "damp" if solver == "lsqr" else "lam"
        fn = getattr(its, solver)
        for name, op, rhs, kw, res, x_ref, witness, kernel in (
                (f"{solver} shifted stencil {SIDE}^3", Sh, b1,
                 dict(atol=LSQ_TOL, btol=LSQ_TOL, maxiter=LSQ_MAXITER),
                 sh_res, x_sh64, lambda kw: fn(plain(Sh), b1, log=True, **kw),
                 "stencil_apply"),
                (f"{solver} gradient {EIG_SIDE}^3 damped", G, bg,
                 {damp: 1.0, "maxiter": GRAD_LSQ_MAXITER}, grad_res,
                 x_g64[solver], None, None)):
            reset()
            (x, h), wall = timed_run(torch, lambda: fn(op, rhs, log=True,
                                                         **kw))
            c = counts()
            ran = chunked_steps(h.iters)
            want = 2 * (1 + ran) if kernel else 0
            if witness is not None:
                xw, hw = witness(kw)
                if counts() != c:
                    bad.append(f"{name}: the witness launched a kernel")
            else:
                # no kernel to route off: the f64 solve with this run's
                # stopping rule
                kw64w = dict(kw)
                if solver == "lsqr":
                    kw64w.update(atol=h["atol"], btol=h["btol"])
                xw, hw = fn(G64, bg.double(), log=True, **kw64w)
            (_, _), by_kernel, syncs = syncs_and_trace(
                torch, lambda: fn(op, rhs, log=True, **kw), name)
            busy = sum(by_kernel.values())
            r_run, r_w = res(x), res(xw)
            d_run, d_w = rel(x, x_ref), rel(xw, x_ref)
            row = {"iters": h.iters, "istop": h["istop"],
                   "converged": h.isconverged, "true_residual": r_run,
                   "witness_true_residual": r_w, "x_rel_diff_f64": d_run,
                   "witness_x_rel_diff_f64": d_w,
                   "witness_iters": hw.iters,
                   "limits": {"true_residual": LSQ_RES_FACTOR * r_w,
                              "x_rel_diff": LSQ_X_FACTOR * d_w + 1e-6},
                   "launches": c.get(kernel, 0) if kernel else 0,
                   "expected_launches": want, "wall_ms": wall,
                   "us_per_step": wall / max(ran, 1) * 1e3,
                   "busy_share": busy / wall, "host_syncs": syncs}
            ok = (h["istop"] in (1, 2) if kernel else h.isconverged) \
                and r_run <= LSQ_RES_FACTOR * r_w + 1e-12 \
                and d_run <= LSQ_X_FACTOR * d_w + 1e-6 \
                and sum(c.values()) == want \
                and (kernel is None or c[kernel] == want) \
                and bool(torch.isfinite(x).all())
            record(name, row, ok, kernel)
    print(json.dumps({"phase14": runs}))
    if bad:
        raise AssertionError(f"phase 14 runs off their limits: {bad}")
    return runs, ab, launches


# ---- phase 15: the stored formats, auto_format and MatrixMarket I/O --------
# The main path's matrix in CSR form at 216^3, the JAX package's
# format-selection workload (benchmarks/run_all.py:803-898), its committed
# MatrixMarket corpus (run_all.py:711-800, tests/test_matrixmarket_
# workloads.py) and its sprand workloads at their published size
# (run_all.py:141-157, :336, :502-553).  The CSR, ELL, HYB and BSR products
# are eager torch (XLA gathers and segment sums in the JAX package, no
# Pallas kernel); a DIA matrix that auto_format picks runs the DIA kernel.
FS_SIDE, FS_BLOCKS, FS_BS = 1024, 250_000, 4
FS_RELTOL, FS_MAXITER, FS_TRUE_RES = 1e-6, 600, 1e-4
# the picks of the JAX package on its own run (BENCH_NOTES.md:726-729)
FS_PICKS = {"banded_vc": "DIAMatrix", "scrambled": "ELLMatrix",
            "block4": "BSRMatrix"}
# the 27-point stencil past one launch of diagonals: 100^3 rows (as many as
# the format-selection matrices), diagonally dominant (eigenvalues in
# [2, 54]) so that f32 CG meets FS_TRUE_RES
S27_SIDE, S27_CENTER = 100, 28.0
MTX = ("fem_poisson", "mesh_gradient_ls", "elasticity_2d", "fd_band9",
       "powerlaw_graph", "uniform_scatter")
MTX_PICKS = {"fd_band9": "DIAMatrix", "powerlaw_graph": "HYBMatrix",
             "uniform_scatter": "ELLMatrix"}
# the eager products against the DIA kernel's y (216^3, f32): another
# order of the same seven products, without FMA contraction
TOL_FORMAT_Y = TOL_Y_F32
SPRAND_GMRES = dict(restart=15, reltol=1e-5, maxiter=210)
SPRAND_LSQ = dict(atol=1e-4, btol=1e-4, maxiter=100)
LSQ_NORMAL_RES = 1e-2
SVDL_BSR = dict(nsv=6, tol=1e-3, maxiter=40)
SVDL_SCIPY_REL = 2e-3
# scipy's reference to 1e-8 relative (ARPACK's tolerance): far inside the
# 2e-3 it is held to
SVDS_TOL = 1e-8
SVDS_TIMEOUT = 600
# a solve's traced twin stops after this many steps (restarts for svdl)
TRACE_STEPS = 64
# run_all.py's sizes: the sprand GMRES matrix (n), the LSQR / LSMR one
# (rows, columns) and svdl's BSR(8) matrix (block rows, block columns,
# blocks a block row)
SPRAND_GMRES_N = 100_000
SPRAND_LSQ_SHAPE = (200_000, 50_000)
SVDL_BSR_BLOCKS = (75_000, 50_000, 6)


def format_selection_matrices(np, CSRMatrix, device):
    """run_all.py:803-898's three ~1M-row CSR matrices on ``device``, in
    turn and with its seeds (one generator, 42, drawn in its order): (tag,
    matrix)."""
    rng = np.random.default_rng(42)
    side = FS_SIDE
    n = side * side
    i = np.arange(n, dtype=np.int64)
    offs = (-side - 1, -side, -side + 1, -1, 0, 1, side - 1, side, side + 1)
    rows_l, cols_l, vals_l = [], [], []
    for off in offs:
        j = i + off
        ok = (j >= 0) & (j < n)
        if abs(off) != 0:
            # mask row-wrap for the +-1-ish couplings
            ok &= np.abs((j % side) - (i % side)) <= 1
        r, c = i[ok], j[ok]
        v = (np.float32(8.0) + rng.random(r.size, np.float32)
             if off == 0 else -rng.random(r.size, np.float32))
        rows_l.append(r)
        cols_l.append(c)
        vals_l.append(v)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l).astype(np.float32)
    del rows_l, cols_l, vals_l
    banded = CSRMatrix.from_coo(rows, cols, vals, (n, n), device=device)
    del rows, cols, vals
    yield "banded_vc", banded
    p = rng.permutation(n)
    scrambled = banded.permute(p)
    del banded
    yield "scrambled", scrambled
    del scrambled
    # 4-dof blocks on an unstructured block graph (250k block rows)
    nb = FS_BLOCKS
    ib = np.arange(nb, dtype=np.int64)
    deg = 6
    nbr = rng.integers(0, nb, size=(nb, deg)).astype(np.int64)
    br = np.concatenate([np.repeat(ib, deg), ib, np.repeat(ib, deg)])
    bc = np.concatenate([nbr.ravel(), ib, nbr.ravel()])
    # symmetrize the pattern so CG has an SPD-able matrix
    blk_ids = np.unique(br * nb + bc)
    br, bc = blk_ids // nb, blk_ids % nb
    up = br < bc
    bu, cu = br[up], bc[up]
    bs = FS_BS
    Bu = rng.random((bu.size, bs, bs), np.float32) * np.float32(-0.05)
    Bd = np.broadcast_to(np.float32(6.0) * np.eye(bs, dtype=np.float32),
                         (nb, bs, bs))
    # symmetric assembly: (i,j) = B, (j,i) = B^T, (i,i) = 6I
    abr = np.concatenate([bu, cu, ib])
    abc = np.concatenate([cu, bu, ib])
    avv = np.concatenate([Bu, np.transpose(Bu, (0, 2, 1)), Bd])
    rr = (abr[:, None, None] * bs + np.arange(bs)[None, :, None]).repeat(bs, 2)
    cc = (abc[:, None, None] * bs + np.arange(bs)[None, None, :]).repeat(bs, 1)
    yield "block4", CSRMatrix.from_coo(rr.ravel(), cc.ravel(), avv.ravel(),
                                       (nb * bs, nb * bs), device=device)


def svdl_bsr_matrix(np):
    """run_all.py:502-553's 600,000 x 400,000 BSR(8) matrix (seed 11):
    (blocks, block columns, block rows, shape)."""
    rng = np.random.default_rng(11)
    bs = 8
    nbr, nbc, deg = SVDL_BSR_BLOCKS     # 600k x 400k, 450k blocks
    br = np.repeat(np.arange(nbr, dtype=np.int64), deg)
    bc = rng.integers(0, nbc, size=nbr * deg).astype(np.int64)
    keys = np.unique(br * nbc + bc)
    br, bc = keys // nbc, keys % nbc
    blocks = (rng.standard_normal((br.size, bs, bs)) / np.sqrt(deg * bs)
              ).astype(np.float32)
    return blocks, bc, br, (nbr * bs, nbc * bs)


def svds_reference():
    """The 6 largest singular values of :func:`svdl_bsr_matrix`'s matrix by
    scipy's ``svds`` in f64 and the seconds it took: (sigma, seconds) (run
    by phase 15 in a process of its own, beside the card's work: ~35 s of
    one host core)."""
    import numpy as np
    from scipy.sparse import bsr_matrix
    from scipy.sparse.linalg import svds

    t0 = time.perf_counter()
    blocks, bc, br, shape = svdl_bsr_matrix(np)
    indptr = np.zeros(shape[0] // blocks.shape[1] + 1, np.int64)
    np.add.at(indptr, br + 1, 1)
    sp = bsr_matrix((blocks.astype(np.float64), bc, np.cumsum(indptr)),
                    shape=shape)
    sref = np.sort(svds(sp, k=SVDL_BSR["nsv"], tol=SVDS_TOL,
                        return_singular_vectors=False))[::-1]
    return sref.tolist(), time.perf_counter() - t0


def _send_svds_reference(conn):
    """svds_reference's result through the pipe ``conn`` (the child's
    end)."""
    conn.send(svds_reference())
    conn.close()


def start_svds_reference():
    """svds_reference in a spawned process of its own (this one holds the
    card): (process, the parent's end of its pipe)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_send_svds_reference, args=(send,))
    proc.start()
    send.close()
    return proc, recv


def svds_result(recv, timeout):
    """(sigma, seconds) from start_svds_reference's pipe; raises if the
    process ended without a result or took longer than ``timeout``."""
    if not recv.poll(timeout):
        raise AssertionError(f"scipy's svds gave no result in {timeout} s")
    try:
        return recv.recv()
    except EOFError:
        raise AssertionError("scipy's svds ended without a result") from None


def format_bytes(its, op, kind="mv"):
    """Bytes one product must move: the format's own arrays at their
    stored widths (padding included), x read and y written once (f32)."""
    n, m = op.shape
    vec = 4 * (n + m)
    if kind == "rmv" and getattr(op, "adj", None) is not None:
        return format_bytes(its, op.adj)

    def size(t):
        return t.numel() * t.element_size()

    if isinstance(op, its.DIAMatrix):
        return sum(size(d) for d in op.diags) + vec
    if isinstance(op, its.CSRMatrix):
        idx = size(op.indices) + (size(op.row_ids) if kind == "rmv"
                                  else size(op.indptr))
        return size(op.data) + idx + vec
    if isinstance(op, its.ELLMatrix):
        return size(op.data) + size(op.cols) + vec
    if isinstance(op, its.HYBMatrix):
        tail = size(op.tail_vals) + size(op.tail_cols) + (
            size(op.tail_rows) if kind == "rmv" else
            size(op._tail_row_set) + size(op._tail_offsets))
        return format_bytes(its, op.ell, kind) + tail
    if isinstance(op, its.BSRMatrix):
        idx = size(op.block_cols) + (size(op.block_row_ids) if kind == "rmv"
                                     else size(op._block_offsets))
        return size(op.blocks) + idx + vec
    raise TypeError(type(op).__name__)


def stored_entries(its, op):
    """Stored values a product multiplies (2 operations each)."""
    if isinstance(op, its.DIAMatrix):
        return sum(d.numel() for d in op.diags)
    if isinstance(op, its.CSRMatrix):
        return op.nnz
    if isinstance(op, its.ELLMatrix):
        return op.data.numel()
    if isinstance(op, its.HYBMatrix):
        return op.ell.data.numel() + op.tail_nnz
    return op.blocks.numel()


def library_csr(torch, A):
    """cuSPARSE's operand for ``A @ x``: the port's CSR matrix ``A`` as a
    torch sparse CSR tensor (the same int32 indices, f32 values)."""
    return torch.sparse_csr_tensor(A.indptr, A.indices, A.data.float(),
                                   A.shape, check_invariants=False)


def formats_phase(torch, its, A32, runs4, x64, counters, bound):
    """Phase 15.  ``A32`` the f32 ``laplace_dia(216, 3)`` (the phase runs on
    its device), ``runs4`` phase 4's CG runs by path ((x, history,
    launches)), ``x64`` its f64 x; ``counters`` every kernel wrapper.
    Returns the runs by name, the product timings, the launches of the
    phase by kernel key and run, and the 1M-row scrambled CSR matrix with
    its ELL pick."""
    t_start = time.perf_counter()
    # scipy's svds of item 4's BSR matrix takes ~35 s of one host core:
    # started first, in a process of its own, and read at the end
    proc, recv = start_svds_reference()
    try:
        return _formats_phase(torch, its, A32, runs4, x64, counters, bound,
                              recv, t_start)
    finally:
        if proc.is_alive():
            proc.kill()
        proc.join()
        recv.close()


def _formats_phase(torch, its, A32, runs4, x64, counters, bound, reference,
                   t_start):
    import numpy as np

    from iterativesolvers_tpu_torch import native
    from iterativesolvers_tpu_torch.ops.cuda_spmv import (MAX_DIAGS,
                                                          dia_spmv_plain)
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps
    from iterativesolvers_tpu_torch.utils.fixtures import (
        laplace_matrix_coo, random_sparse, stencil27_coo)

    dev = A32.device
    side = round(A32.shape[0] ** (1 / 3))
    runs, products, bad = {}, {}, []
    launches = {}

    def reset():
        for f in counters:
            f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in counters if f.launches}

    def elapsed():
        return time.perf_counter() - t_start

    def record(name, row, ok):
        row["phase_s"] = elapsed()
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.4e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if not isinstance(v, (dict, list))),
            flush=True)
        runs[name] = row
        for kernel, c in row.get("launches", {}).items():
            launches.setdefault(kernel, {})[name] = c
        if not ok:
            bad.append(name)

    def rel(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    def true_res(op64, x, b):
        b = b.double()
        return float(torch.linalg.vector_norm(b - op64.mv(x.double()))
                     / torch.linalg.vector_norm(b))

    def solve(name, call, steps_of, trace=True):
        """Run ``call(None)`` between CUDA events (counting launches), and
        with ``trace`` ``call(TRACE_STEPS)``, the same solve stopped after
        that many steps, under the profiler: (result, row of time a step,
        busy share, host syncs a step and launches).  The busy share is the
        trace's device time a step over the timed run's wall time a step."""
        reset()
        out, wall = timed_run(torch, lambda: call(None))
        c = counts()
        steps = max(steps_of(out), 1)
        row = {"wall_ms": wall, "steps_run": steps,
               "us_per_step": wall / steps * 1e3, "launches": c}
        if trace:
            tout, by_kernel, syncs = syncs_and_trace(
                torch, lambda: call(TRACE_STEPS), name)
            tsteps = max(steps_of(tout), 1)
            row.update(busy_share=sum(by_kernel.values()) / tsteps * steps
                       / wall, host_syncs_per_step=syncs / tsteps)
        return out, row

    def capped(kw, cap):
        """``kw`` with maxiter cut to ``cap`` (None: as given)."""
        if cap is None:
            return kw
        return {**kw, "maxiter": min(cap, kw.get("maxiter") or cap)}

    def product(key, op, fn, kind="mv", lib=None, x=None):
        """Time one product of ``op`` (``fn``), check it gives the same
        bits twice (a forward product or a precomputed adjoint's), and
        time cuSPARSE's ``lib @ x`` beside it."""
        ya, yb = fn(), fn()
        same = torch.equal(ya, yb)
        t = kernel_timing(torch, fn, reps=10)
        t.pop("samples")
        nbytes = format_bytes(its, op, kind)
        b_ms, b_by = bound(nbytes, 2 * stored_entries(its, op))
        row = {"format": type(op).__name__, "shape": list(op.shape),
               "dtype": str(op.dtype), "bytes": nbytes, **t,
               "bound_ms": b_ms, "bound_by": b_by,
               "same_bits_twice": same,
               "library_ms": (time_ms(torch, lambda: lib @ x, reps=10)[0]
                              if lib is not None else None)}
        products[key] = row
        lib_ms = row["library_ms"]
        print(f"  {key}: {t['ms']:.4f} ms (device {t['device_ms']:.4f}), "
              f"bound {b_ms:.4f} ({b_by}), cuSPARSE "
              + ("-" if lib_ms is None else f"{lib_ms:.4f}")
              + f", same bits twice {same}", flush=True)
        must_repeat = kind == "mv" or getattr(op, "adj", None) is not None
        if must_repeat and not same:
            bad.append(f"{key}: not the same bits on two runs")
        return ya

    def hold_pick(key, op, x, y, y_csr):
        """The picked format's product ``y`` of ``x`` against the eager CSR's
        (another order of the same products) and, for a DIA pick, against
        the DIA kernel's plain version; both at TOL_FORMAT_Y of max|y|."""
        products[key]["max_abs_err_vs_csr"] = check(
            f"{key} against the CSR product", y, y_csr, TOL_FORMAT_Y)
        if isinstance(op, its.DIAMatrix):
            products[key]["max_abs_err_vs_plain"] = check(
                f"{key} against the plain version", y,
                dia_spmv_plain(op.diags, op.offsets, x), TOL_FORMAT_Y)

    print("phase 15: the stored formats, auto_format, MatrixMarket I/O:")
    if native.get_lib() is None:
        raise AssertionError(f"the native library did not load: "
                             f"{native.build_error()}")

    # -- 1. the main path's matrix in CSR form: 216^3, 70.3M stored values
    t0 = time.perf_counter()
    rows, cols, vals, N = laplace_matrix_coo(side, 3, dtype=np.float32)
    A = its.CSRMatrix.from_coo(rows, cols, vals, (N, N), device=dev)
    host_s = {"laplace_matrix_coo + from_coo": time.perf_counter() - t0}
    t0 = time.perf_counter()
    indptr, indices, data = native._coo_to_csr_numpy(
        rows.astype(np.int64), cols.astype(np.int64), vals, N)
    host_s["numpy coo_to_csr"] = time.perf_counter() - t0
    same_csr = (np.array_equal(A.indptr.cpu().numpy(), indptr)
                and np.array_equal(A.indices.cpu().numpy(), indices)
                and np.array_equal(A.data.cpu().numpy(), data))
    del rows, cols, vals, indptr, indices, data
    record(f"from_coo {side}^3", {"n": N, "nnz": A.nnz,
                                  "equals_numpy_version": same_csr,
                                  "host_s": dict(host_s)}, same_csr)
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(N, generator=g, device=dev)
    y_dia = A32.mv(x)
    t0 = time.perf_counter()
    ell = A.to_ell()
    host_s["to_ell"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyb = A.to_hyb()
    host_s["to_hyb"] = time.perf_counter() - t0
    lib = library_csr(torch, A)
    for name, op in (("csr", A), ("ell", ell), ("hyb", hyb),
                     ("dia kernel", A32)):
        y = product(f"mv {name} {side}^3", op, lambda op=op: op.mv(x),
                    lib=lib, x=x)
        if name != "dia kernel":
            err = check(f"mv {name} {side}^3 against the DIA kernel", y,
                        y_dia, TOL_FORMAT_Y)
            products[f"mv {name} {side}^3"]["max_abs_err_vs_dia"] = err
    product(f"rmv csr (scatter) {side}^3", A, lambda: A.rmv(x), "rmv",
            lib=lib, x=x)
    del ell, hyb, lib
    t0 = time.perf_counter()
    op, perm = A.auto_format()
    host_s["auto_format"] = time.perf_counter() - t0
    same_diags = (isinstance(op, its.DIAMatrix) and perm is None
                  and op.offsets == A32.offsets
                  and all(torch.equal(a, b)
                          for a, b in zip(op.diags, A32.diags)))
    record(f"auto_format {side}^3", {"picked": type(op).__name__,
                                     "perm": perm is not None,
                                     "diagonals_equal_laplace_dia":
                                     same_diags, "host_s": dict(host_s)},
           same_diags)
    b = torch.ones(N, device=dev)
    x4, h4, _ = runs4["dia_f32"]
    (xd, hd), row = solve(f"cg auto_format dia {side}^3", lambda cap: its.cg(
        op, b, reltol=RELTOL, log=True, chunk=CHUNK, maxiter=cap),
        lambda r: chunked_steps(r[1].iters, CHUNK))
    want = {"dia_spmv_dot": chunked_steps(hd.iters, CHUNK)}
    ok = (hd.isconverged and hd.iters == h4.iters and torch.equal(xd, x4)
          and row["launches"] == want)
    record(f"cg auto_format dia {side}^3", {
        "iters": hd.iters, "phase4_iters": h4.iters,
        "x_equal_phase4": torch.equal(xd, x4),
        "expected_launches": want, **row}, ok)
    (xc, hc), row = solve(f"cg csr {side}^3", lambda cap: its.cg(
        A, b, reltol=RELTOL, log=True, chunk=CHUNK, maxiter=cap),
        lambda r: chunked_steps(r[1].iters, CHUNK))
    A64 = A32.astype(torch.float64)
    res, dx = true_res(A64, xc, b), rel(xc, x64)
    ok = (hc.isconverged and abs(hc.iters - h4.iters) <= CG_STEP_SPREAD
          and dx <= X_F64_REL and res <= TRUE_RES_F32 and not row["launches"])
    record(f"cg csr {side}^3", {
        "iters": hc.iters, "phase4_iters": h4.iters, "true_residual": res,
        "x_rel_diff_f64": dx, **row}, ok)
    cv = its.compress_values(A)
    record(f"compress_values csr {side}^3", {"dtype": str(cv.dtype)},
           cv.dtype == torch.int8)
    del A, op, cv, A64, xc, xd, y_dia, x

    # -- 2. run_all.py's format selection at ~1M rows
    for tag, csr in format_selection_matrices(np, its.CSRMatrix, dev):
        rcm_calls = []
        rcm = csr.rcm

        def counting_rcm():
            rcm_calls.append(1)
            return rcm()

        csr.rcm = counting_rcm
        t0 = time.perf_counter()
        op, perm = csr.auto_format()
        af_s = time.perf_counter() - t0
        n = csr.shape[0]
        bb = torch.ones(n, device=dev)
        (xf, hf), row = solve(f"cg {tag}", lambda cap: its.cg(
            op, bb, reltol=FS_RELTOL, maxiter=cap or FS_MAXITER, log=True),
            lambda r: chunked_steps(r[1].iters))
        # the true residual through the eager CSR product, which runs no
        # kernel: the pick's own product is held against it below
        r = bb.double() - csr.mv(xf).double()
        res = float(torch.linalg.vector_norm(r)
                    / torch.linalg.vector_norm(bb.double()))
        picked = type(op).__name__
        ok = (picked == FS_PICKS[tag] and perm is None and hf.isconverged
              and res <= FS_TRUE_RES and bool(torch.isfinite(xf).all())
              and (tag != "scrambled" or rcm_calls))
        if picked == "DIAMatrix":
            ok = ok and row["launches"] == {
                "dia_spmv_dot": chunked_steps(hf.iters)}
        else:
            ok = ok and not row["launches"]
        record(f"cg {tag} 1M", {
            "n": n, "nnz": csr.nnz, "picked": picked, "rcm_tried":
            bool(rcm_calls), "auto_format_s": af_s, "iters": hf.iters,
            "converged": hf.isconverged, "true_residual": res, **row}, ok)
        xr = torch.randn(n, generator=g, device=dev)
        lib = library_csr(torch, csr)
        yc = product(f"mv csr {tag} 1M", csr, lambda: csr.mv(xr), lib=lib,
                     x=xr)
        yo = product(f"mv {picked} {tag} 1M", op, lambda: op.mv(xr), lib=lib,
                     x=xr)
        hold_pick(f"mv {picked} {tag} 1M", op, xr, yo, yc)
        if tag == "scrambled":
            scrambled = csr, op        # phase 17's ELL operator
        del csr, op, lib, xf, xr, yc, yo

    # -- 2b. a 27-point stencil (a hexahedral Q1 mesh's pattern): auto_format
    #    picks DIA with 27 diagonals, more than one launch of the DIA kernel
    #    takes (MAX_DIAGS), so each product is two launches
    rows, cols, vals, n = stencil27_coo(S27_SIDE, S27_CENTER,
                                        dtype=np.float32)
    csr = its.CSRMatrix.from_coo(rows, cols, vals, (n, n), device=dev)
    del rows, cols, vals
    t0 = time.perf_counter()
    op, perm = csr.auto_format()
    af_s = time.perf_counter() - t0
    groups = -(-len(getattr(op, "offsets", ())) // MAX_DIAGS)
    bb = torch.ones(n, device=dev)
    (xf, hf), row = solve("cg stencil27", lambda cap: its.cg(
        op, bb, reltol=FS_RELTOL, maxiter=cap or FS_MAXITER, log=True),
        lambda r: chunked_steps(r[1].iters))
    res = true_res(csr, xf, bb)
    picked = type(op).__name__
    ok = (picked == "DIAMatrix" and perm is None and len(op.offsets) == 27
          and hf.isconverged and res <= FS_TRUE_RES
          and row["launches"] == {"dia_spmv_dot":
                                  groups * chunked_steps(hf.iters)})
    record(f"cg stencil27 {S27_SIDE}^3", {
        "n": n, "nnz": csr.nnz, "picked": picked,
        "diagonals": len(getattr(op, "offsets", ())),
        "launches_per_product": groups, "auto_format_s": af_s,
        "iters": hf.iters, "converged": hf.isconverged,
        "true_residual": res, **row}, ok)
    xr = torch.randn(n, generator=g, device=dev)
    lib = library_csr(torch, csr)
    yc = product(f"mv csr stencil27 {S27_SIDE}^3", csr, lambda: csr.mv(xr),
                 lib=lib, x=xr)
    yo = product(f"mv {picked} stencil27 {S27_SIDE}^3", op,
                 lambda: op.mv(xr), lib=lib, x=xr)
    hold_pick(f"mv {picked} stencil27 {S27_SIDE}^3", op, xr, yo, yc)
    if picked == "DIAMatrix":
        _, d = op.mv_dot(xr)
        _, dp = dia_spmv_plain(op.diags, op.offsets, xr, xr)
        check(f"mv_dot stencil27 {S27_SIDE}^3 dot against the plain version",
              d, dp, TOL_DOT, kind="dot")
    del csr, op, lib, xf, xr, yc, yo

    # -- 3. the MatrixMarket corpus: the native parse against the Python
    #    parser; the pipeline's solves (f32 with run_all.py's bars, f64 with
    #    tests/test_matrixmarket_workloads.py's) and the picks
    mdir = pathlib.Path(__file__).resolve().parent / "benchmarks" / "matrices"
    parse = {}
    for name in MTX:
        path = str(mdir / f"{name}.mtx")
        nat, py = native.mm_read(path), native._mm_read_python(path)
        parse[name] = (nat[0] == tuple(py[0]) and all(
            np.array_equal(a, np.asarray(b, a.dtype))
            for a, b in zip(nat[1:], py[1:])))
    record("mm_read against the Python parser", {"equal": parse},
           all(parse.values()))

    def load(name, dtype):
        return its.load_matrix_market(str(mdir / f"{name}.mtx"), dtype=dtype,
                                      device=dev)

    for dt, tag in ((np.float32, "f32"), (np.float64, "f64")):
        f64 = tag == "f64"
        P = load("fem_poisson", dt)
        d, _ = P.diagonal()
        Pl = its.DiagonalPreconditioner(d, device=dev)
        Ph = P.to_hyb()
        bp = P.mv(torch.ones(P.shape[0], dtype=P.dtype, device=dev))
        kw = (dict(reltol=1e-8, maxiter=3000) if f64
              else dict(reltol=1e-6, maxiter=3000))
        (xp, hp), row = solve(f"cg fem_poisson hyb {tag}", lambda cap: its.cg(
            Ph, bp, Pl=Pl, log=True, **capped(kw, cap)), lambda r: r[1].iters,
            trace=False)
        res = true_res(P, xp, bp)
        ok = hp.isconverged and (res < 1e-6 and hp.iters < 2500 if f64
                                 else res < 0.5)
        record(f"cg fem_poisson hyb jacobi {tag}", {
            "iters": hp.iters, "true_residual": res, **row}, ok)
        kw = (dict(reltol=1e-5, restart=60, maxiter=3000) if f64
              else dict(reltol=1e-4, restart=60, maxiter=3000))
        (xg, hg), row = solve(f"gmres fem_poisson hyb {tag}",
                              lambda cap: its.gmres(Ph, bp, Pl=Pl, log=True,
                                                    **capped(kw, cap)),
                              lambda r: r[1].iters, trace=False)
        res = true_res(P, xg, bp)
        ok = (hg.isconverged and res < 1e-3) if f64 else res < 0.5
        record(f"gmres(60) fem_poisson hyb jacobi {tag}", {
            "iters": hg.iters, "converged": hg.isconverged,
            "true_residual": res, **row}, ok)
        G = load("mesh_gradient_ls", dt)
        Gh = G.to_hyb().with_adjoint()
        if f64:
            bg = G.mv(torch.from_numpy(np.random.default_rng(
                3).standard_normal(G.shape[1])).to(dev))
            kw = dict(atol=1e-10, btol=1e-10, maxiter=2000)
        else:
            bg = torch.from_numpy(np.random.default_rng(0).standard_normal(
                G.shape[0]).astype(np.float32)).to(dev)
            kw = dict(atol=1e-6, btol=1e-6, maxiter=400)
        for sname in ("lsqr", "lsmr"):
            fn = getattr(its, sname)
            (xl, hl), row = solve(f"{sname} mesh_gradient_ls hyb {tag}",
                                  lambda cap: fn(Gh, bg, log=True,
                                                 **capped(kw, cap)),
                                  lambda r: r[1].iters, trace=False)
            rv = bg.double() - G.mv(xl.double() if f64 else xl).double()
            if f64:
                res = float(torch.linalg.vector_norm(rv)
                            / torch.linalg.vector_norm(bg))
                ok = hl.isconverged and res < 1e-6
            else:
                res = float(torch.linalg.vector_norm(G.rmv(rv.float()))
                            / torch.linalg.vector_norm(bg))
                ok = hl.isconverged and res < 0.1
            record(f"{sname} mesh_gradient_ls hyb adjoint {tag}", {
                "iters": hl.iters, "converged": hl.isconverged,
                ("true_residual" if f64 else "normal_residual_over_b"): res,
                **row}, ok)
        E = load("elasticity_2d", dt)
        dE, _ = E.diagonal()
        Eb = its.BSRMatrix.from_csr(E, 2)
        be = E.mv(torch.ones(E.shape[0], dtype=E.dtype, device=dev))
        kw = (dict(reltol=1e-7, maxiter=6000) if f64
              else dict(reltol=1e-6, maxiter=4000))
        (xe, he), row = solve(f"cg elasticity_2d bsr {tag}", lambda cap: its.cg(
            Eb, be, Pl=its.DiagonalPreconditioner(dE, device=dev), log=True,
            **capped(kw, cap)), lambda r: r[1].iters, trace=False)
        res = true_res(E, xe, be)
        ok = he.isconverged and res < 1e-5 if f64 else res < 0.5
        record(f"cg elasticity_2d bsr(2) jacobi {tag}", {
            "iters": he.iters, "true_residual": res, **row}, ok)
    for name, pick in MTX_PICKS.items():
        for dt, tag in ((np.float32, "f32"), (np.float64, "f64")):
            M = load(name, dt)
            op, perm = M.auto_format()
            n = M.shape[0]
            if name == "fd_band9":
                bm = M.mv(torch.from_numpy(np.random.default_rng(
                    5).standard_normal(n).astype(dt)).to(dev))
                kw = dict(reltol=1e-8 if tag == "f64" else 1e-6,
                          maxiter=4000)
                fn, bar = its.cg, 1e-4
            elif name == "powerlaw_graph":
                bm = torch.ones(n, dtype=M.dtype, device=dev)
                kw = dict(reltol=1e-6, maxiter=2000)
                fn, bar = its.cg, 1e-4
            else:
                bm = torch.ones(n, dtype=M.dtype, device=dev)
                kw = dict(restart=20, reltol=1e-6, maxiter=400)
                fn, bar = its.gmres, 1e-4
            (xm, hm), row = solve(f"{name} {tag}", lambda cap: fn(
                op, bm, log=True, **capped(kw, cap)), lambda r: r[1].iters,
                trace=False)
            res = true_res(M, xm, bm)
            # f32: CG on DIA launches the DIA kernel a step, GMRES panel
            # MGS (op.mv and an f32 panel); f64 launches none
            want = set()
            if tag == "f32":
                want = {"dia_spmv_dot"} if pick == "DIAMatrix" else (
                    {"panel_mgs"} if fn is its.gmres else set())
            ok = (type(op).__name__ == pick and perm is None
                  and hm.isconverged and res < bar
                  and set(row["launches"]) == want)
            if want == {"dia_spmv_dot"}:
                ok = ok and row["launches"]["dia_spmv_dot"] == chunked_steps(
                    hm.iters)
            record(f"{fn.__name__} {name} auto_format {tag}", {
                "picked": type(op).__name__, "iters": hm.iters,
                "true_residual": res, "expected_kernels": sorted(want),
                **row}, ok)

    # -- 4. run_all.py's sprand workloads at their published size
    ns = SPRAND_GMRES_N
    S = random_sparse(ns, ns, 5.0 / ns, seed=1, dtype=np.float32,
                      symmetrize=True, shift=4.0, device=dev)
    Sh = S.to_hyb()
    bs_ = torch.ones(S.shape[0], device=dev)
    (xs, hs), row = solve("gmres sprand 100k", lambda cap: its.gmres(
        Sh, bs_, log=True, **capped(SPRAND_GMRES, cap)),
        lambda r: r[1].iters)
    res = true_res(S, xs, bs_)
    route = ("op.mv + panel_mgs (f32 panel)"
             if row["launches"].get("panel_mgs") else
             f"launches {row['launches']}")
    ok = (hs.isconverged and res <= FS_TRUE_RES
          and set(row["launches"]) == {"panel_mgs"})
    record("gmres(15) sprand 100k hyb", {
        "iters": hs.iters, "converged": hs.isconverged,
        "true_residual": res, "route": route, **row}, ok)
    xr = torch.randn(S.shape[0], generator=g, device=dev)
    lib = library_csr(torch, S)
    product("mv csr sprand 100k", S, lambda: S.mv(xr), lib=lib, x=xr)
    product("mv hyb sprand 100k", Sh, lambda: Sh.mv(xr), lib=lib, x=xr)
    del S, Sh, lib
    ml, nl = SPRAND_LSQ_SHAPE
    L = random_sparse(ml, nl, 10.0 / nl, seed=3, dtype=np.float32,
                      device=dev)
    Lh = L.to_hyb()
    La = Lh.with_adjoint()
    bl = torch.ones(L.shape[0], device=dev)
    for sname in ("lsqr", "lsmr"):
        fn = getattr(its, sname)
        (xl, hl), row = solve(f"{sname} sprand 200k x 50k", lambda cap: fn(
            La, bl, log=True, **capped(SPRAND_LSQ, cap)),
            lambda r: r[1].iters)
        gn = float(torch.linalg.vector_norm(La.rmv(bl - La.mv(xl)))
                   / torch.linalg.vector_norm(La.rmv(bl)))
        ok = hl.isconverged and gn <= LSQ_NORMAL_RES and not row["launches"]
        record(f"{sname} sprand 200k x 50k hyb adjoint", {
            "iters": hl.iters, "converged": hl.isconverged,
            "normal_residual": gn, **row}, ok)
    xm = torch.randn(L.shape[1], generator=g, device=dev)
    xn = torch.randn(L.shape[0], generator=g, device=dev)
    lib = library_csr(torch, L)
    libt = library_csr(torch, La.adj.to_csr())
    product("mv hyb sprand 200k x 50k", Lh, lambda: Lh.mv(xm), lib=lib,
            x=xm)
    product("rmv hyb (scatter) sprand 200k x 50k", Lh, lambda: Lh.rmv(xn),
            "rmv", lib=libt, x=xn)
    product("rmv hyb with_adjoint sprand 200k x 50k", La,
            lambda: La.rmv(xn), "rmv", lib=libt, x=xn)
    del L, Lh, La, lib, libt
    blocks, bc, br, shape = svdl_bsr_matrix(np)
    B = its.BSRMatrix(blocks, bc, br, shape, device=dev)
    key = torch.Generator(device=dev)
    (vals, _, hv), row = solve("svdl bsr 600k x 400k", lambda cap: its.svdl(
        B, log=True, key=key.manual_seed(2), **capped(SVDL_BSR, cap)),
        lambda r: r[2].iters)
    sref, scipy_s = svds_result(reference, SVDS_TIMEOUT)
    sref = np.asarray(sref)
    got = vals.double().cpu().numpy()
    err = float(np.max(np.abs(got - sref) / sref))
    ok = err <= SVDL_SCIPY_REL and bool(torch.isfinite(vals).all())
    record("svdl nsv=6 bsr 600k x 400k", {
        "iters": hv.iters, "converged": hv.isconverged,
        "sigma": [float(v) for v in got], "scipy_sigma": sref.tolist(),
        "max_rel_err_vs_scipy": err, "scipy_s": scipy_s, **row}, ok)
    xb = torch.randn(shape[1], generator=g, device=dev)
    xt = torch.randn(shape[0], generator=g, device=dev)
    bcsr = its.CSRMatrix.from_coo(
        (br[:, None, None] * 8 + np.arange(8)[None, :, None]).repeat(8, 2)
        .ravel(), (bc[:, None, None] * 8 + np.arange(8)[None, None, :])
        .repeat(8, 1).ravel(), blocks.ravel(), shape, device=dev)
    product("mv bsr 600k x 400k", B, lambda: B.mv(xb),
            lib=library_csr(torch, bcsr), x=xb)
    product("rmv bsr (scatter) 600k x 400k", B, lambda: B.rmv(xt), "rmv")
    del B, bcsr, blocks
    print(json.dumps({"phase15": runs, "phase15_products": products}))
    print(f"  phase 15: {elapsed():.1f} s")
    if bad:
        raise AssertionError(f"phase 15 runs off their limits: {bad}")
    return runs, products, launches, scrambled


# ---- phase 16: preconditioners, the reduced system, the stationary methods ---
# The JAX package's published preconditioning workloads at full size:
# benchmarks/tpu_precond_win.py:44-99 (five CG legs at 216^3, with the
# reduced system's DIA form as a sixth), benchmarks/tpu_cg_rbic_ab.py:24-45,
# benchmarks/tpu_eigen_precond_bench.py:37-110 (LOBPCG with IC(0) at
# 101^3), ILU(0) GMRES(20) on the 100^3 advection-diffusion matrix,
# benchmarks/run_all.py:663-708 (IC(0) GMRES on a .mtx Laplacian) and
# :270-296 (the stationary methods), the stationary sweeps at 216^3, and on
# two ranks the shard-local block-Jacobi IC(0) and the reduced system's DIA
# form in a halo operator.
PW_SIDE = 216
PW_FIXTURE = dict(contrast=1e4, smooth=2, seed=7)
PW_RELTOL, PW_MAXITER = 1e-5, 20000
PW_CHUNK = {"none": 256, "jacobi": 256, "rbic": 32, "eisenstat": 32,
            "rb_reduced": 64, "rb_reduced to_dia": 64}
PW_BS = ("ones", "seed 1", "seed 2")
# the TPU record's steps (benchmarks/results/precond_win_216_r5.txt), printed
# beside the port's as counts only
TPU_PW_STEPS = {"none": 924, "jacobi": 566, "rbic": 287, "eisenstat": 278,
                "rb_reduced": 278}
# the JAX package's own f32 runs on a CPU (jax_reference/precond_f32_216.py,
# PERF.md): leg -> b -> (steps, true relative residual), and |x - x64| /
# |x64| against its f64 run of the leg on b = 1.  A port run is held to the
# run of its leg on its b: steps within the spread of the JAX package's
# steps over the three b (pw_band), the true residual within PW_RES_FACTOR
# times, and on b = 1 |x - x64| (the port's own f64 run of the leg) within
# PW_X_FACTOR times the JAX package's (phase 13's factors).  The DIA form of
# the reduced system is held to the rb_reduced leg's numbers.
JAX_PW = {
    "none": {"ones": (923, 5.4070e-03), "seed 1": (814, 1.1381e-05),
             "seed 2": (812, 1.1143e-05)},
    "jacobi": {"ones": (566, 4.3906e-03), "seed 1": (484, 1.0934e-05),
               "seed 2": (485, 1.0574e-05)},
    "rbic": {"ones": (287, 3.1814e-03), "seed 1": (244, 1.0405e-05),
             "seed 2": (244, 1.0388e-05)},
    "eisenstat": {"ones": (277, 1.9437e-03), "seed 1": (240, 1.1036e-05),
                  "seed 2": (241, 1.0706e-05)},
    "rb_reduced": {"ones": (278, 1.8795e-03), "seed 1": (247, 7.9109e-06),
                   "seed 2": (247, 7.9780e-06)}}
JAX_PW_X = {"none": 1.4322e-06, "jacobi": 8.5178e-07, "rbic": 5.0261e-07,
            "eisenstat": 1.1814e-06, "rb_reduced": 4.8763e-07}
PW_RES_FACTOR, PW_X_FACTOR = 2.0, 4.0
# benchmarks/tpu_cg_rbic_ab.py: CG on the int8 216^3 Laplacian, +- RB-IC,
# held to phase 4's f32 limits
RBIC_AB = dict(reltol=1e-6, maxiter=1000)
TPU_RBIC_AB_STEPS = {"unpreconditioned": 510, "rbic": 277}
# benchmarks/tpu_eigen_precond_bench.py at 101^3 (EIG_SIDE): eigenvalues
# against the analytic ones within phase 14's LAM_REL
EIG_P = dict(nev=4, tol=1e-4, maxiter=500)
EIG_P_BLOCK, EIG_P_SEED = 8, 7
TPU_EIG_P_ITERS = {"rbic": 181, "none": 376, "ic0 multicolor": 182,
                   "ic0 natural": 115}
JAX_IC_NLEVELS = {"natural": 301, "multicolor": 2}
# ILU(0) GMRES(20) on advection_diffusion(ILU_SIDE), f32 panel: steps within
# ILU_STEP_BAND of the JAX package's f32 run (or 10% of them), the true
# residual and |x - x64| within PW_RES_FACTOR / PW_X_FACTOR times its own
ILU_SIDE = 100
ILU_GMRES = dict(restart=20, reltol=1e-5, maxiter=600)
JAX_ILU = {"natural": (16, 2.2772e-05, 1.9864e-07),
           "multicolor": (208, 2.2597e-05, 1.8378e-07)}
ILU_STEP_BAND = 5
# run_all.py's IC(0) GMRES(20) on the 120^2 Laplacian read from a .mtx
# file, held to run_all's bar (f32 drift envelope on kappa ~ 6e3)
MTX_P_SIDE = 120
MTX_P_GMRES = dict(restart=20, reltol=1e-6, maxiter=800)
MTX_P_RES = 1e-3
# run_all.py's stationary workload (sprand n = 10,000 + 4I, 20 sweeps, six
# variants): the JAX package's f32 x on the CPU by its 2-norm, 1-norm and
# first STAT_HEAD entries, each within STAT_REL; x against the port's f64
# sweeps within PW_X_FACTOR times the JAX package's own f32-to-f64
# distance, and at least STAT_REL
STAT_N, STAT_SWEEPS, STAT_HEAD, STAT_REL = 10_000, 20, 16, 1e-5
JAX_STAT = {
    "jacobi": dict(x_norm2=16.25497051, x_norm1=1584.606593,
        x_rel_diff_f64=4.0914e-08, x_head=(
            0.201844603, 0.178709701, 0.0936310887, 0.218150377, 0.158798307,
            0.103794336, 0.211977363, 0.20943059, 0.16318278, 0.14251563,
            0.171099618, 0.166519657, 0.151861414, 0.132606655, 0.127550304,
            0.164216354)),
    "gauss_seidel": dict(x_norm2=16.27041259, x_norm1=1586.334525,
        x_rel_diff_f64=4.5345e-08, x_head=(
            0.201922223, 0.178842783, 0.0938254595, 0.218268409, 0.158902511,
            0.104113042, 0.212031081, 0.209497362, 0.163337857, 0.14269501,
            0.171273038, 0.166741103, 0.152120948, 0.132912904, 0.127769142,
            0.164338589)),
    "sor": dict(x_norm2=16.27041259, x_norm1=1586.334524,
        x_rel_diff_f64=5.4946e-08, x_head=(
            0.201922223, 0.178842768, 0.0938254595, 0.218268409, 0.158902511,
            0.104113042, 0.212031081, 0.209497362, 0.163337857, 0.14269501,
            0.171273038, 0.166741118, 0.152120948, 0.132912889, 0.127769142,
            0.164338589)),
    "ssor": dict(x_norm2=16.27041251, x_norm1=1586.334517,
        x_rel_diff_f64=5.8249e-08, x_head=(
            0.201922223, 0.178842768, 0.0938254744, 0.218268409, 0.158902511,
            0.10411302, 0.212031081, 0.209497347, 0.163337871, 0.142695025,
            0.171273038, 0.166741088, 0.152120933, 0.132912904, 0.127769142,
            0.164338574)),
    "gs_multicolor": dict(x_norm2=16.27041259, x_norm1=1586.334524,
        x_rel_diff_f64=4.2452e-08, x_head=(
            0.201922223, 0.178842783, 0.0938254595, 0.218268409, 0.158902511,
            0.104113042, 0.212031081, 0.209497362, 0.163337871, 0.14269501,
            0.171273038, 0.166741103, 0.152120918, 0.132912904, 0.127769142,
            0.164338589)),
    "sor_multicolor": dict(x_norm2=16.27041259, x_norm1=1586.334524,
        x_rel_diff_f64=4.4214e-08, x_head=(
            0.201922223, 0.178842783, 0.0938254595, 0.218268409, 0.158902511,
            0.104113042, 0.212031081, 0.209497362, 0.163337871, 0.14269501,
            0.171273038, 0.166741103, 0.152120918, 0.132912904, 0.127769142,
            0.164338589))}
# the sweeps at 216^3 on the variable-diffusion CSR against the same sweeps
# in f64 on the card (a contraction: f32 rounding stays near eps a sweep)
STAT_216_X_REL = 1e-5
# runs whose step holds hundreds of levels of the eager sweep (thousands of
# launches) are not traced as solves (a GMRES trace takes a whole cycle,
# LOBPCG's a phase of 8 steps): a traced level took ~6 ms of host time
# under the profiler and the sync checks on an H100 host (64 traced steps
# of IC(0) GMRES on the .mtx Laplacian, 478 levels a step, took 188 s);
# their apply's trace is in the eager table.  The natural sweeps at 216^3
# trace STAT_TRACE_SWEEPS; the legs' seeded b are timed, not traced
STAT_TRACE_SWEEPS = 2
APPLY_TRACE_MS = 20.0
# two ranks on the one card over gloo, as phase 12: the block-Jacobi CG
# takes the one-card solve's steps; the solves' x agree within twice phase
# 4's f32 limit.  The ranks and the one-card reference run in processes of
# their own, started with the phase: they build while the main process
# works and wait this long for their turn on the card
PRECOND_RANK_WAIT = 900
P16_DEVICE = "cuda"


def pw_rhs(torch, n, bname, dev):
    """b = 1, or numpy's normal b of a seed ("seed 1"), drawn in f64 and
    rounded to f32 as jax_reference/precond_f32_216.py draws it."""
    import numpy as np

    if bname == "ones":
        return torch.ones(n, device=dev)
    rng = np.random.default_rng(int(bname.split()[1]))
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)


def pw_build(its, leg, A, side, built=None):
    """The objects of one leg of tpu_precond_win.py on ``A`` (its dtype and
    device); the DIA form of the reduced system takes ``built``'s R."""
    if leg == "jacobi":
        d, _ = A.diagonal()
        return {"P": its.DiagonalPreconditioner(d, device=A.device)}
    if leg == "rbic":
        return {"P": its.RedBlackICPreconditioner.from_dia(A, side, 3)}
    if leg == "eisenstat":
        return {"Ah": its.EisenstatSSOROperator.from_dia(A, side, 3)}
    if leg == "rb_reduced":
        return {"R": its.RBReducedSystem.from_dia(A, side, 3)}
    if leg == "rb_reduced to_dia":
        return {"R": built["R"], "S": built["R"].to_dia()}
    return {}


def pw_solve(its, leg, A, built, b, maxiter=None):
    """(x, history) of one leg through the public calls."""
    kw = dict(reltol=PW_RELTOL, maxiter=maxiter or PW_MAXITER, log=True,
              chunk=PW_CHUNK[leg])
    if leg in ("none", "jacobi", "rbic"):
        return its.cg(A, b, Pl=built.get("P"), **kw)
    if leg == "eisenstat":
        Ah = built["Ah"]
        xh, h = its.cg(Ah, Ah.rhs_transform(b), **kw)
        return Ah.solution_transform(xh), h
    R = built["R"]
    bb, br = R.reduce_rhs(b)
    xb, h = its.cg(built.get("S", R), bb, **kw)
    return R.expand_solution(xb, br), h


def pw_band(leg):
    """The spread of the JAX package's f32 steps over the three b."""
    steps = [v[0] for v in JAX_PW[leg].values()]
    return max(steps) - min(steps)


def stream_bytes(*groups):
    """Bytes of the tensors in ``groups`` (each read or written once)."""
    return sum(t.numel() * t.element_size() for g in groups for t in g)


def precond_rank(args):
    """One rank of phase 16 (``--precond-rank``): the shard-local
    block-Jacobi IC(0) CG and the reduced system's DIA form in a halo
    operator, on the arrays the main process saved under ``args.out``."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke rank: torch.cuda.is_available() is false")
    from iterativesolvers_tpu_torch.parallel import row_mesh

    mesh = row_mesh("gloo", "cuda:0",
                    init_method=f"file://{args.rendezvous}",
                    rank=args.precond_rank, world_size=args.world,
                    timeout=DIST_COLLECTIVE_TIMEOUT)
    try:
        res, xs = precond_rank_solves(torch, mesh, pathlib.Path(args.out))
    finally:
        mesh.close()
    with open(f"{args.out}/p16rank{args.precond_rank}.json", "w") as f:
        json.dump(res, f)
    if args.precond_rank == 0:
        torch.save(xs, f"{args.out}/p16x.pt")


def precond_rank_solves(torch, mesh, tmp):
    """Phase 16 on one rank: returns its results and (gathered) x's."""

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.ops.cuda_spmv import dia_spmv, dia_spmv_dot
    from iterativesolvers_tpu_torch.parallel import (
        HaloDIAOperator, ShardedBlockJacobiPreconditioner, gather_vector,
        shard_vector)
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    dev = mesh.device
    counters = (dia_spmv, dia_spmv_dot)

    def whole(name):
        d = torch.load(tmp / f"p16{name}.pt")
        return its.DIAMatrix(d["diags"], d["offsets"], d["shape"],
                             device="cpu")

    host_s = {}
    t0 = time.perf_counter()
    A = whole("A")
    P = ShardedBlockJacobiPreconditioner.ic(A, mesh, ordering="multicolor")
    torch.cuda.synchronize()
    host_s["ShardedBlockJacobiPreconditioner.ic multicolor"] = (
        time.perf_counter() - t0)
    op = HaloDIAOperator(A, mesh)
    n = A.shape[0]
    del A
    opS = HaloDIAOperator(whole("S"), mesh)
    b = shard_vector(torch.ones(n), mesh)
    bb = shard_vector(torch.load(tmp / "p16bb.pt"), mesh)
    res = {"rank": mesh.rank, "host_s": host_s, "nlevels": P.nlevels,
           "local_nlevels": P.local.nlevels,
           "level_bytes": P.local.lower_solve.nbytes
           + P.local.upper_solve.nbytes}
    xs = {}
    if mesh.rank == 0:
        warm_profiler(torch, dev)
    # the card's timed work waits until the main process has done its own
    _wait_for(tmp / "p16go")
    for name, o, rhs, Pl, chunk in (
            ("block_jacobi_ic", op, b, P, PW_CHUNK["rbic"]),
            ("rb_reduced_to_dia", opS, bb, None,
             PW_CHUNK["rb_reduced to_dia"])):
        def call(maxiter=PW_MAXITER, o=o, rhs=rhs, Pl=Pl, chunk=chunk):
            return its.cg(o, rhs, Pl=Pl, reltol=PW_RELTOL, maxiter=maxiter,
                          chunk=chunk, log=True)

        for f in counters:
            f.launches = 0
        torch.cuda.synchronize()
        mesh.all_reduce(torch.zeros(1, device=dev))
        (x, h), wall = timed_run(torch, call)
        steps = chunked_steps(h.iters, chunk)
        row = {"iters": h.iters, "converged": h.isconverged,
               "steps_run": steps, "wall_ms": wall,
               "us_per_step": wall / steps * 1e3,
               "launches": {f.__name__: f.launches for f in counters
                            if f.launches}}
        # the first TRACE_STEPS steps, traced on rank 0 (rank 1 runs the
        # same capped solve for its collectives)
        torch.cuda.synchronize()
        mesh.all_reduce(torch.zeros(1, device=dev))
        t0 = time.perf_counter()
        (_, twall), by_kernel = profiled(
            torch, lambda: timed_run(torch, lambda: call(TRACE_STEPS)), name,
            mesh)
        if mesh.rank == 0:
            row.update(busy_share=sum(by_kernel.values()) / twall,
                       trace_s=time.perf_counter() - t0)
        res[name] = row
        xs[name] = gather_vector(x, mesh).cpu()
    return res, xs


def warm_profiler(torch, dev):
    """One trace of a trivial op: ``torch.profiler``'s first trace in a
    process costs seconds (PERF.md), paid here while the process waits."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1).cpu()


def _wait_for(path):
    """Wait for the file ``path`` (the main process's go) or time out."""
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > PRECOND_RANK_WAIT:
            raise TimeoutError(f"a rank waited too long for {path.name}")
        time.sleep(0.2)


def precond_one_card(args):
    """Phase 16's one-card reference for the ranks' block-Jacobi CG
    (``--precond-one-card``): IC(0), multicolor, of the block-diagonal CSR
    (the ranks' blocks, the entries between them dropped) of the matrix
    saved under ``args.out``, built while the main process works; its CG
    waits for the file ``p16go1`` (the ranks done)."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.operators.preconditioners import (
        sorted_part)
    from iterativesolvers_tpu_torch.ops.cuda_spmv import dia_spmv_dot
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    tmp, dev = pathlib.Path(args.out), torch.device(P16_DEVICE)
    d = torch.load(tmp / "p16A.pt")
    A = its.DIAMatrix(d["diags"], d["offsets"], d["shape"], device=dev)
    t0 = time.perf_counter()
    C = A.to_csr()
    n = C.shape[0]
    nloc = n // DIST_RANKS
    rows, cols, _ = C._host_coo()
    keep = (rows // nloc) == (cols // nloc)
    indptr, indices = sorted_part(rows, cols, keep, n)
    blk = its.CSRMatrix(C.data.cpu()[torch.from_numpy(keep)], indices,
                        indptr, C.shape, row_ids=rows[keep], device=dev)
    del C, rows, cols, keep
    P = its.ICPreconditioner.from_operator(blk, ordering="multicolor")
    del blk
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    warm_profiler(torch, dev)
    _wait_for(tmp / "p16go1")
    b = torch.ones(n, device=dev)
    chunk = PW_CHUNK["rbic"]

    def call(maxiter=None):
        return its.cg(A, b, Pl=P, reltol=PW_RELTOL,
                      maxiter=maxiter or PW_MAXITER, chunk=chunk, log=True)

    dia_spmv_dot.launches = 0
    (x, h), wall = timed_run(torch, call)
    launches = dia_spmv_dot.launches
    t0 = time.perf_counter()
    (_, ht), by_kernel, syncs = syncs_and_trace(
        torch, lambda: call(TRACE_STEPS), "block-Jacobi IC(0) one card")
    trace_s = time.perf_counter() - t0
    steps = chunked_steps(h.iters, chunk)
    tsteps = chunked_steps(ht.iters, chunk)
    row = {"iters": h.iters, "converged": h.isconverged, "steps_run": steps,
           "wall_ms": wall, "us_per_step": wall / steps * 1e3,
           "launches": {"dia_spmv_dot": launches} if launches else {},
           "busy_share": sum(by_kernel.values()) / tsteps * steps / wall,
           "host_syncs_per_step": syncs / tsteps, "nlevels": P.nlevels,
           "host_s": host_s, "trace_s": trace_s}
    (tmp / "p16one.json").write_text(json.dumps(row))
    torch.save(x.cpu(), tmp / "p16one_x.pt")


class PrecondPhase:
    """Phase 16 (``run``).  ``A_int8`` is phase 4's int8 216^3 Laplacian,
    ``counters`` every kernel wrapper, ``bound`` the bound of (bytes,
    operations).  ``runs`` holds the runs by name, ``eager`` the eager
    computations' timings, ``host_s`` the builders' host seconds and
    ``launches`` the launches by kernels-line key and run."""

    def __init__(self, torch, its, A_int8, counters, bound):
        self.torch, self.its = torch, its
        self.A_int8, self.counters, self.bound = A_int8, counters, bound
        self.dev = torch.device(P16_DEVICE)
        self.runs, self.eager, self.host_s = {}, {}, {}
        self.launches, self.bad = {}, []
        self.t_start = time.perf_counter()

    # -- helpers ---------------------------------------------------------------
    def reset(self):
        for f in self.counters:
            f.launches = 0

    def counts(self):
        return {f.__name__: f.launches for f in self.counters if f.launches}

    def built(self, label, fn):
        """fn() timed on the host, the card synchronised after."""
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.host_s[label] = time.perf_counter() - t0
        return out

    def rel(self, x, ref):
        tn = self.torch.linalg.vector_norm
        return float(tn(x.double() - ref.double()) / tn(ref.double()))

    def true_res(self, op64, x, b):
        tn = self.torch.linalg.vector_norm
        b = b.double()
        return float(tn(b - op64.mv(x.double())) / tn(b))

    def record(self, name, row, ok, dia_dtype=None):
        """A run's row; its launches go to the kernels entries (the DIA
        kernel's by ``dia_dtype``: ``dia_spmv_dot[f32]``)."""
        row["phase_s"] = time.perf_counter() - self.t_start
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.4e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if not isinstance(v, (dict, list))),
            flush=True)
        self.runs[name] = row
        for kernel, c in row.get("launches", {}).items():
            key = (f"{kernel}[{dia_dtype}]" if kernel.startswith("dia_")
                   else kernel)
            self.launches.setdefault(key, {})[name] = c
        if not ok:
            self.bad.append(name)

    def solve(self, name, call, steps_of, trace_steps=TRACE_STEPS):
        """``call(None)`` between CUDA events, its launches counted, and
        with ``trace_steps`` ``call(trace_steps)`` (the same solve stopped
        there) under the profiler: (result, row of time a step, launches,
        busy share and host syncs a step), as phase 15's."""
        torch = self.torch
        self.reset()
        out, wall = timed_run(torch, lambda: call(None))
        c = self.counts()
        steps = max(steps_of(out), 1)
        row = {"wall_ms": wall, "steps_run": steps,
               "us_per_step": wall / steps * 1e3, "launches": c}
        if trace_steps:
            tout, by_kernel, syncs = syncs_and_trace(
                torch, lambda: call(trace_steps), name)
            tsteps = max(steps_of(tout), 1)
            row.update(busy_share=sum(by_kernel.values()) / tsteps * steps
                       / wall, host_syncs_per_step=syncs / tsteps,
                       traced_steps=tsteps)
        return out, row

    def apply_timing(self, label, fn, nbytes, levels=None):
        """One eager apply: ms (CUDA events over repeated calls) beside its
        byte bound, the card's busy share of one traced call (which must
        make no host sync), and with ``levels`` the time a level."""
        torch = self.torch
        ms = time_ms(torch, fn, reps=5, batches=3)[0]
        b_ms, _ = self.bound(nbytes, 0)

        reps = max(1, math.ceil(APPLY_TRACE_MS / ms))

        def calls():
            # a window of APPLY_TRACE_MS: on an H100, traces of one call or
            # four of a 0.2-0.4 ms apply came back with no device time
            for _ in range(reps):
                fn()

        _, by_kernel, syncs = syncs_and_trace(torch, calls, label)
        _, wall = timed_run(torch, calls)
        row = {"ms": ms, "bytes": nbytes, "bound_ms": b_ms,
               "over_bound": ms / b_ms,
               "busy_share": sum(by_kernel.values()) / wall,
               "traced_calls": reps, "host_syncs": syncs}
        if levels:
            row.update(levels=levels, us_per_level=ms * 1e3 / levels)
        if syncs:
            # an apply must not read the card back (CG's masking and
            # run_chunked rely on it)
            self.bad.append(f"{label}: {syncs} host syncs")
        self.eager[label] = row
        print(f"  eager {label}: {ms:.4f} ms, byte bound {b_ms:.4f} ms "
              f"({ms / b_ms:.1f}x), busy {row['busy_share']:.2f}"
              + (f", {row['us_per_level']:.2f} us a level over {levels}"
                 if levels else ""), flush=True)
        return row

    # -- the phase ---------------------------------------------------------------
    def run(self):
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            self._run(pathlib.Path(tmp))
        print(json.dumps({"phase16": self.runs, "phase16_eager": self.eager,
                          "phase16_host_s": self.host_s}))
        print(f"  phase 16: {time.perf_counter() - self.t_start:.1f} s")
        if self.bad:
            raise AssertionError(f"phase 16 runs off their limits: "
                                 f"{self.bad}")
        return self

    def _run(self, tmp):
        import numpy as np

        from iterativesolvers_tpu_torch.utils.fixtures import (
            variable_diffusion)

        torch, its = self.torch, self.its
        side, n = PW_SIDE, PW_SIDE**3
        print(f"phase 16: preconditioners, the reduced system and the "
              f"stationary methods ({side}^3 variable diffusion):",
              flush=True)
        A = self.built("variable_diffusion(216, 3) f32",
                       lambda: variable_diffusion(
                           side, 3, dtype=np.float32, device=self.dev,
                           **PW_FIXTURE))
        built = {"rb_reduced": self.built(
            "RBReducedSystem.from_dia f32",
            lambda: pw_build(its, "rb_reduced", A, side))}
        built["rb_reduced to_dia"] = self.built(
            "RBReducedSystem.to_dia f32", lambda: pw_build(
                its, "rb_reduced to_dia", A, side, built["rb_reduced"]))
        # the ranks' arrays, and the ranks, which build while the card works
        t0 = time.perf_counter()
        S, R = built["rb_reduced to_dia"]["S"], built["rb_reduced"]["R"]
        for name, M in (("A", A), ("S", S)):
            torch.save({"diags": [d.cpu() for d in M.diags],
                        "offsets": M.offsets, "shape": M.shape},
                       tmp / f"p16{name}.pt")
        torch.save(R.reduce_rhs(torch.ones(n, device=self.dev))[0].cpu(),
                   tmp / "p16bb.pt")
        self.host_s["save the ranks' arrays"] = time.perf_counter() - t0
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--world", str(DIST_RANKS), "--rendezvous",
               f"{tmp}/p16rendezvous", "--out", str(tmp)]
        t_ranks = time.perf_counter()
        procs = [subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for args in [["--precond-rank", str(r)]
                              for r in range(DIST_RANKS)]
                 + [["--precond-one-card"]]]

        def finish(group, names):
            """Wait for the processes ``group``; raise with the output of
            one that failed."""
            logs = []
            for p in group:
                left = DIST_TIMEOUT - (time.perf_counter() - t_ranks)
                logs.append(p.communicate(timeout=max(left, 1))[0].decode())
            for name, p, log in zip(names, group, logs):
                if p.returncode != 0:
                    print(f"phase 16 {name} output:\n{log[-6000:]}")
                    raise AssertionError(f"phase 16 {name} exited "
                                         f"{p.returncode}")

        try:
            x1 = self.legs(A, built)
            self.rbic_ab()
            self.lobpcg()
            self.ilu_gmres()
            self.mtx_gmres(tmp)
            self.stationary_sprand()
            self.stationary_216(A)
            # the card to the ranks, then to the one-card reference
            (tmp / "p16go").touch()
            finish(procs[:DIST_RANKS],
                   [f"rank {r}" for r in range(DIST_RANKS)])
            secs = time.perf_counter() - t_ranks
            (tmp / "p16go1").touch()
            finish(procs[DIST_RANKS:], ["one-card reference"])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = [json.loads((tmp / f"p16rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
        one = json.loads((tmp / "p16one.json").read_text())
        self.host_s["one-card block-diagonal IC(0) multicolor (its own "
                    "process)"] = one.pop("host_s")
        self.dist_checks(A, one, torch.load(tmp / "p16one_x.pt"),
                         built["rb_reduced"]["R"], x1, ranks,
                         torch.load(tmp / "p16x.pt"), secs)

    # -- 1. tpu_precond_win.py's legs at 216^3 -------------------------------
    def legs(self, A, built):
        """The six legs on b = 1 and the two seeded b, each f32 run held to
        the JAX package's; on b = 1 each leg's f64 twin.  Returns the x of
        the reduced system's DIA form on b = 1 for the distributed check."""
        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps

        side, n = PW_SIDE, PW_SIDE**3
        A64 = A.astype(torch.float64)
        out = None
        for leg, chunk in PW_CHUNK.items():
            if leg not in built:
                built[leg] = self.built(f"{leg} build f32",
                                        lambda: pw_build(its, leg, A, side))
            b64_built = self.built(
                f"{leg} build f64", lambda: pw_build(
                    its, leg, A64, side, self.f64_reduced)
                if leg == "rb_reduced to_dia" else pw_build(
                    its, leg, A64, side))
            if leg == "rb_reduced":
                self.f64_reduced = b64_built
            jleg = "rb_reduced" if leg == "rb_reduced to_dia" else leg
            per = 2 if leg == "rb_reduced to_dia" else 1
            kernel = leg in ("none", "jacobi", "rbic", "rb_reduced to_dia")
            band = pw_band(jleg)
            for bname in PW_BS:
                b = pw_rhs(torch, n, bname, self.dev)
                (x, h), row = self.solve(
                    f"{leg} {bname}",
                    lambda cap: pw_solve(its, leg, A, built[leg], b, cap),
                    lambda r: chunked_steps(r[1].iters, chunk),
                    TRACE_STEPS if bname == "ones" else None)
                want = ({"dia_spmv_dot": per * chunked_steps(h.iters, chunk)}
                        if kernel else {})
                jsteps, jres = JAX_PW[jleg][bname]
                res = self.true_res(A64, x, b)
                row = {"iters": h.iters, "jax_iters": jsteps,
                       "step_band": band,
                       "tpu_record_iters": (TPU_PW_STEPS.get(leg)
                                            if bname == "ones" else None),
                       "converged": h.isconverged, "true_residual": res,
                       "jax_true_residual": jres, "expected_launches": want,
                       **row}
                ok = (h.isconverged and abs(h.iters - jsteps) <= band
                      and res <= PW_RES_FACTOR * jres
                      and row["launches"] == want
                      and bool(torch.isfinite(x).all()))
                if bname == "ones":
                    self.reset()
                    x64, h64 = pw_solve(its, leg, A64, b64_built, b.double())
                    d64 = self.rel(x, x64)
                    row.update(f64_iters=h64.iters, x_rel_diff_f64=d64,
                               jax_x_rel_diff_f64=JAX_PW_X[jleg],
                               f64_launches=self.counts())
                    ok = (ok and h64.isconverged and not self.counts()
                          and d64 <= PW_X_FACTOR * JAX_PW_X[jleg])
                    if leg == "rb_reduced to_dia":
                        out = x
                    del x64
                self.record(f"precond_win {leg} {bname}", row, ok, "f32")
            self.eager_legs(leg, built[leg], A)
            if leg not in ("rb_reduced", "rb_reduced to_dia"):
                del built[leg]
            del b64_built
        del self.f64_reduced
        return out

    def eager_legs(self, leg, built, A):
        """The shift sums of the red-black applies at 216^3 against their
        byte bounds (the coefficient streams, the operand read and the
        result written once, at the card's memory rate)."""
        torch = self.torch
        from iterativesolvers_tpu_torch.operators.preconditioners import (
            shift_sum)

        n = A.shape[0]
        g = torch.Generator(device=self.dev).manual_seed(16)
        x = torch.randn(n, generator=g, device=self.dev)
        vec = [x, x]                           # read once, written once
        if leg == "rbic":
            P = built["P"]
            offs = [o for (o, _, _) in P.terms]
            self.apply_timing("rbic shift_sum",
                              lambda: shift_sum(offs, P.mcs, x),
                              stream_bytes(P.mcs, vec))
            self.apply_timing("rbic ldiv", lambda: P.ldiv(x), stream_bytes(
                P.mcs, [P.s_inv, P.red], vec))
        elif leg == "eisenstat":
            Ah = built["Ah"]
            offs = [o for (o, _, _) in Ah.terms]
            self.apply_timing("eisenstat shift_sum",
                              lambda: shift_sum(offs, Ah.mcs, x),
                              stream_bytes(Ah.mcs, vec))
            self.apply_timing("eisenstat mv", lambda: Ah.mv(x),
                              stream_bytes(Ah.mcs, [Ah.red], vec))
        elif leg == "rb_reduced":
            R = built["R"]
            xb = x[:R.nh]
            half = [xb, xb]
            self.apply_timing("rb_reduced to_red", lambda: R.to_red(xb),
                              stream_bytes(R.sr_streams, half))
            self.apply_timing("rb_reduced to_black", lambda: R.to_black(xb),
                              stream_bytes(R.sb_streams, half))
            self.apply_timing("rb_reduced mv", lambda: R.mv(xb), stream_bytes(
                R.sr_streams, R.sb_streams, half))
        elif leg == "rb_reduced to_dia":
            S = built["S"]
            xb = x[:S.shape[0]]
            self.apply_timing("rb_reduced to_dia mv (DIA kernel, 2 launches)",
                              lambda: S.mv(xb),
                              stream_bytes(S.diags, [xb, xb]))

    # -- 2. tpu_cg_rbic_ab.py: the int8 Laplacian +- RB-IC ----------------------
    def rbic_ab(self):
        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps

        Ai = self.A_int8
        n = Ai.shape[0]
        side = round(n ** (1 / 3))
        A64 = Ai.astype(torch.float64)
        P = self.built(f"RedBlackICPreconditioner.from_stencil {side}^3",
                       lambda: its.RedBlackICPreconditioner.from_stencil(
                           its.laplacian(side, 3, device=self.dev)))
        P64 = its.RedBlackICPreconditioner.from_stencil(
            its.laplacian(side, 3, dtype=torch.float64, device=self.dev))
        b = torch.ones(n, device=self.dev)
        for tag, Pl, Pl64 in (("unpreconditioned", None, None),
                              ("rbic", P, P64)):
            (x, h), row = self.solve(
                f"cg int8 {tag}", lambda cap: its.cg(
                    Ai, b, Pl=Pl, log=True, **dict(
                        RBIC_AB, maxiter=cap or RBIC_AB["maxiter"])),
                lambda r: chunked_steps(r[1].iters))
            x64 = its.cg(A64, b.double(), Pl=Pl64, **RBIC_AB)
            want = {"dia_spmv_dot": chunked_steps(h.iters)}
            res, d64 = self.true_res(A64, x, b), self.rel(x, x64)
            row = {"iters": h.iters, "tpu_record_iters":
                   TPU_RBIC_AB_STEPS[tag], "converged": h.isconverged,
                   "true_residual": res, "x_rel_diff_f64": d64,
                   "expected_launches": want, **row}
            ok = (h.isconverged and res <= TRUE_RES_F32 and d64 <= X_F64_REL
                  and row["launches"] == want)
            self.record(f"tpu_cg_rbic_ab {tag} int8 {side}^3", row, ok,
                        "int8")

    # -- 3. LOBPCG with IC(0) at 101^3 ----------------------------------------
    def lobpcg(self):
        import numpy as np

        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.utils.fixtures import laplace_dia

        side = EIG_SIDE
        A = laplace_dia(side, 3, dtype=np.float32, device=self.dev)
        n = A.shape[0]
        C = self.built(f"to_csr {side}^3", A.to_csr)
        Pn = self.built(f"ICPreconditioner natural {side}^3",
                        lambda: its.ICPreconditioner.from_operator(C))
        Pm = self.built(f"ICPreconditioner multicolor {side}^3",
                        lambda: its.ICPreconditioner.from_operator(
                            C, ordering="multicolor"))
        Prb = self.built(f"RedBlackICPreconditioner.from_stencil {side}^3",
                         lambda: its.RedBlackICPreconditioner.from_stencil(
                             its.laplacian(side, 3, device=self.dev)))
        del C
        levels = {"natural": Pn.nlevels, "multicolor": Pm.nlevels}
        print(f"  IC(0) {side}^3: nlevels {levels} (the JAX package's "
              f"{JAX_IC_NLEVELS}), level arrays "
              f"{(Pn.lower_solve.nbytes + Pn.upper_solve.nbytes) / 1e6:.1f} "
              f"MB natural", flush=True)
        if levels != JAX_IC_NLEVELS:
            self.bad.append(f"IC(0) nlevels {levels}")
        # the eager level sweep: one apply, and a row panel of 8
        g = torch.Generator(device=self.dev).manual_seed(16)
        x = torch.randn(n, generator=g, device=self.dev)
        X = torch.randn((EIG_P_BLOCK, n), generator=g, device=self.dev)
        vec = [x, x]
        for label, P in (("natural", Pn), ("multicolor", Pm)):
            nlev = P.lower_solve.nlevels + P.upper_solve.nlevels
            lv = [P.lower_solve.rows, P.lower_solve.cols, P.lower_solve.vals,
                  P.upper_solve.rows, P.upper_solve.cols, P.upper_solve.vals]
            self.apply_timing(f"IC(0) {label} ldiv {side}^3",
                              lambda: P.ldiv(x), stream_bytes(lv, vec),
                              levels=nlev)
            self.apply_timing(
                f"IC(0) {label} ldiv_rows ({EIG_P_BLOCK}, n) {side}^3",
                lambda: P.ldiv_rows(X), stream_bytes(lv, [X, X]),
                levels=nlev)
        X0 = torch.from_numpy(np.random.default_rng(EIG_P_SEED).standard_normal(
            (n, EIG_P_BLOCK)).astype(np.float32)).to(self.dev)
        h = np.pi / (2 * (side + 1))
        e1, e2 = 4 * np.sin(h) ** 2, 4 * np.sin(2 * h) ** 2
        exact = np.sort([3 * e1, e2 + 2 * e1, e2 + 2 * e1, e2 + 2 * e1])
        for tag, P in (("rbic", Prb), ("none", None), ("ic0 multicolor", Pm),
                       ("ic0 natural", Pn)):
            r, row = self.solve(
                f"lobpcg {tag}", lambda cap: its.lobpcg(
                    A, X0, largest=False, P=P, **dict(
                        EIG_P, maxiter=cap or EIG_P["maxiter"])),
                lambda r: r.iterations,
                None if tag == "ic0 natural" else TRACE_ITERS)
            lam = np.sort(r.lam.double().cpu().numpy())
            err = float(np.max(np.abs(lam - exact) / exact))
            want = {"dia_spmv": EIG_P_BLOCK * lobpcg_products(r.iterations)}
            row = {"iters": r.iterations, "tpu_record_iters":
                   TPU_EIG_P_ITERS[tag], "converged": r.converged,
                   "eig_max_rel_err": err, "expected_launches": want, **row}
            ok = (r.converged and err <= LAM_REL
                  and row["launches"] == want)
            self.record(f"lobpcg {tag} {side}^3 nev={EIG_P['nev']}", row, ok,
                        "f32")

    # -- 4. ILU(0) GMRES(20) and IC(0) GMRES on a .mtx matrix ---------------
    def gmres_row(self, name, call, maxiter, want_of, trace_steps):
        """(x, h, row) of a GMRES solve with its expected launches."""
        (x, h), row = self.solve(
            name, lambda cap: call(cap or maxiter),
            lambda r: r[1].iters, trace_steps)
        row = {"iters": h.iters, "restarts": h.restarts,
               "converged": h.isconverged,
               "expected_launches": want_of(h), **row}
        return x, h, row

    def ilu_gmres(self):
        import numpy as np

        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.utils.fixtures import (
            advection_diffusion)

        N = ILU_SIDE
        m = ILU_GMRES["restart"]
        A, b = advection_diffusion(N, dtype=np.float32, device=self.dev)
        A64, b64 = advection_diffusion(N, dtype=np.float64, device=self.dev)
        b, b64 = torch.from_numpy(b).to(self.dev), torch.from_numpy(
            b64).to(self.dev)
        C = self.built(f"to_csr advection_diffusion({N})", A.to_csr)
        C64 = A64.to_csr()

        def want(h):
            cycles = h.restarts + 1
            return {"dia_spmv": (m + 1) * cycles, "panel_mgs": m * cycles}

        for ordering in ("natural", "multicolor"):
            P = self.built(f"ILUPreconditioner {ordering} {N}^3",
                           lambda: its.ILUPreconditioner.from_operator(
                               C, ordering=ordering))
            P64 = its.ILUPreconditioner.from_operator(C64, ordering=ordering)
            x, h, row = self.gmres_row(
                f"ilu gmres {ordering}", lambda mi: its.gmres(
                    A, b, Pl=P, log=True, **dict(ILU_GMRES, maxiter=mi)),
                ILU_GMRES["maxiter"], want,
                None if ordering == "natural" else TRACE_STEPS)
            self.reset()
            x64 = its.gmres(A64, b64, Pl=P64, **ILU_GMRES)
            jit_, jres, jx = JAX_ILU[ordering]
            res, d64 = self.true_res(A64, x, b64), self.rel(x, x64)
            row.update(nlevels=P.nlevels, jax_iters=jit_, true_residual=res,
                       jax_true_residual=jres, x_rel_diff_f64=d64,
                       jax_x_rel_diff_f64=jx, f64_launches=self.counts())
            band = max(ILU_STEP_BAND, 0.1 * jit_)
            ok = (h.isconverged and abs(h.iters - jit_) <= band
                  and res <= PW_RES_FACTOR * jres
                  and d64 <= PW_X_FACTOR * jx and not row["f64_launches"]
                  and row["launches"] == row["expected_launches"])
            self.record(f"ilu(0) gmres({m}) {ordering} {N}^3", row, ok, "f32")
            if ordering == "natural":
                v = torch.randn(A.shape[0], device=self.dev)
                lv = [t for s in (P.lower_solve, P.upper_solve)
                      for t in (s.rows, s.cols, s.vals)]
                self.apply_timing(f"ILU(0) natural ldiv {N}^3",
                                  lambda: P.ldiv(v), stream_bytes(lv, [v, v]),
                                  levels=P.lower_solve.nlevels
                                  + P.upper_solve.nlevels)
            del P, P64

    def mtx_gmres(self, tmp):
        import numpy as np

        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.utils.fixtures import (
            laplace_matrix_coo)

        side, m = MTX_P_SIDE, MTX_P_GMRES["restart"]
        rows, cols, vals, n = laplace_matrix_coo(side, 2, dtype=np.float64)
        path = tmp / "laplace_120.mtx"
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"{n} {n} {len(vals)}\n")
            for r, c, v in zip(rows + 1, cols + 1, vals):
                f.write(f"{r} {c} {v:.17g}\n")
        A = its.load_matrix_market(path, dtype=np.float32, device=self.dev)
        P = self.built(f"ICPreconditioner {side}^2 .mtx",
                       lambda: its.ICPreconditioner.from_operator(A))
        b = torch.ones(n, device=self.dev)
        x, h, row = self.gmres_row(
            f"ic gmres mtx {side}^2", lambda mi: its.gmres(
                A, b, Pl=P, log=True, **dict(MTX_P_GMRES, maxiter=mi)),
            MTX_P_GMRES["maxiter"],
            lambda h: {"panel_mgs": m * (h.restarts + 1)}, None)
        res = self.true_res(A.astype(torch.float64), x, b)
        row.update(true_residual=res, nlevels=P.nlevels)
        ok = (h.isconverged and res <= MTX_P_RES
              and row["launches"] == row["expected_launches"])
        self.record(f"run_all ic(0) gmres({m}) mtx {side}^2", row, ok)

    # -- 5. the stationary methods ---------------------------------------------
    def stationary_sprand(self):
        import numpy as np

        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.utils.fixtures import random_sparse

        n = STAT_N
        kw = dict(seed=2, symmetrize=True, shift=4.0, device=self.dev)
        A = random_sparse(n, n, 5.0 / n, dtype=np.float32, **kw)
        A64 = random_sparse(n, n, 5.0 / n, dtype=np.float64, **kw)
        b = torch.ones(n, device=self.dev)
        for name, fn, extra, okw in (
                ("jacobi", its.jacobi, (), {}),
                ("gauss_seidel", its.gauss_seidel, (), {}),
                ("sor", its.sor, (1.1,), {}), ("ssor", its.ssor, (1.1,), {}),
                ("gs_multicolor", its.gauss_seidel, (),
                 {"ordering": "multicolor"}),
                ("sor_multicolor", its.sor, (1.1,),
                 {"ordering": "multicolor"})):
            self.reset()
            x, wall = timed_run(torch, lambda: fn(A, b, *extra,
                                                   maxiter=STAT_SWEEPS, **okw))
            c = self.counts()
            x64 = fn(A64, b.double(), *extra, maxiter=STAT_SWEEPS, **okw)
            j = JAX_STAT[name]
            xh = x.double().cpu().numpy()
            head = np.asarray(j["x_head"])
            errs = {"x_norm2": abs(np.linalg.norm(xh) - j["x_norm2"])
                    / j["x_norm2"],
                    "x_norm1": abs(np.abs(xh).sum() - j["x_norm1"])
                    / j["x_norm1"],
                    "x_head": float(np.abs(xh[:STAT_HEAD] - head).max()
                                    / np.abs(head).max())}
            d64 = self.rel(x, x64)
            lim = max(PW_X_FACTOR * j["x_rel_diff_f64"], STAT_REL)
            row = {"sweeps": STAT_SWEEPS, "wall_ms": wall,
                   "us_per_sweep": wall / STAT_SWEEPS * 1e3,
                   "launches": c, "x_rel_diff_f64": d64,
                   "jax_x_rel_diff_f64": j["x_rel_diff_f64"],
                   **{f"{k}_rel_err_vs_jax": v for k, v in errs.items()}}
            ok = (max(errs.values()) <= STAT_REL and d64 <= lim and not c
                  and bool(torch.isfinite(x).all()))
            self.record(f"stationary sprand {name}", row, ok)

    def stationary_216(self, A):
        """gauss_seidel and sor(1.1), natural and multicolor, 20 sweeps on
        the 216^3 variable-diffusion CSR through the public calls; the same
        sweeps in f64 on the card (the f32 split's level arrays and colors
        with f64 values)."""
        torch, its = self.torch, self.its
        from iterativesolvers_tpu_torch.ops.triangular import (
            LevelScheduledTriangular)
        from iterativesolvers_tpu_torch.solvers import stationary as pst

        C = self.built("to_csr 216^3 variable diffusion", A.to_csr)
        n = C.shape[0]
        b = torch.ones(n, device=self.dev)
        split = self.built("stationary split natural 216^3",
                           lambda: pst._split_matrix(
                               C, need_lower_solve=True))
        color, nc = self.built("greedy coloring 216^3",
                               lambda: pst._color_classes(C))
        color = torch.from_numpy(color).to(self.dev)
        lo = split.lower_solve
        lo64 = LevelScheduledTriangular(lo.rows, lo.cols,
                                        lo.vals.double(), lo.diag.double(),
                                        lo.n, device=self.dev)
        split64 = split._replace(
            diag=split.diag.double(),
            lower_mv=split.lower_mv.astype(torch.float64),
            upper_mv=split.upper_mv.astype(torch.float64),
            lower_solve=lo64)
        print(f"  stationary {PW_SIDE}^3: {lo.nlevels} levels a natural "
              f"sweep, level arrays {lo.nbytes / 1e6:.1f} MB (f32), "
              f"{nc} colors", flush=True)
        x0 = torch.zeros(n, device=self.dev)
        for method, omega in (("gauss_seidel", None), ("sor", 1.1)):
            fn = getattr(its, method)
            args = () if omega is None else (omega,)
            for ordering in ("natural", "multicolor"):
                self.reset()
                x, wall = timed_run(torch, lambda: fn(
                    C, b, *args, maxiter=STAT_SWEEPS, ordering=ordering))
                c = self.counts()
                om64 = pst._omega(omega, split64)
                if ordering == "natural":
                    sweep = pst._SWEEPS[method]
                    x64 = pst._run(lambda v: sweep(split64, b.double(), v,
                                                   om64),
                                   STAT_SWEEPS, x0.double())
                    om = pst._omega(omega, split)
                    f32 = lambda k=STAT_SWEEPS: pst._run(  # noqa: E731
                        lambda v: sweep(split, b, v, om), k, x0)
                else:
                    x64 = pst._run(lambda v: pst._mc_sweep(
                        method, nc, split64, color, b.double(), v, om64),
                        STAT_SWEEPS, x0.double())
                    om = pst._omega(omega, split)
                    f32 = lambda k=STAT_SWEEPS: pst._run(  # noqa: E731
                        lambda v: pst._mc_sweep(method, nc, split, color, b,
                                                v, om), k, x0)
                # the sweeps alone (the public call's wall holds its build),
                # and a trace of the first sweeps (all of them multicolor)
                xs, sweeps_ms = timed_run(torch, f32)
                traced = (STAT_SWEEPS if ordering == "multicolor"
                          else STAT_TRACE_SWEEPS)
                _, by_kernel, syncs = syncs_and_trace(
                    torch, lambda: f32(traced), f"{method} {ordering}")
                d64 = self.rel(x, x64)
                row = {"sweeps": STAT_SWEEPS, "call_wall_ms": wall,
                       "sweeps_ms": sweeps_ms,
                       "us_per_sweep": sweeps_ms / STAT_SWEEPS * 1e3,
                       "busy_share": sum(by_kernel.values()) / traced
                       * STAT_SWEEPS / sweeps_ms, "traced_sweeps": traced,
                       "host_syncs": syncs, "launches": c,
                       "x_rel_diff_f64": d64,
                       "public_equals_split": bool(torch.equal(x, xs))}
                if ordering == "natural" and method == "gauss_seidel":
                    row["us_per_level"] = (sweeps_ms * 1e3 / STAT_SWEEPS
                                           / lo.nlevels)
                ok = (d64 <= STAT_216_X_REL and not c and syncs == 0
                      and row["public_equals_split"])
                self.record(f"stationary {method} {ordering} {PW_SIDE}^3",
                            row, ok)
        self.apply_timing(
            f"level sweep (lower solve) natural {PW_SIDE}^3",
            lambda: lo.solve(b), stream_bytes(
                [lo.rows, lo.cols, lo.vals, lo.diag], [b, b]),
            levels=lo.nlevels)

    # -- 6. distributed: block-Jacobi IC(0) and the reduced system's DIA form
    def dist_checks(self, A, one, x1, R, x_red1, ranks, xs, secs):
        """The ranks' solves against one card's: block-Jacobi IC(0) CG
        against ``one`` (the one-card reference process's row) and its
        ``x1`` (equal steps, x within twice phase 4's f32 limit), and the
        reduced system's DIA form in a halo operator against the one-card
        solve's ``x_red1`` (steps within the band, x)."""
        torch = self.torch
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps

        n = A.shape[0]
        A64 = A.astype(torch.float64)
        b = torch.ones(n, device=self.dev)
        chunk = PW_CHUNK["rbic"]
        x1 = x1.to(self.dev)
        r0 = ranks[0]
        for r in ranks[1:]:
            for key in ("block_jacobi_ic", "rb_reduced_to_dia"):
                if r[key]["iters"] != r0[key]["iters"]:
                    self.bad.append(f"ranks disagree on {key}")
        d = r0["block_jacobi_ic"]
        xd = xs["block_jacobi_ic"].to(self.dev)
        dx = self.rel(xd, x1)
        res = self.true_res(A64, xd, b)
        want1 = {"dia_spmv_dot": chunked_steps(one["iters"], chunk)}
        row = {"ranks": DIST_RANKS, "iters": d["iters"],
               "one_card_iters": one["iters"], "nlevels": r0["nlevels"],
               "one_card_nlevels": one["nlevels"],
               "true_residual": res, "x_rel_diff_one_card": dx,
               "one_card_us_per_step": one["us_per_step"],
               "one_card_busy_share": one["busy_share"],
               "one_card_launches": one["launches"],
               "one_card_trace_s": one["trace_s"], "ranks_s": secs,
               "rank_host_s": [r["host_s"] for r in ranks],
               **{k: v for k, v in d.items() if k != "launches"},
               "launches": d["launches"]}
        ok = (d["converged"] and one["converged"]
              and d["iters"] == one["iters"] and dx <= 2 * X_F64_REL
              and r0["nlevels"] == one["nlevels"] == 2
              and not d["launches"] and one["launches"] == want1)
        self.record(f"block-Jacobi IC(0) multicolor CG, {DIST_RANKS} ranks",
                    row, ok)
        s = r0["rb_reduced_to_dia"]
        xb = xs["rb_reduced_to_dia"].to(self.dev)
        one = self.runs["precond_win rb_reduced to_dia ones"]
        x_dist = R.expand_solution(xb, R.reduce_rhs(b)[1])
        dxb = self.rel(x_dist, x_red1)
        row = {"ranks": DIST_RANKS, "iters": s["iters"],
               "one_card_iters": one["iters"], "x_rel_diff_one_card": dxb,
               **{k: v for k, v in s.items() if k != "launches"},
               "launches": s["launches"]}
        ok = (s["converged"] and abs(s["iters"] - one["iters"])
              <= pw_band("rb_reduced") and dxb <= 2 * X_F64_REL
              and not s["launches"])
        self.record(f"rb_reduced to_dia CG in HaloDIAOperator, "
                    f"{DIST_RANKS} ranks", row, ok)


# ---- phase 17: the rest of parallel/ on ranks over gloo (one card) ----------
# Two rank processes of this script (``--mesh-rank``) on the one card over
# gloo, as phases 12 and 16 run theirs, then four (``--slice-rank``) on a
# (2, 2) slice mesh.  Each run is held against the same run on one card, made
# in this phase, and its f64 or analytic reference.  The 216^3 operators of
# the main path; LOBPCG at 100^3 (10^6 rows: the halo operators need D to
# divide n, and 101^3 is odd); phase 15's 1M-row scrambled ELL pick; the
# 100^3 gradient's ELL (3 x 10^6 x 10^6) with and without its adjoint; a
# dense f32 matrix of odd n (8191 x 8191, 268 MB) on the padded shard.
MESH_RANKS = 2
SLICE = (2, 2)
MESH_TIMEOUT = 600                 # seconds the ranks of one launch may take
MESH_EIG_SIDE = 100
MESH_DENSE_N = 8191
MESH_GMRES = dict(restart=GM_RESTART, reltol=1e-5, maxiter=400)
MESH_REPS = 5                      # timed mv_rows panels
# a distributed f32 solve that stops well above the rounding floor (LSQR,
# LSMR on the shifted stencil and the gradient's ELL) against the same
# solve on one card: x within MESH_X_REL, steps within CG_STEP_SPREAD.
# Only the sum order of a reduction differs: the readings reach 1.6e-7
# (PERF.md).  The control is the one-card solve cut one step short, which
# the limit must reject.  CG on the scrambled ELL is held to MESH_X_REL
# too, but stops near f32's rounding floor, where one step moves x about
# as much as rounding: its control is recorded, and its steps and true
# residual hold it.  The CG runs at 216^3 stop at that floor: x within
# X_F64_REL of f64 (phase 4's spread), and shard_ell's CG within twice
# that of one card's CG on the same ELL matrix; GMRES on the dense
# operator as phase 12's.
MESH_X_REL = 1e-6


def dia_as_ell(its, A):
    """The DIA matrix ``A`` as an ELLMatrix of width len(offsets) on its
    device: row i holds (A[i, i + o], i + o) for each offset o, its column
    clamped into range where the diagonal is structurally zero there."""
    import torch

    n = A.shape[0]
    i = torch.arange(n, device=A.diags[0].device)
    cols = torch.stack([(i + o).clamp(0, n - 1) for o in A.offsets], dim=1)
    data = torch.stack([d.float() for d in A.diags], dim=1)
    return its.ELLMatrix(data, cols.int(), A.shape, device=data.device)


def mesh_rank(args):
    """One rank of phase 17 (``--mesh-rank``, or ``--slice-rank`` on the
    slice mesh): runs the distributed solves on the card and writes its
    results (rank 0 also the gathered solutions) under ``args.out``."""
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke rank: torch.cuda.is_available() is false")
    from iterativesolvers_tpu_torch.parallel import row_mesh, slice_mesh

    common = dict(init_method=f"file://{args.rendezvous}",
                  timeout=DIST_COLLECTIVE_TIMEOUT)
    if args.slice_rank is not None:
        rank = args.slice_rank
        mesh = slice_mesh(*SLICE, "gloo", "cuda:0", rank=rank,
                          world_size=SLICE[0] * SLICE[1], **common)
    else:
        rank = args.mesh_rank
        mesh = row_mesh("gloo", "cuda:0", rank=rank,
                        world_size=args.world, **common)
    # the rank's own start: torch, the package and the process group
    init_s = time.perf_counter() - t0
    try:
        if args.slice_rank is not None:
            # started beside the two-rank launch: wait until it has ended
            _wait_for(pathlib.Path(args.out) / "go")
        res, xs = MeshRank(torch, mesh, args.out).run(
            slice_only=args.slice_rank is not None)
        res["setup_s"]["rank start (imports, process group)"] = init_s
    finally:
        mesh.close()
    with open(f"{args.out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    if rank == 0:
        torch.save(xs, f"{args.out}/x.pt")


class MeshRank:
    """Phase 17 on one rank: every run with the kernels' counts set to 0
    just before it and read after, its collectives counted
    (``utils/profiling.collective_counts``), timed on this rank's clock
    between barriers; the gathered solutions kept on rank 0."""

    def __init__(self, torch, mesh, tmp):
        from iterativesolvers_tpu_torch.ops import cuda_panel_ortho as cpo
        from iterativesolvers_tpu_torch.ops.cuda_spmv import (dia_spmv,
                                                              dia_spmv_dot)
        from iterativesolvers_tpu_torch.ops.cuda_stencil import stencil_apply

        self.torch, self.mesh, self.tmp = torch, mesh, tmp
        self.dev = mesh.device
        self.counters = (stencil_apply, dia_spmv, dia_spmv_dot,
                         cpo.panel_dots, cpo.panel_update)
        self.res = {"rank": mesh.rank, "setup_s": {}}
        self.xs = {}

    def sync(self):
        self.torch.cuda.synchronize()
        self.mesh.all_reduce(self.torch.zeros(1, device=self.dev))

    def built(self, label, fn):
        """fn() (an operator's set-up), its host seconds recorded."""
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.res["setup_s"][label] = time.perf_counter() - t0
        return out

    def run(self, slice_only=False):
        import iterativesolvers_tpu_torch as its

        self.its = its
        St = its.laplacian(SIDE, 3, device=self.dev)
        Hs = self.built("halo stencil 216^3", lambda: self.halo(St))
        if slice_only:
            self.cg_runs(Hs, ())
            return self.res, self.xs
        self.rows_and_block(St, Hs)
        self.eigen_svd_lsq(St, Hs)
        self.ell_runs()
        self.dense_gmres()
        self.cg_runs(Hs, ("dia", "ell"))
        return self.res, self.xs

    def halo(self, St):
        from iterativesolvers_tpu_torch.parallel import HaloStencilOperator

        return HaloStencilOperator(St, self.mesh)

    def timed(self, name, fn, steps_of):
        """fn() with the counts set to 0 just before and read after."""
        from iterativesolvers_tpu_torch.utils.profiling import (
            collective_counts)

        torch = self.torch
        for f in self.counters:
            f.launches = 0
        self.sync()
        levels = dict(getattr(self.mesh, "level_counts", {}))
        t0 = time.perf_counter()
        with collective_counts(self.mesh) as coll:
            out = fn()
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = max(int(steps_of(out)), 1)
        self.res[name] = {
            "steps_run": steps, "s": secs, "ms_per_step": secs / steps * 1e3,
            "launches": {f.__name__: f.launches for f in self.counters
                         if f.launches},
            "collectives": coll,
            "collectives_per_step": {k: v / steps for k, v in coll.items()
                                     if v}}
        if levels:
            # the slice mesh's all-reduces by level (one of each a sum)
            self.res[name]["level_all_reduces"] = {
                k: v - levels[k] for k, v in self.mesh.level_counts.items()}
        return out

    def keep(self, name, x):
        from iterativesolvers_tpu_torch.parallel import gather_vector

        full = gather_vector(x, self.mesh)
        if self.mesh.rank == 0:
            self.xs[name] = full.cpu()

    def history(self, name, h, **extra):
        self.res[name].update(iters=h.iters, converged=h.isconverged,
                              **extra)

    def rows_and_block(self, St, Hs):
        """a. mv_rows of a (16, n) panel, stencil and f32 DIA, each rank's
        rows against one card's mv_rows of the whole panel; b. block CG."""
        from iterativesolvers_tpu_torch.parallel import HaloDIAOperator
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps
        from iterativesolvers_tpu_torch.utils.fixtures import laplace_dia

        torch, its, mesh = self.torch, self.its, self.mesh
        n = St.n
        lo, hi = mesh.rows(n)
        self.A = laplace_dia(SIDE, 3, dtype="float32", device=self.dev)
        self.Hd = self.built("halo dia 216^3",
                             lambda: HaloDIAOperator(self.A, mesh))
        g = torch.Generator(device=self.dev).manual_seed(17)
        X = torch.randn(ROWS, n, generator=g, device=self.dev)
        Xl = X[:, lo:hi].contiguous()
        for tag, op, one in (("stencil", Hs, St), ("dia_f32", self.Hd,
                                                   self.A)):
            name = f"mv_rows {tag}"
            Y = self.timed(name, lambda: op.mv_rows(Xl), lambda _: 1)
            Y1 = one.mv_rows(X)[:, lo:hi]
            err = float((Y - Y1).abs().max())
            # a panel's time on the ranks (host clock: each exchange waits
            # for the host) and, on rank 0 alone, one card's mv_rows of the
            # whole panel between CUDA events
            self.sync()
            t0 = time.perf_counter()
            for _ in range(MESH_REPS):
                op.mv_rows(Xl)
            torch.cuda.synchronize()
            ms = {"ms_panel": (time.perf_counter() - t0) / MESH_REPS * 1e3}
            if mesh.rank == 0:
                ms["one_card_ms_panel"] = timed_run(torch, lambda: [
                    one.mv_rows(X) for _ in range(MESH_REPS)])[1] / MESH_REPS
            self.sync()
            self.res[name].update(max_abs_err=err,
                                  max_abs_y=float(Y1.abs().max()), **ms)
            del Y, Y1
        del X, Xl
        # b. block CG, k = 8: column 0 = 1, the rest normal from seed 171
        g = torch.Generator(device=self.dev).manual_seed(171)
        B = torch.randn(n, BLOCK_K, generator=g, device=self.dev)
        B[:, 0] = 1.0
        Bl = B[lo:hi].contiguous()
        del B
        X, h = self.timed("block_cg", lambda: its.block_cg(
            Hs, Bl, reltol=RELTOL, log=True),
            lambda o: chunked_steps(o[1].iters))
        self.history("block_cg", h,
                     all_columns=bool(h["converged_per_rhs"].all()))
        self.keep("block_cg", X)

    def eigen_svd_lsq(self, St, Hs):
        """c. LOBPCG at 100^3; d. svdl on the 216^3 stencil, LSQR and LSMR
        on the shifted 216^3 stencil."""
        import numpy as np

        from iterativesolvers_tpu_torch.parallel import shard_vector
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps

        torch, its, mesh = self.torch, self.its, self.mesh
        S100 = its.laplacian(MESH_EIG_SIDE, 3, device=self.dev)
        H100 = self.built("halo stencil 100^3", lambda: self.halo(S100))
        X0 = shard_vector(np.random.default_rng(0).standard_normal(
            (S100.n, ROWS)).astype(np.float32), mesh)
        r = self.timed("lobpcg", lambda: its.lobpcg(
            H100, X0, tol=LOBPCG_TOL, maxiter=LOBPCG_MAXITER),
            lambda r: r.iterations)
        self.res["lobpcg"].update(
            iters=r.iterations, converged=r.converged,
            lam=r.lam.double().tolist(),
            max_residual_norm=float(r.residual_norms.max()))
        vals, _, h = self.timed("svdl", lambda: its.svdl(
            Hs, nsv=SVDL_NSV, tol=SVDL_TOL, maxiter=SVDL_MAXITER, log=True,
            key=torch.Generator(device=self.dev).manual_seed(0)),
            lambda o: o[2].iters)
        self.history("svdl", h, values=vals.double().tolist())
        Sh = self.built("halo shifted stencil 216^3", lambda: self.halo(
            its.StencilOperator(St.n, 7.0, St.terms, St.coeffs,
                                device=self.dev)))
        b = torch.ones(Sh.n_local, device=self.dev)
        for solver in ("lsqr", "lsmr"):
            x, h = self.timed(solver, lambda: getattr(its, solver)(
                Sh, b, atol=LSQ_TOL, btol=LSQ_TOL, maxiter=LSQ_MAXITER,
                log=True), lambda o: chunked_steps(o[1].iters))
            self.history(solver, h, istop=h["istop"])
            self.keep(solver, x)

    def ell_runs(self):
        """e. CG on the 1M-row scrambled ELL pick; LSQR on the 100^3
        gradient's ELL with its adjoint and with the reduce-scatter rmv."""
        from iterativesolvers_tpu_torch.parallel import (RowShardedELLOperator,
                                                         shard_vector)
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps

        torch, its, mesh = self.torch, self.its, self.mesh
        inp = torch.load(f"{self.tmp}/ell.pt")

        def ell(key, adj=None):
            return its.ELLMatrix(inp[f"{key}_data"], inp[f"{key}_cols"],
                                 tuple(inp[f"{key}_shape"].tolist()),
                                 adj=adj, device=self.dev)

        Es = self.built("ell scrambled 1M", lambda: RowShardedELLOperator(
            ell("scr"), mesh))
        b = torch.ones(Es.local.shape[0], device=self.dev)
        x, h = self.timed("cg ell scrambled", lambda: its.cg(
            Es, b, reltol=FS_RELTOL, maxiter=FS_MAXITER, log=True),
            lambda o: chunked_steps(o[1].iters))
        self.history("cg ell scrambled", h)
        self.keep("cg ell scrambled", x)
        bg = shard_vector(inp["bg"], mesh)
        for tag, adj in (("adjoint", ell("gadj")), ("reduce-scatter", None)):
            name = f"lsqr gradient ell {tag}"
            Eg = self.built(name, lambda: RowShardedELLOperator(
                ell("grad", adj), mesh))
            x, h = self.timed(name, lambda: its.lsqr(
                Eg, bg, damp=1.0, maxiter=GRAD_LSQ_MAXITER, log=True),
                lambda o: chunked_steps(o[1].iters))
            self.history(name, h, istop=h["istop"])
            self.keep(name, x)
            del Eg

    def dense_gmres(self):
        """f. GMRES(20) on the dense f32 operator at odd n: the sharded-panel
        route with the padded last shard, and its witness (the two sweeps'
        plain versions)."""
        from iterativesolvers_tpu_torch.ops import cuda_panel_ortho as cpo
        from iterativesolvers_tpu_torch.parallel import DenseMeshOperator
        from iterativesolvers_tpu_torch.parallel import panel_ortho as po

        torch, its, mesh = self.torch, self.its, self.mesh
        Dm = self.built("dense 8191", lambda: DenseMeshOperator(
            dense_matrix(torch, self.dev), mesh))
        b = torch.ones(Dm.mat.shape[0], device=self.dev)
        x, h = self.timed("gmres dense", lambda: its.gmres(
            Dm, b, log=True, **MESH_GMRES), lambda o: o[1].iters)
        self.history("gmres dense", h, restarts=h.restarts)
        self.keep("gmres dense", x)
        with routed(po, panel_dots=cpo.panel_dots_plain,
                    panel_update=cpo.panel_update_plain):
            xw, hw = self.timed("gmres dense witness", lambda: its.gmres(
                Dm, b, log=True, **MESH_GMRES), lambda o: o[1].iters)
        self.history("gmres dense witness", hw, restarts=hw.restarts)
        self.keep("gmres dense witness", xw)

    def cg_runs(self, Hs, shards):
        """CG on the 216^3 stencil (the slice mesh's run, and the two-rank
        one it is held against); h. CG through shard_dia / shard_ell, which
        return the halo DIA and ELL operators themselves: one run serves
        each and its counterpart."""
        from iterativesolvers_tpu_torch.parallel import (HaloDIAOperator,
                                                         RowShardedELLOperator,
                                                         shard_dia, shard_ell)
        from iterativesolvers_tpu_torch.solvers.common import chunked_steps

        torch, its, mesh = self.torch, self.its, self.mesh
        b = torch.ones(Hs.n_local, device=self.dev)
        ops = [("cg stencil", Hs)]
        if "dia" in shards:
            Hd = self.built("shard_dia 216^3", lambda: shard_dia(self.A, mesh))
            if type(Hd) is not HaloDIAOperator:
                raise AssertionError(f"shard_dia gave {type(Hd).__name__}")
            ops.append(("cg shard_dia", Hd))
            del Hd
        if "ell" in shards:
            # its one-card twin is the same ELL matrix's CG on one card
            E = self.built("laplacian ell 216^3",
                           lambda: dia_as_ell(its, self.A))
            Es = self.built("shard_ell 216^3", lambda: shard_ell(E, mesh))
            if type(Es) is not RowShardedELLOperator:
                raise AssertionError(f"shard_ell gave {type(Es).__name__}")
            ops.append(("cg shard_ell", Es))
            del E, Es
        for name, op in ops:
            x, h = self.timed(name, lambda: its.cg(
                op, b, reltol=RELTOL, log=True, chunk=CHUNK,
                maxiter=KRYLOV_MAXITER), lambda o: chunked_steps(o[1].iters))
            self.history(name, h)
            self.keep(name, x)
            del x


def dense_matrix(torch, dev):
    """phase 17's dense f32 matrix: 4 I + 0.5 N / sqrt(n), N normal from
    seed 1717 drawn on the card (the same on every process)."""
    n = MESH_DENSE_N
    g = torch.Generator(device=dev).manual_seed(1717)
    M = torch.randn(n, n, generator=g, device=dev).mul_(0.5 / n**0.5)
    M.diagonal().add_(4.0)
    return M


def start_ranks(world, tmp, flag):
    """``world`` rank processes of this script with ``flag`` (file
    rendezvous under ``tmp``): the Popen objects and their start time."""
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--world", str(world), "--rendezvous", f"{tmp}/rendezvous",
           "--out", tmp]
    t0 = time.perf_counter()
    return [subprocess.Popen(cmd + [flag, str(r)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(world)], t0


def wait_ranks(torch, procs, t0, tmp, label):
    """Each rank's results and rank 0's gathered solutions; a rank that
    fails or outlasts MESH_TIMEOUT fails the phase."""
    logs = []
    try:
        for p in procs:
            left = MESH_TIMEOUT - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"phase 17 {label} rank {r} output:\n{log[-6000:]}")
            raise AssertionError(f"phase 17 {label} rank {r} exited "
                                 f"{p.returncode}")
    ranks = []
    for r in range(len(procs)):
        with open(f"{tmp}/rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks, torch.load(f"{tmp}/x.pt"), secs


class MeshPhase:
    """Phase 17 (``run``).  ``St`` the 216^3 stencil, ``A`` its f32 DIA
    matrix (the f64 one's product runs no kernel), ``x64`` the f64 CG
    solution of b = 1, ``cg1`` phase 4's one-card CG on the stencil (x,
    history) and ``res_pl`` its plain-version true residual;
    ``scrambled`` phase 15's 1M-row scrambled CSR and its ELL pick.
    ``run`` returns the ranks' launches by kernel and run."""

    def __init__(self, torch, its, St, A, x64, cg1, res_pl, scrambled):
        self.torch, self.its, self.St, self.A = torch, its, St, A
        self.A64 = A.astype(torch.float64)
        self.x64, self.cg1, self.res_pl = x64, cg1, res_pl
        self.scrambled = scrambled
        self.rows, self.bad, self.host_s = {}, [], {}
        self.launches = {}

    # -- helpers -----------------------------------------------------------
    def rel(self, x, ref):
        torch = self.torch
        return float(torch.linalg.vector_norm(x.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    def true_res(self, op64, x, b):
        torch = self.torch
        r = b.double() - op64(x.double())
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(b.double()))

    def record(self, name, ranks, ok, as_name=None, **row):
        """The run's row (under ``as_name``, by default ``name``): rank 0's
        record beside ``row``; the ranks must agree on the steps."""
        r0 = ranks[0][name]
        same = all(r[name].get("iters") == r0.get("iters") for r in ranks)
        row = {**{k: v for k, v in r0.items() if k != "lam"}, **row,
               "ranks_agree": same}
        name = as_name or name
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.4e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if not isinstance(v, (dict, list))),
            flush=True)
        self.rows[name] = row
        for kernel, count in r0["launches"].items():
            self.launches.setdefault(kernel, {})[name] = count
        if not (ok and same):
            self.bad.append(name)

    def one_step_short(self, label, solve, x1, iters):
        """The control of MESH_X_REL: ``solve(iters - 1)`` on one card, the
        solve whose x is ``x1`` cut one step short; its x against ``x1``."""
        xc = self.timed(f"{label} one step short", lambda: solve(iters - 1))
        return self.rel(xc, x1)

    def timed(self, label, fn):
        """fn() on one card and its seconds, kept under ``host_s``."""
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.host_s[label] = time.perf_counter() - t0
        return out

    # -- the phase ---------------------------------------------------------
    def run(self):
        import tempfile

        torch = self.torch
        t_start = time.perf_counter()
        print(f"phase 17: the rest of parallel/ on {MESH_RANKS} ranks over "
              f"gloo on one card, and slice_mesh{SLICE} on four:")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp, \
                tempfile.TemporaryDirectory() as stmp:
            self.inputs(tmp)
            procs, t0 = start_ranks(MESH_RANKS, tmp, "--mesh-rank")
            # the slice mesh's ranks start now (their imports and process
            # group beside the two ranks' start) and wait for "go"
            sprocs, st0 = start_ranks(SLICE[0] * SLICE[1], stmp,
                                      "--slice-rank")
            try:
                ranks, xs, secs = wait_ranks(torch, procs, t0, tmp, "mesh")
            except BaseException:
                for p in sprocs:
                    p.kill()
                    p.wait()
                raise
            print(f"  {MESH_RANKS} ranks took {secs:.1f} s", flush=True)
            (pathlib.Path(stmp) / "go").touch()
            t_go = time.perf_counter()
            sranks, sxs, ssecs = wait_ranks(torch, sprocs, st0, stmp,
                                            "slice")
            ssecs = time.perf_counter() - t_go
        print(f"  {SLICE[0] * SLICE[1]} ranks took {ssecs:.1f} s after the "
              "go", flush=True)
        dev = self.x64.device
        xs = {k: v.to(dev) for k, v in xs.items()}
        sxs = {k: v.to(dev) for k, v in sxs.items()}
        self.check_rows_block(ranks, xs)
        self.check_eigen_svd_lsq(ranks, xs)
        self.check_ell(ranks, xs)
        self.check_dense(ranks, xs)
        self.check_cg(ranks, xs, sranks, sxs)
        self.bandwidth()
        out = {"ranks_s": secs, "slice_ranks_s": ssecs,
               "rank_setup_s": [r["setup_s"] for r in ranks],
               "slice_rank_setup_s": [r["setup_s"] for r in sranks],
               "one_card_s": self.host_s, "runs": self.rows,
               "phase_s": time.perf_counter() - t_start}
        print(json.dumps({"phase17": out}))
        print(f"  phase 17: {out['phase_s']:.1f} s")
        if self.bad:
            raise AssertionError(f"phase 17 runs off their limits: "
                                 f"{self.bad}")
        return self.launches

    def inputs(self, tmp):
        """The ELL inputs the ranks load: phase 15's scrambled 1M-row pick
        (auto_format of the permuted banded matrix) and the 100^3
        gradient's ELL with its adjoint, and the gradient's right-hand
        side; the one-card operators kept for the checks."""
        torch, its = self.torch, self.its
        self.csr_scr, self.ell_scr = self.scrambled
        if not isinstance(self.ell_scr, its.ELLMatrix):
            raise AssertionError(f"the scrambled pick is "
                                 f"{type(self.ell_scr).__name__}")
        t0 = time.perf_counter()
        N = MESH_EIG_SIDE**3
        self.G = its.GradientOperator((MESH_EIG_SIDE,) * 3,
                                      device="cuda")
        self.ell_grad = self.G.to_csr().to_ell().with_adjoint()
        g = torch.Generator(device="cuda").manual_seed(1701)
        xt = torch.randn(N, generator=g, device="cuda")
        xt -= xt.mean()
        self.bg = self.G.mv(xt)
        self.host_s["gradient ell with adjoint"] = time.perf_counter() - t0
        arrays = {"bg": self.bg.cpu()}
        for key, E in (("scr", self.ell_scr), ("grad", self.ell_grad),
                       ("gadj", self.ell_grad.adj)):
            arrays.update({f"{key}_data": E.data.cpu(),
                           f"{key}_cols": E.cols.cpu(),
                           f"{key}_shape": torch.tensor(E.shape)})
        torch.save(arrays, f"{tmp}/ell.pt")
        del arrays

    def check_rows_block(self, ranks, xs):
        """a. mv_rows; b. block CG against one card and f64 solves."""
        torch, its, St = self.torch, self.its, self.St
        n = St.n
        for tag in ("stencil", "dia_f32"):
            name = f"mv_rows {tag}"
            err = max(r[name]["max_abs_err"] for r in ranks)
            scale = ranks[0][name]["max_abs_y"]
            want = ({"stencil_apply": ROWS} if tag == "stencil" else {})
            ok = (err <= TOL_Y_F32 * scale
                  and all(r[name]["launches"] == want for r in ranks)
                  and ranks[0][name]["collectives_per_step"]
                  == {"collective-permute": 2})
            self.record(name, ranks, ok, max_abs_err=err,
                        limit=TOL_Y_F32 * scale, expected_launches=want)
        g = torch.Generator(device="cuda").manual_seed(171)
        B = torch.randn(n, BLOCK_K, generator=g, device="cuda")
        B[:, 0] = 1.0
        X1, h1 = self.timed("block_cg", lambda: its.block_cg(
            St, B, reltol=RELTOL, log=True))
        St64 = its.StencilOperator(n, St.center, St.terms, St.coeffs,
                                   dtype=torch.float64, device="cuda")
        x64_1 = its.cg(St64, B[:, 1].double(), reltol=RELTOL)
        X = xs["block_cg"]
        r0 = ranks[0]["block_cg"]
        xerr = [self.rel(X[:, 0], self.x64), self.rel(X[:, 1], x64_1)]
        d1 = self.rel(X, X1)
        want = BLOCK_K * (1 + r0["steps_run"])
        ok = (r0["converged"] and r0["all_columns"]
              and abs(r0["iters"] - h1.iters) <= CG_STEP_SPREAD
              and max(xerr) <= X_F64_REL
              and all(r["block_cg"]["launches"] == {"stencil_apply": want}
                      for r in ranks)
              and bool(torch.isfinite(X).all()))
        self.record("block_cg", ranks, ok, one_card_iters=h1.iters,
                    x_rel_diff_f64_columns_0_1=xerr,
                    x_rel_diff_one_card=d1, expected_launches=want)
        del X, X1, B

    def check_eigen_svd_lsq(self, ranks, xs):
        """c. LOBPCG at 100^3; d. svdl, LSQR and LSMR at 216^3."""
        import numpy as np

        torch, its, St = self.torch, self.its, self.St
        S100 = its.laplacian(MESH_EIG_SIDE, 3, device="cuda")
        X0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (S100.n, ROWS)).astype(np.float32)).to("cuda")
        r1 = self.timed("lobpcg", lambda: its.lobpcg(
            S100, X0, tol=LOBPCG_TOL, maxiter=LOBPCG_MAXITER))
        c = 2 - 2 * np.cos(np.pi * np.arange(1, MESH_EIG_SIDE + 1)
                           / (MESH_EIG_SIDE + 1))
        exact = np.sort((c[:, None, None] + c[None, :, None]
                         + c[None, None, :]).ravel())[:ROWS]
        r0 = ranks[0]["lobpcg"]
        lam = np.asarray(r0["lam"])
        lam1 = r1.lam.double().cpu().numpy()
        d1 = float(np.max(np.abs(lam - lam1) / np.abs(lam1)))
        dex = np.abs(lam - exact) / exact
        want = ROWS * lobpcg_products(r0["iters"])
        ok = (dex[0] <= LAM_REL and d1 <= WITNESS_LAM_REL
              and all(r["lobpcg"]["launches"] == {"stencil_apply": want}
                      for r in ranks) and np.isfinite(lam).all())
        self.record("lobpcg", ranks, ok, one_card_iters=r1.iterations,
                    lam_rel_diff_one_card=d1, lam0_rel_err=float(dex[0]),
                    max_lam_rel_err_16=float(dex.max()),
                    expected_launches=want)
        del X0
        vals1, _, h1 = self.timed("svdl", lambda: its.svdl(
            St, nsv=SVDL_NSV, tol=SVDL_TOL, maxiter=SVDL_MAXITER, log=True,
            key=torch.Generator(device="cuda").manual_seed(0)))
        r0 = ranks[0]["svdl"]
        vals = np.asarray(r0["values"])
        v1 = vals1.double().cpu().numpy()
        sig = 6 * (1 - np.cos(SIDE * np.pi / (SIDE + 1)))
        d1 = float(np.max(np.abs(vals - v1)) / v1[0])
        want = 2 * svdl_products(r0["iters"], 2 * SVDL_NSV, SVDL_NSV)
        ok = (abs(vals[0] - sig) <= SIGMA_REL * sig
              and d1 <= WITNESS_SIGMA_REL
              and all(r["svdl"]["launches"] == {"stencil_apply": want}
                      for r in ranks))
        self.record("svdl", ranks, ok, one_card_iters=h1.iters,
                    values_rel_diff_one_card=d1,
                    sigma_max_rel_err=abs(vals[0] - sig) / sig,
                    expected_launches=want)
        n = St.n
        Sh = its.StencilOperator(n, 7.0, St.terms, St.coeffs,
                                 device="cuda")
        Sh64 = its.StencilOperator(n, 7.0, St.terms, St.coeffs,
                                   dtype=torch.float64, device="cuda")
        b = torch.ones(n, device="cuda")
        for solver in ("lsqr", "lsmr"):
            x1, h1 = self.timed(solver, lambda: getattr(its, solver)(
                Sh, b, atol=LSQ_TOL, btol=LSQ_TOL, maxiter=LSQ_MAXITER,
                log=True))
            ctl = self.one_step_short(solver, lambda m: getattr(its, solver)(
                Sh, b, atol=LSQ_TOL, btol=LSQ_TOL, maxiter=m), x1, h1.iters)
            r0, x = ranks[0][solver], xs[solver]
            res, res1 = (self.true_res(Sh64.mv, v, b) for v in (x, x1))
            d1 = self.rel(x, x1)
            want = 2 * (1 + r0["steps_run"])
            ok = (r0["istop"] in (1, 2)
                  and abs(r0["iters"] - h1.iters) <= CG_STEP_SPREAD
                  and res <= LSQ_RES_FACTOR * res1 and d1 <= MESH_X_REL
                  and ctl > MESH_X_REL
                  and all(r[solver]["launches"] == {"stencil_apply": want}
                          for r in ranks))
            self.record(solver, ranks, ok, one_card_iters=h1.iters,
                        true_residual=res, one_card_true_residual=res1,
                        x_rel_diff_one_card=d1, control_x_rel_diff=ctl,
                        expected_launches=want)

    def check_ell(self, ranks, xs):
        """e. CG on the scrambled ELL pick; LSQR on the gradient's ELL."""
        torch, its = self.torch, self.its
        b = torch.ones(self.ell_scr.shape[0], device="cuda")
        x1, h1 = self.timed("cg ell scrambled", lambda: its.cg(
            self.ell_scr, b, reltol=FS_RELTOL, maxiter=FS_MAXITER, log=True))
        name = "cg ell scrambled"
        # recorded, not held (MESH_X_REL)
        ctl = self.one_step_short(name, lambda m: its.cg(
            self.ell_scr, b, reltol=FS_RELTOL, maxiter=m), x1, h1.iters)
        r0, x = ranks[0][name], xs[name]
        res = self.true_res(lambda v: self.csr_scr.mv(v.float()).double(),
                            x, b)
        coll = r0["collectives_per_step"]
        ok = (r0["converged"] and res <= FS_TRUE_RES
              and abs(r0["iters"] - h1.iters) <= CG_STEP_SPREAD
              and self.rel(x, x1) <= MESH_X_REL
              and coll.get("all-gather") == 1
              and not coll.get("collective-permute")
              and all(not r[name]["launches"] for r in ranks))
        self.record(name, ranks, ok, one_card_iters=h1.iters,
                    true_residual=res, x_rel_diff_one_card=self.rel(x, x1),
                    control_x_rel_diff=ctl)
        G64 = its.GradientOperator((MESH_EIG_SIDE,) * 3, dtype=torch.float64,
                                   device="cuda")
        bg64 = self.bg.double()

        def grad_res(v):
            # the damped normal equations' residual, relative to |G^T b|
            v = v.double()
            r = G64.rmv(bg64 - G64.mv(v)) - v
            return float(torch.linalg.vector_norm(r)
                         / torch.linalg.vector_norm(G64.rmv(bg64)))

        x1, h1 = self.timed("lsqr gradient", lambda: its.lsqr(
            self.G, self.bg, damp=1.0, maxiter=GRAD_LSQ_MAXITER, log=True))
        res1 = grad_res(x1)
        ctl = self.one_step_short("lsqr gradient", lambda m: its.lsqr(
            self.G, self.bg, damp=1.0, maxiter=m), x1, h1.iters)
        for tag, kind in (("adjoint", "all-gather"),
                          ("reduce-scatter", "reduce-scatter")):
            name = f"lsqr gradient ell {tag}"
            r0, x = ranks[0][name], xs[name]
            res, d1 = grad_res(x), self.rel(x, x1)
            coll = r0["collectives_per_step"]
            ok = (r0["converged"] or r0["istop"] == 7) \
                and abs(r0["iters"] - h1.iters) <= CG_STEP_SPREAD \
                and res <= LSQ_RES_FACTOR * res1 + 1e-12 \
                and d1 <= MESH_X_REL < ctl \
                and all(not r[name]["launches"] for r in ranks) \
                and (tag == "adjoint" or coll.get("reduce-scatter", 0) >= 1)
            self.record(name, ranks, ok, one_card_iters=h1.iters,
                        damped_normal_residual=res,
                        one_card_damped_normal_residual=res1,
                        x_rel_diff_one_card=d1, control_x_rel_diff=ctl)
        del self.ell_grad, self.G, self.bg

    def check_dense(self, ranks, xs):
        """f. GMRES on the dense operator: the CGS2 kernels' launches, the
        witness, one card's MGS solve and the true residual."""
        torch, its = self.torch, self.its
        M = dense_matrix(torch, "cuda")
        b = torch.ones(MESH_DENSE_N, device="cuda")
        x1, h1 = self.timed("gmres dense", lambda: its.gmres(
            M, b, log=True, **MESH_GMRES))
        r0, rw = ranks[0]["gmres dense"], ranks[0]["gmres dense witness"]
        x, xw = xs["gmres dense"], xs["gmres dense witness"]
        steps = MESH_GMRES["restart"] * (r0["restarts"] + 1)
        want = {"panel_dots": 2 * steps, "panel_update": 2 * steps}
        res = self.true_res(lambda v: M.double() @ v, x, b)
        dw, d1 = self.rel(x, xw), self.rel(x, x1)
        ok = (r0["converged"] and rw["converged"]
              and abs(r0["iters"] - rw["iters"]) <= 1 and dw <= CONV_X_REL
              and d1 <= DIST_CONV_X_REL["f32"]
              and all(r["gmres dense"]["launches"] == want
                      and not r["gmres dense witness"]["launches"]
                      for r in ranks))
        self.record("gmres dense", ranks, ok, n=MESH_DENSE_N,
                    true_residual=res, witness_iters=rw["iters"],
                    x_rel_diff_witness=dw, one_card_iters=h1.iters,
                    x_rel_diff_one_card=d1, expected_launches=want)
        del M

    def check_cg(self, ranks, xs, sranks, sxs):
        """g. CG on the slice mesh against the two-rank and one-card CG;
        h. shard_dia / shard_ell against their counterparts."""
        b = self.torch.ones(self.St.n, device="cuda")
        x1, h1 = self.cg1

        def held(name, rks, x, extra=None, as_name=None, **row):
            r0 = rks[0][name]
            res = self.true_res(self.A64.mv, x, b)
            d64 = self.rel(x, self.x64)
            ok = (r0["converged"]
                  and res <= min(TRUE_RES_F32, PLAIN_RES_FACTOR * self.res_pl)
                  and d64 <= X_F64_REL
                  and abs(r0["iters"] - h1.iters) <= CG_STEP_SPREAD
                  and (extra is None or extra(r0)))
            self.record(name, rks, ok, as_name, true_residual=res,
                        x_rel_diff_f64=d64, one_card_iters=h1.iters, **row)
            return r0

        two = held("cg stencil", ranks, xs["cg stencil"],
                   lambda r: r["launches"] == {"stencil_apply":
                                               r["steps_run"]})
        def slice_held(r):
            # every sum ran at both levels: one all-reduce of each a sum
            lv = r["level_all_reduces"]
            return (lv["chip"] == lv["slice"] > 0
                    and lv["chip"] + lv["slice"] == r["collectives"][
                        "all-reduce"]
                    and abs(r["iters"] - two["iters"]) <= CG_STEP_SPREAD
                    and r["launches"] == {"stencil_apply": r["steps_run"]})

        held("cg stencil", sranks, sxs["cg stencil"], slice_held,
             as_name=f"cg stencil slice_mesh{SLICE}",
             two_rank_iters=two["iters"])
        held("cg shard_dia", ranks, xs["cg shard_dia"])
        # shard_ell's twin: the same ELL matrix's CG on one card
        E1 = dia_as_ell(self.its, self.A)
        xe, he = self.timed("cg ell 216^3", lambda: self.its.cg(
            E1, b, reltol=RELTOL, log=True, chunk=CHUNK,
            maxiter=KRYLOV_MAXITER))
        del E1
        held("cg shard_ell", ranks, xs["cg shard_ell"],
             lambda r: abs(r["iters"] - he.iters) <= CG_STEP_SPREAD
             and self.rel(xs["cg shard_ell"], xe) <= 2 * X_F64_REL,
             one_card_ell_iters=he.iters,
             x_rel_diff_one_card_ell=self.rel(xs["cg shard_ell"], xe))

    def bandwidth(self):
        """j. measure_bandwidth on the card beside the data sheet's."""
        from iterativesolvers_tpu_torch.utils.profiling import (
            measure_bandwidth)

        bw = measure_bandwidth(1 << 26, reps=3, device="cuda")
        self.rows["measure_bandwidth"] = {
            "bytes_per_s": bw, "data_sheet_bytes_per_s": H100_SXM[1],
            "share": bw / H100_SXM[1], "n": 1 << 26}
        print(f"  measure_bandwidth (triad, 2^26 f32): {bw / 1e12:.3f} TB/s "
              f"against the data sheet's {H100_SXM[1] / 1e12:.2f}")


def panel_ortho_entries(ptimes, perr, r0):
    """The kernels-line entries of the two sweeps: f32 panel (the main
    path's), the bf16 panel beside it."""
    no_library = ("no single PyTorch call computes a bf16 panel's product "
                  "with an f32 w (torch rounds the mixed product to bf16)")
    out = []
    for name, line in (("panel_dots", 197), ("panel_update", 227)):
        t = ptimes[name, "f32"]
        out.append({
            "name": f"{name}[f32 panel]", "route": "cuda",
            "source": "iterativesolvers_tpu_torch/csrc/panel_ortho.cu",
            "replaces": f"iterativesolvers_tpu/parallel/panel_ortho.py:{line}",
            "launches": r0["gmres_500"]["launches"][name],
            "max_abs_err": perr[f"{name} f32"], **t,
            "bf16_panel": dict(ptimes[name, "bf16"],
                               max_abs_err=perr[f"{name} bf16"],
                               library_note=no_library)})
    return out

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dist-rank", type=int, default=None,
                    help="run one rank of phase 12 (the script starts them)")
    ap.add_argument("--precond-rank", type=int, default=None,
                    help="run one rank of phase 16 (the script starts them)")
    ap.add_argument("--precond-one-card", action="store_true",
                    help="run phase 16's one-card reference (the script "
                         "starts it)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help="run one rank of phase 17 (the script starts them)")
    ap.add_argument("--slice-rank", type=int, default=None,
                    help="run one rank of phase 17's slice mesh (the script "
                         "starts them)")
    ap.add_argument("--world", type=int, default=DIST_RANKS)
    ap.add_argument("--rendezvous")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.dist_rank is not None:
        return dist_rank(args)
    if args.precond_rank is not None:
        return precond_rank(args)
    if args.precond_one_card:
        return precond_one_card(args)
    if args.mesh_rank is not None or args.slice_rank is not None:
        return mesh_rank(args)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
                 "drives the port on a GPU and has nothing to run here")

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch import native
    from iterativesolvers_tpu_torch.ops import (_build, cuda_arnoldi, cuda_mgs,
                                               cuda_panel_ortho, cuda_stencil)
    from iterativesolvers_tpu_torch.ops.cuda_spmv import (
        dia_spmv, dia_spmv_dot, dia_spmv_plain)
    from iterativesolvers_tpu_torch.ops.cuda_stencil import (
        stencil_apply, stencil_apply_plain)
    from iterativesolvers_tpu_torch.solvers import gmres as gmres_mod
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps
    from iterativesolvers_tpu_torch.utils.fixtures import laplace_dia

    def clock(label):
        """The script's seconds so far, before ``label``."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {label}", flush=True)

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
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError(f"the native host library did not build or load: "
                           f"{native.build_error()}")
    print(f"native host library (g++): {time.perf_counter() - t0:.1f} s, "
          f"{native.library_path()}")
    ptxas = sweep_resources(_build)
    spmv_resources(_build)

    # ---- 3. kernel parity at 216^3 ----------------------------------------
    clock("phase 3")
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
            e_mv = check(f"{tag} mv", St.mv(x), stencil_apply_plain(*args, x),
                         tol)
            check(f"{tag} rmv", St.rmv(x),
                  stencil_apply_plain(*args, x, conj=True), tol)
            y, d = St.mv_dot(x)
            yp, dp = stencil_apply_plain(*args, x, with_dot=True)
            e = check(f"{tag} mv_dot y", y, yp, tol)
            check(f"{tag} mv_dot dot", d, dp, TOL_DOT, kind="dot")
            if label == "laplacian" and dt == torch.float32:
                err["stencil"], err["stencil[no dot]"] = e, e_mv
    A = laplace_dia(SIDE, 3, dtype="float32")
    dias = {"f32": A, "bf16": its.compress_values(A, torch.bfloat16),
            "int8": its.compress_values(A, torch.int8)}
    for label, Ad in dias.items():
        if label != "f32" and Ad.dtype == torch.float32:
            raise AssertionError(f"compress_values kept f32 for {label}")
        err[f"dia_spmv {label}"] = check(
            f"dia_spmv {label}", dia_spmv(Ad.diags, Ad.offsets, x32),
            dia_spmv_plain(Ad.diags, Ad.offsets, x32), TOL_Y_F32)
        y, d = dia_spmv_dot(Ad.diags, Ad.offsets, x32, x32)
        yp, dp = dia_spmv_plain(Ad.diags, Ad.offsets, x32, x32)
        err[label] = check(f"dia_spmv_dot {label} y", y, yp, TOL_Y_F32)
        check(f"dia_spmv_dot {label} dot", d, dp, TOL_DOT, kind="dot")
    # the stored and the matrix-free Laplacian: the same sum order, the same
    # bits; and each kernel's dot the same bits on every run
    St = its.laplacian(SIDE, 3)
    y_st = St.mv(x32)
    same = {f"dia_spmv {label}": (lambda Ad=Ad: Ad.mv(x32))
            for label, Ad in dias.items()}
    same.update({f"dia_spmv_dot {label} y": (lambda Ad=Ad: Ad.mv_dot(x32)[0])
                 for label, Ad in dias.items()})
    for name, fn in same.items():
        ok = torch.equal(fn(), y_st)
        print(f"  {name} against stencil_apply f32: "
              f"{'the same bits' if ok else 'DIFFERENT bits'}")
        if not ok:
            raise AssertionError(f"{name} differs from stencil_apply's y")
    twice = {f"dia_spmv_dot {label}": (lambda Ad=Ad: Ad.mv_dot(x32))
             for label, Ad in dias.items()}
    twice.update({f"stencil_apply {str(dt)[6:]} (dot)": (
        lambda dt=dt: St.mv_dot(x32.to(dt)))
        for dt in (torch.float32, torch.bfloat16)})
    for name, fn in twice.items():
        (ya, da), (yb, db) = fn(), fn()
        ok = torch.equal(ya, yb) and torch.equal(da, db)
        print(f"  {name}, two runs on the same inputs: "
              f"{'the same bits' if ok else 'DIFFERENT bits'}")
        if not ok:
            raise AssertionError(f"{name}: not reproducible")
    torch.cuda.synchronize()

    # ---- 4. the main path: CG at 216^3 on the four operator paths ---------
    clock("phase 4")
    St = its.laplacian(SIDE, 3)
    paths = {"stencil": St, "dia_f32": dias["f32"], "dia_bf16": dias["bf16"],
             "dia_int8": dias["int8"]}
    counters = (stencil_apply, dia_spmv, dia_spmv_dot)
    b = torch.ones(n, device="cuda")
    A64 = A.astype(torch.float64)

    def true_res(x, rhs=None):
        b64 = (b if rhs is None else rhs).double()
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
        if abs(h.iters - h_st.iters) > CG_STEP_SPREAD or not diff <= 1e-4:
            raise AssertionError(f"{name} disagrees with the stencil path")
    # the spread of sound dot orders, and the control the limits reject
    grid = cuda_stencil._launch(St.n, St.center, St.terms, St.coeffs, False,
                                torch.float32, True, x32.device,
                                cuda_stencil.raw_stream(x32.device)).grid
    spread = check_spread(dot_order_spread(torch, its, St, A64, grid))

    # ---- 5. timing --------------------------------------------------------
    clock("phase 5")
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
        t_long = timed(f"cg {name} maxiter=504", lambda: solve(op, 504), 1,
                       3)
        t_short = timed(f"cg {name} maxiter=248", lambda: solve(op, 248), 1,
                        3)
        per_iter[name] = (t_long - t_short) / (504 - 248) * 1e3
    print(json.dumps({
        "cg_us_per_iter": per_iter, "timed_iters": 504 - 248,
        "cg_to_reltol": {k: {"iters": h.iters, "s": secs[k]}
                         for k, (_, h, _) in runs.items()},
        "dot_order_spread": spread,
        "n": n, "device": kind}))

    # ---- 6. trace: where the time of a CG step goes ------------------------
    clock("phase 6")
    # one profiled CG_TRACE-step solve per path; the device's busy time is
    # the sum of its kernels' times, a step against the untimed 504-step
    # solve's median above
    trace = {}
    for name, op in paths.items():
        def traced(op=op):
            t0 = time.perf_counter()
            solve(op, CG_TRACE)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        traced_ms, by_kernel = profiled(torch, traced, name)
        busy = sum(by_kernel.values())
        wall = statistics.median(samples[f"cg {name} maxiter=504"])
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        trace[name] = {"steps": CG_TRACE, "wall_ms_504": wall,
                       "traced_wall_ms": traced_ms, "device_busy_ms": busy,
                       "busy_share": busy / CG_TRACE * 504 / wall,
                       "top_device_ms": dict(top)}
    print(json.dumps({"trace": trace}))

    # ---- 7-10. GMRES -------------------------------------------------------
    clock("phase 7")
    panels, w_gm, gerr, gres = gmres_parity(torch, its, cuda_mgs, cuda_arnoldi,
                                            n)
    gcounters = counters + (cuda_mgs.panel_mgs, cuda_arnoldi.stencil_panel_mv,
                            cuda_arnoldi.fused_arnoldi)
    clock("phase 8")
    gruns, gout, gsolve, groutes = gmres_main_path(
        torch, its, gmres_mod, gcounters, paths, b, true_res, rel_diff, timed)
    clock("phase 9")
    conv, conv_x = gmres_converging(torch, its, gmres_mod, St, b)
    clock("phase 10")
    ab = gmres_fused_ab(torch, gmres_mod, gcounters, St, gsolve, timed)
    clock("phase 10 trace")
    gtrace = gmres_trace(torch, gsolve,
                         {k: groutes[k] for k in ("stencil_bf16",
                                                  "stencil_f32", "dia_f32")},
                         samples)

    # ---- 11. every kernel beside its bound ----------------------------------
    clock("phase 11")
    csr = laplace_csr(torch, A)
    library_ms = timed("torch.sparse CSR @ x", lambda: csr @ x32)
    nnz_off = sum(n - abs(o) for o in A.offsets if o != 0)

    def dev_timed(label, fn):
        """ms, device_ms and host_us of one call (``kernel_timing``); the
        batch means go to the timing samples."""
        t = kernel_timing(torch, fn)
        samples[label] = t.pop("samples")
        return t

    # the main path's counts: CG's stencil_apply with the dot; GMRES's
    # stencil routes apply the stencil without it once a cycle
    no_dot = sum(gruns[r][2]["stencil_apply"]
                 for r in ("stencil_bf16", "stencil_f32"))
    nnz_ops = 2 * (n + nnz_off)
    kernels = []
    for name, fn, plain, extra_ops, launches, e in (
            ("stencil_apply", lambda: St.mv_dot(x32),
             lambda: stencil_apply_plain(St.n, St.center, St.terms, St.coeffs,
                                         x32, with_dot=True),
             2 * n, runs["stencil"][2], err["stencil"]),
            ("stencil_apply[no dot]", lambda: St.mv(x32),
             lambda: stencil_apply_plain(St.n, St.center, St.terms, St.coeffs,
                                         x32), 0, no_dot,
             err["stencil[no dot]"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "iterativesolvers_tpu_torch/csrc/stencil.cu",
            "replaces": "iterativesolvers_tpu/ops/pallas_stencil.py:230",
            "launches": launches,
            "max_abs_err": e,
            **dev_timed(name, fn),
            "plain_ms": timed(f"{name} plain", plain, reps=5),
            # read x, write y; one FMA per product (center included), the
            # dot's
            "bytes": 8 * n,
            "flops": nnz_ops + extra_ops,
            "library_ms": library_ms,
        })
    for label in ("f32", "bf16", "int8"):
        Ad = dias[label]
        diag_bytes = sum(d.numel() * d.element_size() for d in Ad.diags)
        kernels.append({
            "name": f"dia_spmv_dot[{label} diagonals]",
            "route": "cuda",
            "source": "iterativesolvers_tpu_torch/csrc/dia_spmv.cu",
            "replaces": "iterativesolvers_tpu/ops/pallas_spmv.py:149",
            "launches": runs[f"dia_{label}"][2],
            "max_abs_err": err[label],
            **dev_timed(f"dia_spmv_dot {label}", lambda: Ad.mv_dot(x32)),
            "plain_ms": timed(f"dia_spmv_dot {label} plain",
                              lambda: dia_spmv_plain(Ad.diags, Ad.offsets,
                                                     x32, x32), reps=5),
            # every diagonal, x (= u) once, y once; one FMA per in-range
            # product and the dot's FMA
            "bytes": diag_bytes + 8 * n,
            "flops": nnz_ops + 2 * n,
            "library_ms": library_ms,
        })
        # the same kernel without the dot: GMRES's step on a stored matrix
        kernels.append({
            "name": f"dia_spmv[{label} diagonals]",
            "route": "cuda",
            "source": "iterativesolvers_tpu_torch/csrc/dia_spmv.cu",
            "replaces": "iterativesolvers_tpu/ops/pallas_spmv.py:142",
            "launches": gruns[f"dia_{label}"][2]["dia_spmv"],
            "max_abs_err": err[f"dia_spmv {label}"],
            **dev_timed(f"dia_spmv {label}", lambda: Ad.mv(x32)),
            "plain_ms": timed(f"dia_spmv {label} plain",
                              lambda: dia_spmv_plain(Ad.diags, Ad.offsets,
                                                     x32), reps=5),
            "bytes": diag_bytes + 8 * n,
            "flops": nnz_ops,
            "library_ms": library_ms,
        })

    def bound(nbytes, nflops):
        byte_ms, op_ms = nbytes / bw * 1e3, nflops / flops * 1e3
        return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms
                                     else "operations")

    # bytes and operations of one call at step k, panel element size es:
    # panel MGS reads w and rows 0..k and writes row k+1, 4 operations an
    # entry a row and 3 for the norm; the fused step reads rows 0..k (row k
    # among them) and writes row k+1, plus the stencil's FMAs; the panel
    # SpMV reads one row and writes f32 w
    shape = {"panel_mgs": lambda es, k: ((4 + (k + 2) * es) * n,
                                         (4 * (k + 1) + 3) * n),
             "fused_arnoldi": lambda es, k: ((k + 2) * es * n,
                                             nnz_ops + (4 * (k + 1) + 3) * n),
             "stencil_panel_mv": lambda es, k: ((es + 4) * n, nnz_ops)}
    sargs = (St.n, St.center, St.terms, St.coeffs)
    one = torch.ones((), dtype=torch.int32, device="cuda")
    k19, k9, k5, k0 = (torch.tensor(k, dtype=torch.int32, device="cuda")
                       for k in (19, 9, 5, 0))
    gtimes = {}
    for label, V in panels.items():
        Vs = V.clone()
        calls = {
            "panel_mgs": (lambda k: cuda_mgs.panel_mgs(Vs, w_gm, k, one),
                          lambda: cuda_mgs.panel_mgs_plain(Vs, w_gm, k19,
                                                           one)),
            "fused_arnoldi": (
                lambda k: cuda_arnoldi.fused_arnoldi(*sargs, Vs, k, one),
                lambda: cuda_arnoldi.fused_arnoldi_plain(*sargs, Vs, k19,
                                                         one)),
            "stencil_panel_mv": (
                lambda k: cuda_arnoldi.stencil_panel_mv(*sargs, Vs, k5),
                lambda: cuda_arnoldi.stencil_panel_mv_plain(*sargs, Vs, k5))}
        es = V.element_size()
        for name, (kernel, plain) in calls.items():
            b_ms, b_by = bound(*shape[name](es, 19))
            gtimes[name, label] = {
                **({"ms": timed(f"{name} {label} k=19", lambda: kernel(k19))}
                   if name != "stencil_panel_mv" else
                   dev_timed(f"{name} {label} k=19", lambda: kernel(k19))),
                "ms_k9": timed(f"{name} {label} k=9", lambda: kernel(k9)),
                "plain_ms": timed(f"{name} {label} plain", plain, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_k9": bound(*shape[name](es, 9))[0]}
            if name != "stencil_panel_mv":
                # a sweep's fixed cost (its k + 2 = 2 grid syncs) at k = 0;
                # its residency on the chip
                plan = gres[label]
                gtimes[name, label].update(
                    ms_k0=timed(f"{name} {label} k=0", lambda: kernel(k0)),
                    bound_ms_k0=bound(*shape[name](es, 0))[0],
                    regs_per_thread=ptxas[name, label]["registers"],
                    spill_bytes=ptxas[name, label]["spill_stores"],
                    smem_bytes=plan.smem_bytes,
                    onchip_share=plan.onchip_share)
        del Vs
    for (name, label), t in gtimes.items():
        if name != "stencil_panel_mv":
            print(f"  {name} {label} panel: {t['ms']:.4f} ms at k=19, "
                  f"{t['ms'] / t['bound_ms']:.2f}x its bound; "
                  f"k=9 {t['ms_k9']:.4f} ({t['ms_k9'] / t['bound_ms_k9']:.2f}x),"
                  f" k=0 {t['ms_k0']:.4f} ({t['ms_k0'] / t['bound_ms_k0']:.2f}x)")
    # each GMRES kernel at the panel dtype of its main-path routes; the
    # other dtype beside it
    main_dtype = {"panel_mgs": "bf16", "fused_arnoldi": "f32",
                  "stencil_panel_mv": "bf16"}
    sources = {"panel_mgs": ("csrc/panel_mgs.cu", "ops/pallas_mgs.py:294"),
               "fused_arnoldi": ("csrc/arnoldi.cu", "ops/pallas_arnoldi.py:385"),
               "stencil_panel_mv": ("csrc/arnoldi.cu",
                                    "ops/pallas_arnoldi.py:560")}
    no_library = ("no single PyTorch call computes modified Gram-Schmidt: "
                  "each h_j depends on the w left by row j-1")
    for name, dt in main_dtype.items():
        other = "f32" if dt == "bf16" else "bf16"
        t = gtimes[name, dt]
        kernels.append({
            "name": f"{name}[{dt} panel]",
            "route": "cuda",
            "source": "iterativesolvers_tpu_torch/" + sources[name][0],
            "replaces": "iterativesolvers_tpu/" + sources[name][1],
            "launches": sum(r[2][name] for r in gruns.values()),
            "max_abs_err": gerr[f"{name} {dt}"],
            **t,
            "library_ms": library_ms if name == "stencil_panel_mv" else None,
            **({} if name == "stencil_panel_mv"
               else {"library_note": no_library}),
            f"{other}_panel": dict(gtimes[name, other],
                                   max_abs_err=gerr[f"{name} {other}"]),
        })
    # ---- 12. distributed GMRES and CG on DIST_RANKS ranks ------------------
    clock("phase 12")
    blocks, w_sh, perr = panel_ortho_parity(torch, cuda_panel_ortho, panels,
                                            n, DIST_RANKS)
    ptimes = panel_ortho_timing(torch, cuda_panel_ortho, blocks, w_sh, timed,
                                bound)
    del blocks, w_sh
    torch.cuda.empty_cache()
    dout, r0 = check_ranks(
        torch, its, *run_ranks(torch), true_res, rel_diff,
        {"converging": conv_x,
         "cg": (runs["stencil"][0], runs["stencil"][1], res_pl, x64)})
    kernels += panel_ortho_entries(ptimes, perr, r0)

    # ---- 13. the Krylov solvers at 216^3 -------------------------------------
    clock("phase 13")
    t0 = time.perf_counter()
    krylov = krylov_phase(torch, its, St, dias["int8"], x64, counters)
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        # phase 13's launches of the stencil kernel (no dot) and of the int8
        # DIA kernel, by run, beside the earlier phases' count
        if k["name"] in ("stencil_apply[no dot]", "dia_spmv[int8 diagonals]"):
            dia = k["name"].startswith("dia")
            k["krylov_launches"] = {name: r["launches"]
                                    for name, r in krylov.items()
                                    if ("DIA" in name) == dia}

    # ---- 14. mv_rows, block CG, LOBPCG, svdl, LSQR and LSMR ----------------
    clock("phase 14")
    t0 = time.perf_counter()
    _, rows_ab, p14 = block_phase(torch, its, St, A64, x64, counters, bound)
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    # phase 14's launches by run and the mv_rows A/B, joined to the kernels
    # entries by exact key; an entry or a key without its partner raises
    p14_keys = {"stencil_apply[no dot]": "stencil_apply",
                "dia_spmv[f32 diagonals]": "dia_spmv[f32]",
                "dia_spmv[int8 diagonals]": "dia_spmv[int8]"}
    names = {k["name"] for k in kernels}
    if (not set(p14_keys) <= names
            or set(p14) != set(p14_keys.values())
            or set(rows_ab) != set(p14_keys.values())):
        raise AssertionError(
            f"phase 14's records {sorted(p14)} / {sorted(rows_ab)} do not "
            f"match the kernels entries {p14_keys}")
    for k in kernels:
        if k["name"] in p14_keys:
            key = p14_keys[k["name"]]
            k["phase14_launches"] = p14[key]
            k["mv_rows"] = rows_ab[key]

    # ---- 15. the stored formats, auto_format, MatrixMarket I/O -----------
    clock("phase 15")
    t0 = time.perf_counter()
    _, p15_products, p15, scrambled = formats_phase(
        torch, its, A, runs, x64,
        gcounters + (cuda_panel_ortho.panel_dots,
                     cuda_panel_ortho.panel_update), bound)
    # phase 15's launches by run, joined to the kernels entries by kernel
    # (GMRES on the HYB matrix orthogonalizes an f32 panel: panel_mgs's f32
    # row, beside the entry's bf16 one)
    p15_keys = {"dia_spmv_dot[f32 diagonals]": "dia_spmv_dot",
                "panel_mgs[bf16 panel]": "panel_mgs"}
    if not set(p15) <= set(p15_keys.values()):
        raise AssertionError(f"phase 15 launched {sorted(p15)}, expected "
                             f"only {sorted(p15_keys.values())}")
    for k in kernels:
        if k["name"] in p15_keys:
            k["phase15_launches"] = p15.get(p15_keys[k["name"]], {})

    # ---- 16. preconditioners, the reduced system, the stationary methods --
    clock("phase 16")
    p16 = PrecondPhase(torch, its, dias["int8"],
                       gcounters + (cuda_panel_ortho.panel_dots,
                                    cuda_panel_ortho.panel_update),
                       bound).run().launches
    # phase 16's launches by run, joined to the kernels entries by kernel
    # and diagonal dtype (its GMRES runs orthogonalize f32 panels: the
    # panel_mgs entry's f32 row)
    p16_keys = {"dia_spmv_dot[f32 diagonals]": "dia_spmv_dot[f32]",
                "dia_spmv_dot[int8 diagonals]": "dia_spmv_dot[int8]",
                "dia_spmv[f32 diagonals]": "dia_spmv[f32]",
                "dia_spmv[int8 diagonals]": "dia_spmv[int8]",
                "panel_mgs[bf16 panel]": "panel_mgs"}
    if not set(p16) <= set(p16_keys.values()):
        raise AssertionError(f"phase 16 launched {sorted(p16)}, expected "
                             f"only {sorted(p16_keys.values())}")
    for k in kernels:
        if k["name"] in p16_keys:
            k["phase16_launches"] = p16.get(p16_keys[k["name"]], {})

    # ---- 17. the rest of parallel/ on ranks -------------------------------
    clock("phase 17")
    p17 = MeshPhase(torch, its, St, A, x64, runs["stencil"][:2], res_pl,
                    scrambled).run()
    # phase 17's launches by run (rank 0's; every rank's are held), joined
    # to the kernels entries by kernel: the stencil kernel (with and without
    # its dot: one counter) and the two CGS2 sweeps
    p17_keys = {"stencil_apply": "stencil_apply",
                "panel_dots[f32 panel]": "panel_dots",
                "panel_update[f32 panel]": "panel_update"}
    if not set(p17) <= set(p17_keys.values()) or not {
            "stencil_apply", "panel_dots", "panel_update"} <= set(p17):
        raise AssertionError(f"phase 17 launched {sorted(p17)}, expected "
                             f"{sorted(p17_keys.values())}")
    for k in kernels:
        if k["name"] in p17_keys:
            k["phase17_launches"] = p17[p17_keys[k["name"]]]

    for k in kernels:
        if "bytes" in k:
            k["bound_ms"], k["bound_by"] = bound(k.pop("bytes"),
                                                 k.pop("flops"))
    print(json.dumps({"timing_samples_ms": samples}))
    print(json.dumps({"gmres": {**gout, "converging": conv,
                                "fused_vs_two_kernels_us_per_iter": ab,
                                "trace": gtrace}}))
    print(json.dumps({"distributed": dout}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
