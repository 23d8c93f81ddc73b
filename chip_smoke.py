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

It prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
It imports no JAX and nothing of the JAX package.
"""

import argparse
import contextlib
import json
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


def device_ms(torch, prof, name):
    """Device time (ms) by kernel name (cut to 60 characters) in a
    ``torch.profiler`` trace; raises if the trace holds none."""
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name[:60]
            by_kernel[key] = (by_kernel.get(key, 0.0)
                              + e.time_range.elapsed_us() / 1e3)
    if not by_kernel:
        raise AssertionError(f"the trace of {name} holds no device time")
    return by_kernel


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


# ---- GMRES (phases 7-11) ---------------------------------------------------
GM_RESTART = 20
GM_LONG, GM_SHORT = 500, 240      # bench.py's differential: 25 and 12 cycles
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
    # 5 solves of each length, and the mean step of the 500-step solve
    # beside the differential
    per_iter, per_step = {}, {}
    for name, (op, panel) in routes.items():
        t_long = timed(f"gmres {name} maxiter={GM_LONG}",
                       lambda: solve(op, GM_LONG, panel), 1, 5)
        t_short = timed(f"gmres {name} maxiter={GM_SHORT}",
                        lambda: solve(op, GM_SHORT, panel), 1, 5)
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
                           lambda: solve(St, GM_LONG, panel), 1, 3)
            t_short = timed(f"ab {name} {GM_SHORT}",
                            lambda: solve(St, GM_SHORT, panel), 1, 3)
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
    """Where the time of a GMRES step goes: one profiled 240-step solve per
    route, device busy time against the untraced solve's median; and the
    torch ops a step dispatches (two cycles less one, over a cycle's steps:
    a cycle boundary's share included)."""
    from torch.profiler import ProfilerActivity, profile

    trace = {}
    for name, (op, panel) in routes.items():
        ops = [dispatch_count(torch, lambda c=c: solve(op, c * GM_RESTART,
                                                       panel))
               for c in (1, 2)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(op, GM_SHORT, panel)
            torch.cuda.synchronize()
        by_kernel = device_ms(torch, prof, name)
        busy = sum(by_kernel.values())
        wall = statistics.median(samples[f"gmres {name} maxiter={GM_SHORT}"])
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        trace[name] = {"steps": GM_SHORT, "wall_ms": wall,
                       "device_busy_ms": busy, "busy_share": busy / wall,
                       "device_us_per_step": busy / GM_SHORT * 1e3,
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
DIST_REPS = 3                     # timed solves of each length
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
    from torch.profiler import ProfilerActivity, profile

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
    # one traced 240-step solve (rank 0 traces; rank 1 runs it alongside)
    sync()
    if mesh.rank == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bench(GM_SHORT)
            torch.cuda.synchronize()
        by_kernel = device_ms(torch, prof, "distributed gmres")
        busy = sum(by_kernel.values())
        sweeps = {name: sum(v for k, v in by_kernel.items() if name in k)
                  for name in ("panel_dots_kernel", "reduce_rows",
                               "panel_update_kernel", "stencil_kernel")}
        res["trace"] = {
            "steps": GM_SHORT, "wall_ms": t_short * 1e3,
            "rank0_device_busy_ms": busy, "rank0_busy_share": busy
            / (t_short * 1e3),
            "us_per_step": {k: v / GM_SHORT * 1e3 for k, v in sweeps.items()},
            "top_device_ms": dict(sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:8])}
    else:
        bench(GM_SHORT)
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
    """Phase 13's runs: name -> (solve(op) -> (x, h), operator, b, the f64
    operator of the true residual, kernel, launches(steps run), kind:
    "laplacian" (held, against x64), "shifted" (held), "recorded" or
    "powm").  One kernel launch a product, masked steps included."""
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

    def powm(op):
        lam, x, h = its.powm(op, x0=x0, tol=0.0, maxiter=POWM_STEPS - 1,
                             log=True)
        h.lam = float(lam)
        return x, h

    conv = dict(reltol=RELTOL, maxiter=KRYLOV_MAXITER, log=True)
    bicg = dict(reltol=RELTOL, max_mv_products=4 * KRYLOV_MAXITER, log=True)
    one, two, four = (lambda s: s), (lambda s: 2 * s), (lambda s: 4 * s)
    return {
        "minres stencil": (lambda op: its.minres(op, b1, **conv), St, b1,
                           A64, "stencil_apply", one, "laplacian"),
        "minres int8 DIA": (lambda op: its.minres(op, b1, **conv), Ad, b1,
                            A64, "dia_spmv", one, "laplacian"),
        "qmr stencil": (lambda op: its.qmr(op, b1, **conv), St, b1, A64,
                        "stencil_apply", two, "laplacian"),
        "bicgstabl(2) stencil": (lambda op: its.bicgstabl(op, b1, 2, **bicg),
                                 St, b1, A64, "stencil_apply", four,
                                 "laplacian"),
        "idrs(8) shifted stencil": (
            lambda op: its.idrs(op, b1, s=8, **conv), Sh, b1, Sh64,
            "stencil_apply", one, "shifted"),
        "pipelined_cg shifted stencil": (
            lambda op: its.pipelined_cg(op, b1, **conv), Sh, b1, Sh64,
            "stencil_apply", lambda s: 1 + s, "shifted"),
        "pipelined_cg shifted int8 DIA": (
            lambda op: its.pipelined_cg(op, b1, **conv), ShD, b1, Sh64,
            "dia_spmv", lambda s: 1 + s, "shifted"),
        "chebyshev shifted stencil": (
            lambda op: its.chebyshev(op, b1, lmin, lmax, **conv), Sh, b1,
            Sh64, "stencil_apply", one, "shifted"),
        "pipelined_cg stencil": (
            lambda op: its.pipelined_cg(op, b1, **conv), St, b1, A64,
            "stencil_apply", lambda s: 1 + s, "recorded"),
        "idrs(8) stencil": (lambda op: its.idrs(op, b1, s=8, **conv), St, b1,
                            A64, "stencil_apply", one, "recorded"),
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
    share from a trace of the same solve."""
    from torch.profiler import ProfilerActivity, profile

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
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                solve(op)
                torch.cuda.synchronize()
            by_kernel = device_ms(torch, prof, name)
            busy = sum(by_kernel.values())
            row.update(device_busy_ms=busy, busy_share=busy / wall,
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
    """Run ``fn`` once under ``torch.profiler`` with CUDA's sync debug mode
    on: (result, device busy ms by kernel, host synchronisations counted by
    torch's sync warnings)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings(record=True) as caught, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return out, device_ms(torch, prof, name), syncs


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
    Returns the runs by name, the product timings and the launches of the
    phase by kernel key and run."""
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
    return runs, products, launches


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
    ap.add_argument("--world", type=int, default=DIST_RANKS)
    ap.add_argument("--rendezvous")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.dist_rank is not None:
        return dist_rank(args)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
                 "drives the port on a GPU and has nothing to run here")

    from torch.profiler import ProfilerActivity, profile

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
        "dot_order_spread": spread,
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
        by_kernel = device_ms(torch, prof, name)
        busy = sum(by_kernel.values())
        wall = statistics.median(samples[f"cg {name} maxiter=504"])
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        trace[name] = {"steps": 504, "wall_ms": wall,
                       "traced_wall_ms": traced_ms, "device_busy_ms": busy,
                       "busy_share": busy / wall, "top_device_ms": dict(top)}
    print(json.dumps({"trace": trace}))

    # ---- 7-10. GMRES -------------------------------------------------------
    panels, w_gm, gerr, gres = gmres_parity(torch, its, cuda_mgs, cuda_arnoldi,
                                            n)
    gcounters = counters + (cuda_mgs.panel_mgs, cuda_arnoldi.stencil_panel_mv,
                            cuda_arnoldi.fused_arnoldi)
    gruns, gout, gsolve, groutes = gmres_main_path(
        torch, its, gmres_mod, gcounters, paths, b, true_res, rel_diff, timed)
    conv, conv_x = gmres_converging(torch, its, gmres_mod, St, b)
    ab = gmres_fused_ab(torch, gmres_mod, gcounters, St, gsolve, timed)
    gtrace = gmres_trace(torch, gsolve,
                         {k: groutes[k] for k in ("stencil_bf16",
                                                  "stencil_f32", "dia_f32")},
                         samples)

    # ---- 11. every kernel beside its bound ----------------------------------
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
    t0 = time.perf_counter()
    _, p15_products, p15 = formats_phase(
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
