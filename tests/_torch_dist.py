"""Rank worker of the distributed tests (``tests/test_torch_parallel.py`` on
CPU ranks over gloo, ``tests/test_torch_gpu.py`` on the card), one process
per rank, and :func:`launch`, which starts them.

It imports torch and the port, never JAX, so that a rank starts in about two
seconds and the JAX package stays out of it.  :func:`launch` runs D of them:

    python tests/_torch_dist.py IN.npz OUT_DIR RANK WORLD RENDEZVOUS BACKEND [MESH]

``IN.npz`` holds a JSON list of cases under ``"cases"`` and each case's
arrays under ``"<case>/<key>"``; rank 0 prints each case's wall time as it
ends.  Rank r writes ``OUT_DIR/rank<r>.npz`` with
each case's outputs under ``"<case>/<key>"``; vectors are gathered whole
(``gather_vector``) on every rank, so every rank's file can be held against
rank 0's.  BACKEND ``gloo`` puts every rank on the CPU, ``gloo-cuda`` every
rank on ``cuda:0``, ``nccl`` rank r on ``cuda:r``.  MESH ``row`` (the
default) makes a ``row_mesh``, ``slice:SxC`` a ``slice_mesh(S, C)``.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import cuda_spmv, cuda_stencil
from iterativesolvers_tpu_torch.parallel import panel_ortho as po
from iterativesolvers_tpu_torch.parallel import (
    HaloDIAOperator, ShardedBlockJacobiPreconditioner, dist_panel_ortho,
    gather_vector, panel_layout, row_mesh, shard_ell, shard_vector,
    slice_mesh)
from iterativesolvers_tpu_torch.solvers import gmres as pgm
from iterativesolvers_tpu_torch.utils import convert
from iterativesolvers_tpu_torch.utils.profiling import collective_counts

# seconds a collective may wait before it raises (the test's own timeout on
# the processes is longer)
COLLECTIVE_TIMEOUT = 60.0

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _operator(c, a, mesh):
    """The case's mesh operator, built from host arrays with utils/convert;
    with ``"shard": true`` in the spec a DIA or ELL matrix goes through
    ``shard_dia`` (the ``"sharded_dia"`` kind) / ``shard_ell`` instead."""
    spec = dict(c["op"])
    shard = spec.pop("shard", False)
    if spec["kind"] == "dia":
        spec["diags"] = [a[f"diag{i}"] for i in range(spec.pop("ndiags"))]
    elif spec["kind"] == "ell":
        spec["data"], spec["cols"] = a["data"], a["cols"]
        if "adj_data" in a:
            spec["adj"] = dict(data=a["adj_data"], cols=a["adj_cols"],
                               shape=spec["shape"][::-1])
    elif spec["kind"] == "dense":
        spec["mat"] = a["mat"]
    elif "coeffs" in a:
        # complex coefficients travel as arrays (JSON has no complex)
        spec["center"], spec["coeffs"] = a["center"][()], list(a["coeffs"])
    if shard and spec["kind"] == "ell":
        spec.pop("kind")
        return shard_ell(convert.ell_from_arrays(device="cpu", **spec), mesh)
    if shard:
        spec["kind"] = "sharded_dia"      # shard_dia of the whole matrix
    return convert.operator_from_arrays(spec, mesh=mesh)


def _rows(P, mesh):
    """The whole (k, n) row panel from every rank's (k, n_local) block."""
    return _np(gather_vector(P.T.contiguous(), mesh).T)


@contextlib.contextmanager
def _counted(calls, targets):
    """Count the calls of each ``(module, name)`` in ``calls[name]``."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        calls[name] = 0

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


ROUTES = ((pgm, "dist_panel_ortho"), (pgm, "panel_mgs"),
          (pgm, "fused_arnoldi"), (po, "panel_dots"), (po, "panel_update"))


def halo_ops(c, a, mesh):
    """mv, rmv and mv_dot of a halo operator on the whole x."""
    op = _operator(c, a, mesh)
    x = shard_vector(a["x"], mesh)
    y, d = op.mv_dot(x)
    return {"mv": _np(gather_vector(op.mv(x), mesh)),
            "rmv": _np(gather_vector(op.rmv(x), mesh)),
            "mv_dot_y": _np(gather_vector(y, mesh)), "mv_dot": _np(d)}


def interior(c, a, mesh):
    """Each rank's shard-local stencil interior of A and of A^H."""
    op = _operator(c, a, mesh)
    x = shard_vector(a["x"], mesh)
    out = {}
    for conj in (False, True):
        center, eff, cs = op._stencil(conj)
        y = op._local_interior(eff, cs, center, x)
        out[f"conj{int(conj)}"] = _np(gather_vector(y, mesh))
    return out


def panel(c, a, mesh):
    """dist_panel_ortho on this rank's block of the global (m1, D*R, 512)
    panel, with the sweeps counted."""
    n, m1, k = c["n"], c["m1"], c["k"]
    lay = panel_layout(n, mesh.size)
    R = lay.R
    V = torch.from_numpy(a["V"][:, mesh.rank * R:(mesh.rank + 1) * R])
    V = V.to(DTYPES[c["panel"]]).contiguous()
    w = shard_vector(a["w"], mesh)
    calls = {}
    with _counted(calls, ROUTES[3:]):
        w2d, h, nrm = dist_panel_ortho(V, w, k, m1, mesh, lay,
                                       passes=c.get("passes", 2))
    full = gather_vector(w2d.reshape(-1), mesh).reshape(-1, 512)
    return {"w2d": _np(full), "h": _np(h), "nrm": _np(nrm),
            "dtype": np.array(str(w2d.dtype)), **_calls(calls)}


def _calls(calls):
    return {f"calls/{k}": np.array(v) for k, v in calls.items()}


def _history(x, h, mesh):
    return {"x": _np(gather_vector(x, mesh)), "iters": np.array(h.iters),
            "mvps": np.array(h.mvps), "converged": np.array(h.isconverged),
            "resnorm": np.asarray(h["resnorm"]),
            "restarts": np.array(getattr(h, "restarts", 0))}


def _solve(c, a, mesh, solver):
    op = _operator(c, a, mesh)
    b = shard_vector(a["b"], mesh)
    kw = dict(c.get("kw", {}))
    if "panel_dtype" in kw:
        kw["panel_dtype"] = DTYPES.get(kw["panel_dtype"])
    if "jacobi" in kw:
        # a diagonal preconditioner of one value: this rank's rows of it
        kw["Pl"] = pits.DiagonalPreconditioner(
            torch.full(b.shape, kw.pop("jacobi"), dtype=b.dtype),
            device=b.device)
    calls = {}
    with warnings.catch_warnings(record=True) as caught, \
            _counted(calls, ROUTES):
        warnings.simplefilter("always")
        x, h = solver(op, b, log=True, **kw)
    return {**_history(x, h, mesh), **_calls(calls),
            "warnings": np.array([str(w.message) for w in caught] or [""])}


def gmres(c, a, mesh):
    return _solve(c, a, mesh, pits.gmres)


def cg(c, a, mesh):
    return _solve(c, a, mesh, pits.cg)


def pipecg(c, a, mesh):
    """pipelined_cg, with the mesh's allreduces counted."""
    calls = [0]
    orig = mesh.all_reduce

    def count(t):
        calls[0] += 1
        return orig(t)

    mesh.all_reduce = count
    try:
        out = _solve(c, a, mesh, pits.pipelined_cg)
    finally:
        del mesh.all_reduce          # the class's method again
    return {**out, "allreduces": np.array(calls[0])}


def setup(c, a, mesh):
    """The sharded-panel dispatch for each (dtype, orth_method): "dist",
    "none", or "raise: <message>"."""
    op = _operator(c, a, mesh)
    out = {}
    for dt, orth in c["gates"]:
        try:
            got = pgm._dist_panel_setup(op, op.shape[1], DTYPES.get(
                dt, torch.complex128), orth)
            res = "none" if got is None else "dist"
        except NotImplementedError as e:
            res = f"raise: {e}"
        out[f"{dt}/{orth}"] = np.array(res)
    return out


def bjacobi(c, a, mesh):
    """ShardedBlockJacobiPreconditioner.<factor> (``c["factor"]``, "ilu" or
    "ic", with ``c["ordering"]``) of the case's whole DIA matrix: its ldiv
    of x gathered, its nlevels and this rank's own; with ``c["kw"]``, CG
    on the halo DIA operator with it as ``Pl``."""
    n = len(a["x"])
    whole = convert.dia_from_arrays(
        [a[f"diag{i}"] for i in range(c["op"]["ndiags"])],
        c["op"]["offsets"], (n, n), device="cpu")
    build = getattr(ShardedBlockJacobiPreconditioner, c["factor"])
    P = build(whole, mesh, ordering=c["ordering"])
    x = shard_vector(a["x"], mesh)
    out = {"ldiv": _np(gather_vector(P.ldiv(x), mesh)),
           "nlevels": np.array(P.nlevels),
           "local_nlevels": np.array(P.local.nlevels)}
    if "kw" in c:
        op = _operator(c, a, mesh)
        xs, h = pits.cg(op, shard_vector(a["b"], mesh), Pl=P, log=True,
                        **c["kw"])
        out.update(_history(xs, h, mesh))
    return out


def rows(c, a, mesh):
    """mv_rows of the (k, n) panel ``X`` (each rank its columns), with the
    mesh's exchanges and this rank's stencil kernel launches counted."""
    op = _operator(c, a, mesh)
    X = shard_vector(a["X"].T, mesh).T.contiguous()
    launches = cuda_stencil.stencil_apply.launches
    with collective_counts(mesh) as n:
        Y = op.mv_rows(X)
    return {"Y": _rows(Y, mesh), "permutes": np.array(
        n["collective-permute"]), "launches": np.array(
        cuda_stencil.stencil_apply.launches - launches)}


def mesh_ops(c, a, mesh):
    """mv and rmv of an ELL or dense mesh operator on ``x`` (columns) and
    ``y`` (rows), each with the collectives it issued."""
    op = _operator(c, a, mesh)
    out = {}
    for name, f, v in (("mv", op.mv, a["x"]), ("rmv", op.rmv, a["y"])):
        with collective_counts(mesh) as n:
            r = f(shard_vector(v, mesh))
        out[name] = _np(gather_vector(r, mesh))
        out.update({f"{name}/{k}": np.array(v) for k, v in n.items()})
    return out


def cg_step(c, a, mesh):
    """The collectives of one CG step (after its set-up) on the operator."""
    it = pits.cg_iterator(_operator(c, a, mesh), shard_vector(a["b"], mesh),
                          maxiter=10)
    with collective_counts(mesh) as n:
        next(it)
    return {k: np.array(v) for k, v in n.items()}


def solve(c, a, mesh):
    """``c["solver"]`` (block_cg, lsqr, lsmr, lobpcg or svdl) on the mesh
    operator, its results gathered; with the mesh's all-reduces by level on
    a slice mesh."""
    op = _operator(c, a, mesh)
    kw = dict(c.get("kw", {}))
    name = c["solver"]
    before = dict(getattr(mesh, "level_counts", {}))
    if name in ("lsqr", "lsmr", "block_cg", "cg", "gmres"):
        x, h = getattr(pits, name)(op, shard_vector(a["b"], mesh), log=True,
                                   **kw)
        out = {"x": _np(gather_vector(x, mesh)), "iters": np.array(h.iters),
               "converged": np.array(h.isconverged),
               # LSMR logs no :resnorm series
               "resnorm": np.asarray(h.data.get("resnorm", []))}
        if name in ("lsqr", "lsmr"):
            out["istop"] = np.array(h["istop"])
            out.update({k: np.asarray(h[k]) for k in ("rnorm", "anorm")})
    elif name == "lobpcg":
        r = pits.lobpcg(op, shard_vector(a["X0"], mesh), log=True, **kw)
        out = {"lam": _np(r.lam), "X": _np(gather_vector(r.X, mesh)),
               "iters": np.array(r.iterations),
               "converged": np.array(r.converged),
               "resnorms": _np(r.residual_norms),
               "trace": np.asarray(r.history["resnorm"])}
    else:
        (left, s, right), _, h = pits.svdl(
            op, v0=shard_vector(a["v0"], mesh), vecs="both", log=True, **kw)
        out = {"values": _np(s), "iters": np.array(h.iters),
               "converged": np.array(h.isconverged),
               "left": _np(gather_vector(left, mesh)),
               "right": _rows(right, mesh),
               "ritz": np.asarray(h["ritz"])}
    for level, v in getattr(mesh, "level_counts", {}).items():
        out[f"allreduce/{level}"] = np.array(v - before[level])
    return out


# ---- the row-sharded DIA / ELL matrices of shard_dia / shard_ell -----------

def _whole_values(M, mesh):
    """The whole value panel of a row-sharded DIA (ndiag, n) or ELL (n, w)
    matrix, as f32 for bf16."""
    if hasattr(M, "offsets"):
        return _np(M.unsharded().data)
    return _np(gather_vector(M.data, mesh))


def _products(op, c, a, mesh):
    """mv, rmv, mv_rows and (square) mv_dot, each whole, with the
    collectives mv issued."""
    x, y = shard_vector(a["x"], mesh), shard_vector(a["y"], mesh)
    X = shard_vector(a["X"].T, mesh).T.contiguous()
    kernels = (cuda_spmv.dia_spmv, cuda_spmv.dia_spmv_dot)
    before = [f.launches for f in kernels]
    with collective_counts(mesh) as n:
        ymv = op.mv(x)
    out = {"mv": _np(gather_vector(ymv, mesh)),
           "rmv": _np(gather_vector(op.rmv(y), mesh)),
           "mv_rows": _rows(op.mv_rows(X), mesh),
           **{f"mv/{k}": np.array(v) for k, v in n.items()}}
    if op.shape[0] == op.shape[1]:
        yd, d = op.mv_dot(x)
        out.update(mv_dot_y=_np(gather_vector(yd, mesh)), mv_dot=_np(d))
    # the DIA kernel's launches (on a card) of the four products
    out.update({f"launches/{f.__name__}": np.array(f.launches - b0)
                for f, b0 in zip(kernels, before)})
    return out


def _whole(op, c, a, mesh):
    """What the JAX package hands back whole, and the sharded casts."""
    csr, F = op.to_csr(), op.astype(torch.float32)
    out = {"csr_data": _np(csr.data), "csr_indices": _np(csr.indices),
           "csr_indptr": _np(csr.indptr), "dense": _np(op.to_dense()),
           "astype": _whole_values(F, mesh),
           "astype_type": np.array(type(F).__name__)}
    if hasattr(op, "offsets"):
        d, present = op.diagonal()
        out.update(diagonal=_np(d), present=_np(present),
                   data=_np(op.data))
    else:
        out.update(row_width=np.array(op.row_width), chunked_mv=_np(
            gather_vector(op.with_chunked_gather(3).mv(
                shard_vector(a["x"], mesh)), mesh)))
    for dt in (torch.bfloat16, torch.int8):
        C = pits.compress_values(op, dt)
        key = str(dt).split(".")[1]
        out.update({f"compress/{key}/dtype": np.array(str(C.dtype)),
                    f"compress/{key}/type": np.array(type(C).__name__),
                    f"compress/{key}/values": _whole_values(C, mesh),
                    f"representable/{key}": np.array(
                        pits.values_representable(op, dt))})
    return out


def _bounds(op, c, a, mesh):
    return {"gershgorin": np.array(pits.gershgorin_bounds(op))}


def _power(op, c, a, mesh):
    """power_bound from a seeded generator, on the matrix and, where its
    halo fits a block, on the HaloDIAOperator of the same matrix."""
    def gen():
        return torch.Generator(device=mesh.device).manual_seed(3)

    out = {"power": _np(pits.power_bound(op, 20, key=gen()))}
    if c.get("halo_power"):
        H = HaloDIAOperator(op.unsharded(), mesh)
        out["halo_power"] = _np(pits.power_bound(H, 20, key=gen()))
    return out


def _solves(op, c, a, mesh):
    """Each solver of ``c["solves"]`` (name: keywords) on the matrix."""
    out = {}
    for name, kw in c["solves"].items():
        if name == "lobpcg":
            r = pits.lobpcg(op, shard_vector(a["X0"], mesh), **kw)
            out.update({"lobpcg/lam": _np(r.lam),
                        "lobpcg/X": _np(gather_vector(r.X, mesh)),
                        "lobpcg/iters": np.array(r.iterations)})
            continue
        solver = getattr(pits, name.split(":")[0])
        kw = dict(kw)
        pl = kw.pop("Pl", None)
        if pl is not None:
            cls = {"ic": pits.ICPreconditioner,
                   "ilu": pits.ILUPreconditioner}[pl.split(":")[0]]
            kw["Pl"] = cls.from_operator(op, ordering=pl.split(":")[1])
        x, h = solver(op, shard_vector(a["b"], mesh), log=True, **kw)
        out.update({f"{name}/x": _np(gather_vector(x, mesh)),
                    f"{name}/iters": np.array(h.iters),
                    f"{name}/resnorm": np.asarray(h["resnorm"])})
    return out


def _stationary(op, c, a, mesh):
    """5 sweeps of each stationary method (and one multicolor sweep's
    worth of Gauss-Seidel), and SOR's iterable."""
    b = shard_vector(a["b"], mesh)
    out = {}
    for name, kw in (("jacobi", {}), ("gauss_seidel", {}),
                     ("sor", {"omega": 1.2}), ("ssor", {"omega": 1.2}),
                     ("gauss_seidel:multicolor", {"ordering": "multicolor"})):
        f = getattr(pits, name.split(":")[0])
        x = (f(op, b, kw.pop("omega"), maxiter=5, **kw) if "omega" in kw
             else f(op, b, maxiter=5, **kw))
        out[name] = _np(gather_vector(x, mesh))
    it = pits.sor_iterable(op, b, 1.2, maxiter=5)
    for _ in it:
        pass
    out["sor_iterable"] = _np(gather_vector(it.x, mesh))
    return out


def _reduced(op, c, a, mesh):
    """RBReducedSystem.from_dia and the block-Jacobi IC(0) of the matrix."""
    side, dims = c["grid"]
    R = pits.RBReducedSystem.from_dia(op, side, dims)
    out = {"s_red": _np(R.s_red), "s_black": _np(R.s_black),
           "sr_offsets": np.array(R.sr_offsets),
           "sb_offsets": np.array(R.sb_offsets)}
    for i, t in enumerate(R.sr_streams):
        out[f"sr{i}"] = _np(t)
    for i, t in enumerate(R.sb_streams):
        out[f"sb{i}"] = _np(t)
    P = ShardedBlockJacobiPreconditioner.ic(op, mesh, ordering="natural")
    out["bjacobi"] = _np(gather_vector(P.ldiv(shard_vector(a["x"], mesh)),
                                       mesh))
    out["rbic"] = _np(gather_vector(
        pits.RedBlackICPreconditioner.from_dia(op, side, dims).ldiv(
            shard_vector(a["x"], mesh)), mesh))
    return out


def _adjoint(op, c, a, mesh):
    """with_adjoint of a row-sharded ELL matrix: its adjoint's arrays and
    the adjoint product."""
    W = op.with_adjoint()
    return {"adj_data": _np(gather_vector(W.adj.data, mesh)),
            "adj_cols": _np(gather_vector(W.adj.cols, mesh)),
            "rmv": _np(gather_vector(W.rmv(shard_vector(a["y"], mesh)),
                                     mesh))}


SHARDED_ROUTES = {"products": _products, "whole": _whole, "bounds": _bounds,
                  "power": _power, "solves": _solves,
                  "stationary": _stationary, "reduced": _reduced,
                  "adjoint": _adjoint}


def sharded(c, a, mesh):
    """The routes ``c["do"]`` names on the row-sharded matrix of
    ``shard_dia`` / ``shard_ell`` (``"shard": true`` in the spec), each
    output under its route's name, vectors gathered whole."""
    op = _operator(c, a, mesh)
    out = {"type": np.array(type(op).__name__)}
    for what in c["do"]:
        for k, v in SHARDED_ROUTES[what](op, c, a, mesh).items():
            out[f"{what}/{k}"] = v
    return out


def mesh_spans(c, a, mesh):
    """The mesh's spans (``its.exchange``, ``its.allreduce``) that one
    ``mv_dot`` and one norm of the operator record under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    op = _operator(c, a, mesh)
    x = shard_vector(a["x"], mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, d = op.mv_dot(x)
        pits.solvers.common.norm(x, mesh)
    names = [e.name for e in prof.events()]
    return {"exchange": np.array(names.count("its.exchange")),
            "allreduce": np.array(names.count("its.allreduce")),
            "mv_dot": _np(d)}


def graph_cg(c, a, mesh):
    """CG on the operator from ``b``, then ``b2``, then ``b2`` again with
    ``maxiter`` = ``c["short"]``: as it runs (on a mesh of cards over NCCL,
    its phases replayed from CUDA graphs), then with its steps enqueued one
    by one; each solve's x, residual log and steps, the replays and graphs
    of the first two, and the graphs after the third."""
    from iterativesolvers_tpu_torch.solvers import cg as pcg
    from iterativesolvers_tpu_torch.solvers.common import _STEP_GRAPHS

    op = _operator(c, a, mesh)
    kw = dict(c.get("kw", {}))
    solves = (("graph", "b", {}), ("graph2", "b2", {}),
              ("graph3", "b2", {"maxiter": c["short"]}))

    def graphs():
        return np.array(sum(len(g.graphs)
                            for g in _STEP_GRAPHS.get(op, {}).values()))

    out = {}
    before = dict(mesh.counts)
    for tag, key, more in solves:
        x, h = pits.cg(op, shard_vector(a[key], mesh), log=True, **kw,
                       **more)
        out.update({f"{tag}/{k}": v for k, v in _history(x, h, mesh).items()})
        if tag == "graph2":
            out["replays"] = np.array(mesh.counts["replay"]
                                      - before["replay"])
            out["replay_steps"] = np.array(mesh.counts["replay_steps"]
                                           - before["replay_steps"])
            out["graphs"] = graphs()
    out["graphs3"] = graphs()
    eager = pcg._graphs
    pcg._graphs = lambda *args: None
    try:
        for tag, key, more in solves:
            tag = tag.replace("graph", "eager")
            x, h = pits.cg(op, shard_vector(a[key], mesh), log=True, **kw,
                           **more)
            out.update({f"{tag}/{k}": v
                        for k, v in _history(x, h, mesh).items()})
    finally:
        pcg._graphs = eager
    return out


CASES = {"halo_ops": halo_ops, "interior": interior, "panel": panel,
         "gmres": gmres, "cg": cg, "pipecg": pipecg, "setup": setup,
         "bjacobi": bjacobi, "rows": rows, "mesh_ops": mesh_ops,
         "cg_step": cg_step, "solve": solve, "sharded": sharded,
         "mesh_spans": mesh_spans, "graph_cg": graph_cg}


MESHES = {"gloo": ("gloo", lambda r: "cpu"),
          "gloo-cuda": ("gloo", lambda r: "cuda:0"),
          "nccl": ("nccl", lambda r: f"cuda:{r}")}


class Launch:
    """D running rank processes of one launch (:func:`start`); ``wait()``
    returns each rank's outputs.  A rank that fails or runs out of time
    fails the launch, with every rank's output so far (rank 0 prints each
    case's wall time as it ends, so a timeout names its case)."""

    def __init__(self, procs, tmp, timeout, label=""):
        self.procs, self.tmp, self.timeout = procs, tmp, timeout
        self.label = label
        self.t0 = time.monotonic()

    def wait(self):
        logs, late = [], False
        try:
            for p in self.procs:
                left = self.timeout - (time.monotonic() - self.t0)
                try:
                    logs.append(p.communicate(timeout=max(left, 1))[0])
                except subprocess.TimeoutExpired:
                    late = True
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            # what the killed ranks printed before the limit
            logs += [p.communicate()[0] for p in self.procs[len(logs):]]
        logs = [log.decode(errors="replace") for log in logs]
        secs = time.monotonic() - self.t0
        if os.environ.get("ITS_LAUNCH_LOG"):
            # each launch's seconds, for the launch budgets (SKILL.md)
            with open(os.environ["ITS_LAUNCH_LOG"], "a") as f:
                f.write(json.dumps({"cases": self.label, "ranks": len(
                    self.procs), "s": round(secs, 2), "late": late}) + "\n")
        failed = [(r, p.returncode, log) for r, (p, log) in
                  enumerate(zip(self.procs, logs)) if p.returncode != 0]
        if late or failed:
            head = (f"the launch ran past its {self.timeout} s limit "
                    f"({secs:.1f} s)\n" if late else "")
            raise AssertionError(head + "\n".join(
                f"rank {r} exited {rc}:\n{log[-4000:]}"
                for r, rc, log in failed))
        return [dict(np.load(self.tmp / f"rank{r}.npz"))
                for r in range(len(self.procs))]


def start(cases, D, tmp, backend="gloo", timeout=150, mesh="row"):
    """Start ``cases`` (a list of ``(case, arrays)``) in one launch of D
    rank processes with files under the directory ``tmp``, on a ``mesh``
    of kind ``"row"`` or ``"slice:SxC"``; the :class:`Launch` waits for
    them, ``timeout`` seconds from now."""
    tmp = pathlib.Path(tmp)
    arrays = {f"{c['name']}/{k}": v for c, a in cases for k, v in a.items()}
    inp = tmp / "in.npz"
    np.savez(inp, cases=np.array(json.dumps([c for c, _ in cases])),
             **arrays)
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), str(inp),
         str(tmp), str(r), str(D),
         str(tmp / "rendezvous"), backend, mesh], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(D)]
    return Launch(procs, tmp, timeout,
                  label=f"{cases[0][0]['name']} .. {cases[-1][0]['name']}")


def launch(cases, D, tmp, backend="gloo", timeout=150, mesh="row"):
    """Run ``cases`` in one launch of D rank processes (:func:`start`) and
    return each rank's outputs."""
    return start(cases, D, tmp, backend, timeout, mesh).wait()


def main(argv):
    inp, out_dir, rank, world, rendezvous, backend = argv[:6]
    kind = argv[6] if len(argv) > 6 else "row"
    torch.set_num_threads(1)
    data = np.load(inp)
    cases = json.loads(str(data["cases"]))
    name, device = MESHES[backend]
    common = dict(init_method=f"file://{rendezvous}", rank=int(rank),
                  world_size=int(world), timeout=COLLECTIVE_TIMEOUT)
    if kind == "row":
        mesh = row_mesh(name, device(int(rank)), **common)
    else:
        S, C = (int(v) for v in kind.split(":")[1].split("x"))
        mesh = slice_mesh(S, C, name, device(int(rank)), **common)
    results = {}
    try:
        for c in cases:
            pre = c["name"] + "/"
            arrays = {k[len(pre):]: data[k] for k in data.files
                      if k.startswith(pre)}
            t0 = time.perf_counter()
            for key, v in CASES[c["kind"]](c, arrays, mesh).items():
                results[pre + key] = v
            if mesh.rank == 0:
                print(f"case {c['name']}: {time.perf_counter() - t0:.2f} s",
                      flush=True)
    finally:
        mesh.close()
    np.savez(f"{out_dir}/rank{rank}.npz", **results)


if __name__ == "__main__":
    main(sys.argv[1:])
