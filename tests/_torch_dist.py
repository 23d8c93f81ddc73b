"""Rank worker of the distributed tests (``tests/test_torch_parallel.py`` on
CPU ranks over gloo, ``tests/test_torch_gpu.py`` on the card), one process
per rank, and :func:`launch`, which starts them.

It imports torch and the port, never JAX, so that a rank starts in about two
seconds and the JAX package stays out of it.  :func:`launch` runs D of them:

    python tests/_torch_dist.py IN.npz OUT_DIR RANK WORLD RENDEZVOUS BACKEND [MESH]

``IN.npz`` holds a JSON list of cases under ``"cases"`` and each case's
arrays under ``"<case>/<key>"``.  Rank r writes ``OUT_DIR/rank<r>.npz`` with
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
import warnings

import numpy as np
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import cuda_stencil
from iterativesolvers_tpu_torch.parallel import panel_ortho as po
from iterativesolvers_tpu_torch.parallel import (
    ShardedBlockJacobiPreconditioner, dist_panel_ortho, gather_vector,
    panel_layout, row_mesh, shard_dia, shard_ell, shard_vector, slice_mesh)
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
    ``shard_dia`` / ``shard_ell`` instead."""
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
    if shard:
        kind = spec.pop("kind")
        whole = (convert.dia_from_arrays if kind == "dia"
                 else convert.ell_from_arrays)(device="cpu", **spec)
        return (shard_dia if kind == "dia" else shard_ell)(whole, mesh)
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


CASES = {"halo_ops": halo_ops, "interior": interior, "panel": panel,
         "gmres": gmres, "cg": cg, "pipecg": pipecg, "setup": setup,
         "bjacobi": bjacobi, "rows": rows, "mesh_ops": mesh_ops,
         "cg_step": cg_step, "solve": solve}


MESHES = {"gloo": ("gloo", lambda r: "cpu"),
          "gloo-cuda": ("gloo", lambda r: "cuda:0"),
          "nccl": ("nccl", lambda r: f"cuda:{r}")}


def launch(cases, D, tmp, backend="gloo", timeout=150, mesh="row"):
    """Run ``cases`` (a list of ``(case, arrays)``) in one launch of D rank
    processes with files under the directory ``tmp``, each process given
    ``timeout`` seconds, on a ``mesh`` of kind ``"row"`` or ``"slice:SxC"``;
    returns each rank's outputs.  A rank that fails or runs out of time
    fails the launch, with its output."""
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
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log) for r, (p, log) in
              enumerate(zip(procs, logs)) if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{log[-4000:]}"
                                        for r, rc, log in failed))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(D)]


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
            for key, v in CASES[c["kind"]](c, arrays, mesh).items():
                results[pre + key] = v
    finally:
        mesh.close()
    np.savez(f"{out_dir}/rank{rank}.npz", **results)


if __name__ == "__main__":
    main(sys.argv[1:])
