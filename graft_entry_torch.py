"""Entry points of the PyTorch / CUDA port, the counterpart of
``__graft_entry__.py``.  It imports torch and ``iterativesolvers_tpu_torch``,
never JAX.

``entry(device="cuda")``        (fn, example_args): one CG step (the DIA
                                kernel's SpMV + dot bundle, the step's
                                vector updates) on the 2-D Laplace operator
                                ``laplace_dia(64, 2)`` in f32.
``dryrun_multichip(n, backend)`` n rank processes of this file under
                                ``torch.distributed`` (the caller's backend:
                                ``"nccl"`` one card a rank, ``"gloo"`` ranks
                                that share a card or run on the CPU) run the
                                tiny sharded solves of ``__graft_entry__.py``
                                and check each true residual.

Run ``python graft_entry_torch.py``: ``entry()`` on the card, then
``dryrun_multichip`` over NCCL on every card there is (at most 8).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

# each sharded run's limit on its true relative residual (f32 solves);
# LSQR's is the normal equations' residual |A^T r| / |A^T b|, LOBPCG's
# |A x - lambda x| / |lambda| a column, svdl's the singular values' error
# against numpy's SVD of the whole matrix
TRUE_RES = {"cg": 1e-3, "gmres": 1e-3, "lsqr": 1e-3, "lobpcg": 1e-2,
            "svdl": 1e-3}
COLLECTIVE_TIMEOUT = 120.0        # seconds a collective may wait
RANK_TIMEOUT = 300.0              # seconds the ranks may take in all


def entry(device="cuda"):
    """Return (fn, example_args): ``fn(state)`` is one CG step on the f32
    ``laplace_dia(64, 2)`` on ``device`` (on a card its SpMV and dot are
    the DIA kernel's one launch, its vector work ``ops/cuda_cg.py``'s
    two)."""
    import torch

    from iterativesolvers_tpu_torch.operators.preconditioners import (
        IdentityPreconditioner)
    from iterativesolvers_tpu_torch.solvers.cg import _cg_init, _cg_step
    from iterativesolvers_tpu_torch.utils.fixtures import laplace_dia

    A = laplace_dia(64, 2, dtype=np.float32, device=device)
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float32, device=device)
    x0 = torch.zeros(n, dtype=torch.float32, device=device)
    tol = (torch.tensor(1e-6, device=device), torch.tensor(0.0,
                                                          device=device))
    state = _cg_init(A, b, x0, *tol, 200, True)
    Pl = IdentityPreconditioner()
    live = torch.ones((), dtype=torch.bool, device=device)

    def step(state):
        return _cg_step(A, Pl, state, live)

    return step, (state,)


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     device: str = "cuda") -> dict:
    """Run the tiny sharded solves on ``n_devices`` rank processes of this
    file over ``backend`` (``device="cuda"``: rank r on card r % count;
    ``"cpu"``: every rank on the CPU, with gloo) and check each one's true
    residual.  Returns rank 0's record: each run's steps and residual.  A
    rank that fails or outlasts ``RANK_TIMEOUT`` raises."""
    n = int(n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--dryrun-rank"]
        procs = [subprocess.Popen(
            cmd + [str(r), str(n), backend, device, tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        t0, logs = time.monotonic(), []
        try:
            for p in procs:
                left = RANK_TIMEOUT - (time.monotonic() - t0)
                logs.append(p.communicate(timeout=max(left, 1))[0].decode(
                    errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log) for r, (p, log) in
               enumerate(zip(procs, logs)) if p.returncode != 0]
        if bad:
            raise AssertionError("\n".join(
                f"dryrun rank {r} exited {rc}:\n{log[-4000:]}"
                for r, rc, log in bad))
        with open(f"{tmp}/rank0.json") as f:
            return json.load(f)


def _rank(rank: int, world: int, backend: str, device: str, tmp: str):
    """One rank of ``dryrun_multichip``: every run, its true residual
    checked, the record written by rank 0."""
    import torch

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.parallel import (
        DenseMeshOperator, HaloDIAOperator, HaloStencilOperator,
        RowShardedELLOperator, ShardedBlockJacobiPreconditioner,
        gather_vector, row_mesh, shard_dia, shard_vector, slice_mesh)
    from iterativesolvers_tpu_torch.solvers.gmres import _dist_panel_setup
    from iterativesolvers_tpu_torch.utils.fixtures import (
        laplace_dia, random_sparse, variable_diffusion)

    dev = (f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
           if device == "cuda" else device)
    common = dict(init_method=f"file://{tmp}/rendezvous", rank=rank,
                  world_size=world, timeout=COLLECTIVE_TIMEOUT)
    mesh = row_mesh(backend, dev, **common)
    record, f32 = {}, torch.float32

    def rel(r, b):
        return float(torch.linalg.vector_norm(r.double())
                     / torch.linalg.vector_norm(b.double()))

    def held(name, kind, res, **extra):
        record[name] = {"true_residual": res, "limit": TRUE_RES[kind],
                        **extra}
        if not res <= TRUE_RES[kind]:
            raise AssertionError(f"{name}: true residual {res:.3e} above "
                                 f"{TRUE_RES[kind]:.0e}")

    def solved(name, kind, A, xl, b=None, **extra):
        """A x = b (default ones) with x gathered from this rank's rows."""
        x = gather_vector(xl, mesh)
        b = torch.ones(A.shape[0], device=x.device) if b is None else b
        held(name, kind, rel(A.mv(x.to(A.dtype)) - b, b), **extra)

    try:
        # problem size: divisible by the ranks, with halo <= n_local
        side = max(8, world)
        A = laplace_dia(side, 2, dtype=np.float32, device=dev)
        if A.shape[0] % world:
            side = world * 2
            A = laplace_dia(side, 2, dtype=np.float32, device=dev)
        n = A.shape[0]
        lo, hi = mesh.rows(n)
        b = torch.ones(hi - lo, device=dev)

        # 1) the explicit halo operator: a whole CG solve
        op = HaloDIAOperator(A, mesh)
        x, h = its.cg(op, b, reltol=1e-5, maxiter=200, log=True)
        solved("cg halo dia", "cg", A, x, steps=h.iters)

        # 2) shard_dia: the row-sharded DIA matrix through the solver
        As = shard_dia(A, mesh)
        x, h = its.cg(As, b, reltol=1e-5, maxiter=200, log=True)
        solved("cg shard_dia", "cg", A, x, steps=h.iters,
               type=type(As).__name__)

        # 3) GMRES on the halo operator: the sharded-panel route
        if world > 1 and _dist_panel_setup(op, n, f32, "mgs") is None:
            raise AssertionError("sharded-panel GMRES must be active on the "
                                 "halo operator")
        x, h = its.gmres(op, b, restart=8, maxiter=400, reltol=1e-4,
                         log=True)
        solved("gmres halo dia", "gmres", A, x, steps=h.iters)

        # 3c) n % D != 0: the padded last shard of the sharded panel
        n_odd = world * 6 + 3
        rng = np.random.default_rng(5)
        M = (np.eye(n_odd) * 4.0 + 0.3 * rng.standard_normal(
            (n_odd, n_odd)) / np.sqrt(n_odd)).astype(np.float32)
        Md = DenseMeshOperator(torch.from_numpy(M), mesh)
        dist = _dist_panel_setup(Md, n_odd, f32, "mgs")
        if world > 1 and (dist is None or dist.layout.n_pad == n_odd):
            raise AssertionError("a non-divisible n must take the padded "
                                 "sharded-panel route")
        x, h = its.gmres(Md, torch.ones(Md.mat.shape[0], device=dev),
                         restart=8, maxiter=400, reltol=1e-4, log=True)
        solved("gmres dense padded", "gmres",
               its.MatrixOperator(torch.from_numpy(M).to(dev)), x,
               steps=h.iters, n=n_odd)

        # 3d) the red-black reduced system's DIA form on the halo operator
        s3d = max(2 * world, 8)
        A3d = variable_diffusion(s3d, 2, contrast=100.0, seed=2,
                                 dtype=np.float32, device=dev)
        R = its.RBReducedSystem.from_dia(A3d, s3d, 2)
        bb, br = R.reduce_rhs(torch.ones(A3d.shape[0], device=dev))
        xb, h = its.cg(HaloDIAOperator(R.to_dia(), mesh),
                       shard_vector(bb, mesh), reltol=1e-5, maxiter=400,
                       log=True)
        x3d = R.expand_solution(gather_vector(xb, mesh), br)
        ones = torch.ones(A3d.shape[0], device=dev)
        held("cg rb reduced", "cg", rel(A3d.mv(x3d) - ones, ones),
             steps=h.iters)

        # 3b) block-Jacobi IC(0), multicolor, as CG's preconditioner
        P = ShardedBlockJacobiPreconditioner.ic(A.to_csr(), mesh,
                                                ordering="multicolor")
        x, h = its.cg(op, b, Pl=P, reltol=1e-5, maxiter=200, log=True)
        solved("cg block-jacobi ic0", "cg", A, x, steps=h.iters)

        # 4) the row-sharded ELL operator under LSQR (mv and rmv)
        mr, nc = 16 * world, 8 * world
        E = random_sparse(mr, nc, 0.2, seed=7, dtype=np.float32,
                          device=dev).to_ell()
        Es = RowShardedELLOperator(E, mesh)
        xe, h = its.lsqr(Es, torch.ones(Es.local.shape[0], device=dev),
                         atol=1e-5, btol=1e-5, maxiter=200, log=True)
        xe = gather_vector(xe, mesh)
        be = torch.ones(mr, device=dev)
        held("lsqr row-sharded ell", "lsqr",
             rel(E.rmv(be - E.mv(xe)), E.rmv(be)), steps=h.iters)

        # 5) LOBPCG's block products on the halo operator
        X0 = np.random.default_rng(11).standard_normal((n, 2)).astype(
            np.float32)
        r = its.lobpcg(op, shard_vector(X0, mesh), largest=False,
                       maxiter=200, tol=1e-3)
        X = gather_vector(r.X, mesh)
        lam = r.lam.to(dev)
        res = torch.linalg.vector_norm(A.mv(X) - X * lam, dim=0) / lam.abs()
        held("lobpcg halo dia", "lobpcg", float(res.max()),
             steps=r.iterations)

        # 6) svdl on the rectangular ELL operator (mv and rmv)
        vals, _ = its.svdl(Es, nsv=2, k=4, maxiter=100,
                           key=torch.Generator(device=dev).manual_seed(0))
        want = np.linalg.svd(E.to_dense().double().cpu().numpy(),
                             compute_uv=False)[:2]
        got = vals.double().cpu().numpy()
        held("svdl row-sharded ell", "svdl",
             float(np.max(np.abs(got - want) / want)))

        # 7) the halo stencil operator (the stencil kernel a rank)
        St = its.laplacian(side, 2, dtype=f32, device=dev)
        x, h = its.cg(HaloStencilOperator(St, mesh), b, reltol=1e-5,
                      maxiter=200, log=True)
        solved("cg halo stencil", "cg", St, x, steps=h.iters)

        # 8) a (2, D / 2) slice mesh over the same ranks
        if world >= 4 and world % 2 == 0:
            mesh2 = slice_mesh(2, world // 2, backend, dev, **common)
            x, h = its.cg(HaloDIAOperator(A, mesh2), b, reltol=1e-5,
                          maxiter=200, log=True)
            # the slice mesh's rows are the row mesh's: gathered on it
            solved("cg slice_mesh", "cg", A, x, steps=h.iters)
    finally:
        mesh.close()
    if rank == 0:
        with open(f"{tmp}/rank0.json", "w") as f:
            json.dump(record, f)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--dryrun-rank":
        r, w, be, dv, out = sys.argv[2:7]
        _rank(int(r), int(w), be, dv, out)
        sys.exit(0)
    import torch

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ok")
    print(json.dumps(dryrun_multichip(min(8, torch.cuda.device_count()))))
    print("dryrun_multichip ok")
