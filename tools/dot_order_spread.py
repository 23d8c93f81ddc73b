"""f32 CG at 216^3 with other orders of the dot, on one card, for one
checkout or for two in turns.

    python3 tools/dot_order_spread.py [--parent DIR]

Runs ``chip_smoke.dot_order_spread`` (of this checkout): f32 CG (reltol
1e-5) on the 216^3 Laplacian stencil with the kernel's in-launch dot,
torch.sum's, an f64 sum rounded once and a control that drops one block's
rows, on b = 1 and two seeded normal b, each against its f64 solve; prints
steps, true relative residual and ``|x - x64| / |x64|`` of every run.  With
``--parent DIR`` (a checkout of another commit, e.g. from ``git archive``)
it runs that checkout's package first, in a process of its own (both
packages have the same name): its kernel order beside this one's.  It needs
a CUDA card and exits non-zero without one.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "tools"))

from spmv_ab import chip_smoke  # noqa: E402


def measure(root):
    """One checkout's spread, as a dict by "order / b"."""
    cs = chip_smoke()
    sys.path.insert(0, str(root))
    import torch

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.ops import _build, _launch, cuda_stencil
    from iterativesolvers_tpu_torch.utils import fixtures

    if pathlib.Path(its.__file__).resolve().parent.parent != root.resolve():
        raise AssertionError(f"imported {its.__file__}, not from {root}")
    _build.build_all()
    St = its.laplacian(cs.SIDE, 3)
    A64 = fixtures.laplace_dia(cs.SIDE, 3, dtype="float64")
    dev = torch.device("cuda", torch.cuda.current_device())
    # the grid of the one-card stencil launch (f32, with the dot, no halo):
    # the control drops one of its blocks
    lib = _launch.library("stencil")
    grid = _launch.grid_for(
        _launch.query(lib.its_stencil_blocks_per_sm, 0, 1, 0, device=dev),
        dev, St.n, cuda_stencil.STENCIL_RUN)
    table = cs.dot_order_spread(torch, its, St, A64, grid)
    return {"grid": grid, **{f"{o} / {b}": row for (o, b), row in table.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--measure", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("dot_order_spread: torch.cuda.is_available() is false")
    if args.measure is not None:
        args.out.write_text(json.dumps(measure(args.measure)))
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    order = ([("parent", args.parent)] if args.parent else []) + [
        ("change", HERE)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, root in order:
            print(f"{tag} ({root}):", flush=True)
            res = pathlib.Path(tmp) / f"{tag}.json"
            run = subprocess.run([sys.executable, __file__, "--measure",
                                  str(root), "--out", str(res)])
            if run.returncode != 0:
                sys.exit(f"{tag} ({root}) failed")
            out[tag] = json.loads(res.read_text())
    print(json.dumps({"dot_order_spread": out}))


if __name__ == "__main__":
    main()
