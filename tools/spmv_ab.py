"""Time the stencil and DIA kernels at 216^3 on one card, and compare two
checkouts of the port in turns.

    python3 tools/spmv_ab.py [--parent DIR]

Each checkout is measured in a process of its own (both packages have the
same name), which builds its kernels and times, at n = 216^3 with a seeded
x: ``stencil_apply`` (with and without the dot, f32), ``dia_spmv_dot`` and
``dia_spmv`` on f32, bf16 and int8 diagonals of ``laplace_dia``, and
``stencil_panel_mv`` on f32 and bf16 panels, through the calls a solver
makes (``mv_dot``, ``mv``).  For each it prints ``ms``, ``device_ms`` and
``host_us`` as ``chip_smoke.kernel_timing`` (of this checkout) takes them:
CUDA events around 20 back-to-back calls; one call between events behind a
sleep kernel, so that the host's time does not show; the host time of one
call.

With ``--parent DIR`` (a checkout of another commit, e.g. from ``git
archive``) it runs parent, this checkout, this checkout, parent, and prints
each kernel's four readings.  It needs a CUDA card and exits non-zero
without one.
"""

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

SIDE = 216
HERE = pathlib.Path(__file__).resolve().parent.parent


def chip_smoke():
    """This checkout's ``chip_smoke`` module, loaded from its file (the
    measured checkout's root stands first on the path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(torch, its, fixtures, ca):
    """name -> call, at 216^3."""
    n = SIDE**3
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, generator=g, device="cuda")
    St = its.laplacian(SIDE, 3)
    A = fixtures.laplace_dia(SIDE, 3, dtype="float32")
    dias = {"f32": A, "bf16": its.compress_values(A, torch.bfloat16),
            "int8": its.compress_values(A, torch.int8)}
    args = (St.n, St.center, St.terms, St.coeffs)
    panel = torch.randn(6, n, generator=g, device="cuda")
    k5 = torch.tensor(5, dtype=torch.int32, device="cuda")
    out = {"stencil_apply f32 (dot)": lambda: St.mv_dot(x),
           "stencil_apply f32": lambda: St.mv(x)}
    for label, Ad in dias.items():
        out[f"dia_spmv_dot {label}"] = lambda Ad=Ad: Ad.mv_dot(x)
        out[f"dia_spmv {label}"] = lambda Ad=Ad: Ad.mv(x)
    for label, V in (("bf16", panel.to(torch.bfloat16)), ("f32", panel)):
        out[f"stencil_panel_mv {label}"] = (
            lambda V=V: ca.stencil_panel_mv(*args, V, k5))
    return out


def measure(root):
    """One checkout's times, as a dict by kernel."""
    timing = chip_smoke().kernel_timing
    sys.path.insert(0, str(root))
    import torch

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.ops import _build
    from iterativesolvers_tpu_torch.ops import cuda_arnoldi as ca
    from iterativesolvers_tpu_torch.utils import fixtures

    if pathlib.Path(its.__file__).resolve().parent.parent != root.resolve():
        raise AssertionError(f"imported {its.__file__}, not from {root}")
    _build.build_all()
    return {name: timing(torch, fn)
            for name, fn in cases(torch, its, fixtures, ca).items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--measure", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("spmv_ab: torch.cuda.is_available() is false")
    if args.measure is not None:
        print(json.dumps(measure(args.measure)))
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    order = ([("parent", args.parent), ("change", HERE), ("change", HERE),
              ("parent", args.parent)] if args.parent else [("change", HERE)])
    runs = []
    for tag, root in order:
        out = subprocess.run([sys.executable, __file__, "--measure", str(root)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"{tag} ({root}) failed:\n{out.stdout[-4000:]}"
                     f"{out.stderr[-4000:]}")
        runs.append((tag, json.loads(out.stdout.strip().splitlines()[-1])))
    table = {name: [dict(t[name], run=tag) for tag, t in runs if name in t]
             for name in runs[0][1]}
    for name, rows in table.items():
        print(f"{name}: " + "; ".join(
            f"{r['run']} {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
            f"host {r['host_us']:.1f} us)" for r in rows))
    print(json.dumps({"spmv_ab": table}))


if __name__ == "__main__":
    main()
