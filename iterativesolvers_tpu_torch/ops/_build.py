"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

No source includes PyTorch's headers, so a build takes seconds.  The
libraries go into ``iterativesolvers_tpu_torch/_build/<hash>/``, keyed by a
hash of every source and the flags, and are built at first use: all sources
at once, one ``nvcc`` each, in parallel.  A missing ``nvcc`` or a failed
build raises.  ``ptxas -v``'s report of each kernel's registers, stack frame
and spills is kept beside the library (``lib<name>.log``) and read by
:func:`kernel_resources`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

__all__ = ["build_all", "load", "nvcc_path", "kernel_resources"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built at first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that is not built yet, in parallel; returns
    ``{name: path of lib<name>.so}``.  Raises if a build fails."""
    out = _build_dir()
    libs = {p.stem: out / f"lib{p.stem}.so" for p in _sources()}
    todo = [p for p in _sources() if not libs[p.stem].is_file()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        # build under a temporary name and rename, so that a build that was
        # cut off never leaves a library that looks finished
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
        else:
            libs[src.stem].with_suffix(".log").write_bytes(log)
            os.replace(tmp, libs[src.stem])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return libs


def kernel_resources(name: str) -> dict:
    """What ``ptxas -v`` reported for each kernel of ``csrc/<name>.cu``, by
    its mangled name: ``{"registers", "stack", "spill_stores",
    "spill_loads"}`` (bytes, but for the registers a thread)."""
    log = build_all()[name].with_suffix(".log").read_text(errors="replace")
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build_all()[name]))
