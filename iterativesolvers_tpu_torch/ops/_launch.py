"""The launch layer between ``_build`` (compile and load) and the kernels'
wrappers (``cuda_*.py``): what every wrapper needs to call a kernel's C
entry, in one place.

* :func:`library`: a loaded library with each ``its_*`` entry's ``argtypes``
  and ``restype`` set from its ``extern "C"`` prototype in ``csrc/<name>.cu``
  (:func:`prototypes`), so that the prototype is the one declaration.
* :func:`raw_stream` and :func:`on_device`: the current stream and device of
  a launch, at the least host time (a wrapper's host time counts beside a
  ~40 µs kernel).
* :func:`query`: an entry that writes one int (blocks per SM, shared memory,
  a cooperative grid), checked.
* :func:`launch`: a launch on a device, checked.
* The launch geometry (``THREADS``, :func:`grid_for`) and the kernels'
  shared limits (``VEC_BYTES``, :func:`aligned`, :func:`max_rows`,
  :func:`run_rows`), and :func:`dot_ticket`, the counter of the in-launch
  sum shared by every kernel that sums in its launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re

import torch

from . import _build

__all__ = ["library", "prototypes", "raw_stream", "on_device", "query",
           "launch", "grid_for", "aligned", "check_out", "max_rows",
           "run_rows", "dot_ticket", "THREADS", "VEC_BYTES", "INDEX_SLACK"]

# threads a block (csrc/common.cuh kThreads)
THREADS = 256
# bytes of one vector load or store (csrc/common.cuh kVecBytes)
VEC_BYTES = 16
# the kernels' indices are 32-bit: rows, windows (a run and one vector past
# it) and the grid-stride loop's run index stay below 2^31 for
# n + span + INDEX_SLACK < 2^31 (a grid of at most 2^16 blocks)
INDEX_SLACK = 2**24

_PROTOTYPE = re.compile(r'extern\s+"C"\s+([\w\s*]+?)\s*\b(\w+)\s*\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


@functools.lru_cache(maxsize=None)
def prototypes(name: str) -> dict:
    """``{entry: argtypes}`` of every ``extern "C"`` prototype in
    ``csrc/<name>.cu``: a pointer as ``c_void_p``, ``int`` as ``c_int``,
    ``long long`` as ``c_longlong``.  Every entry returns ``int``; another
    return or parameter type raises."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out = {}
    for ret, entry, params in _PROTOTYPE.findall(src):
        if ret != "int":
            raise TypeError(f"{name}.cu: {entry} returns {ret!r}, not int")
        types = []
        for p in filter(None, (p.strip() for p in params.split(","))):
            if "*" in p:
                types.append(ctypes.c_void_p)
                continue
            typ = " ".join(w for w in p.split()[:-1] if w != "const")
            if typ not in _SCALARS:
                raise TypeError(f"{name}.cu: {entry} takes {p!r}, which has "
                                f"no ctypes type here")
            types.append(_SCALARS[typ])
        out[entry] = types
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """``_build.load(name)`` with every entry's ``argtypes`` from
    :func:`prototypes` and an ``int`` ``restype``, once per process.

    The one hook for an experiment's variant of a library (a copy of the
    source built with other ``-D`` flags, the same prototypes): in a fresh
    process, set ``_build.load`` to a loader that returns the variant for
    ``name``, then ``library.cache_clear()``, before the first launch."""
    lib = _build.load(name)
    for entry, argtypes in prototypes(name).items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, without building a
    Stream object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device):
    """The context in which a C call launches on ``device``: none where it
    is the current device already (the common case, and the cheap one)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def query(fn, *args, device) -> int:
    """``fn(*args, &out)`` of a kernel library on ``device``: the int the
    entry writes (blocks of a kernel one SM holds, a block's shared memory,
    a cooperative grid); raises on a non-zero return."""
    out = ctypes.c_int(0)
    with on_device(device):
        err = fn(*args, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed (error {err})")
    return out.value


def launch(entry, *args, device, what):
    """``entry(*args)`` on ``device``; raises on a non-zero return (the
    launch's CUDA error code, or -1 for arguments the entry refuses)."""
    with on_device(device):
        err = entry(*args)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed (error {err})")


@functools.lru_cache(maxsize=None)
def dot_ticket(device, stream: int) -> torch.Tensor:
    """The counter of the kernels' in-launch sum on ``device``'s stream
    ``stream`` (a raw handle, :func:`raw_stream`): blocks draw tickets from
    it and the last one sets it back to 0.  One per device and stream,
    shared by every kernel that sums in its launch (stencil, DIA, the CG
    step): launches on one stream run one at a time, and launches that may
    overlap draw from tickets of their own.  Kept for the process, since
    the launch plans hold its address."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_for(blocks_per_sm: int, device, n: int, rows: int) -> int:
    """Blocks of ``THREADS`` threads for ``n`` rows in runs of ``rows``:
    as many as the SMs hold at once (``blocks_per_sm`` each), or fewer where
    n needs fewer; a grid-stride loop covers the rest."""
    runs = -(-n // rows)
    return max(1, min(-(-runs // THREADS),
                      max(1, blocks_per_sm) * _sm_count(device)))


def aligned(*items) -> int:
    """1 where every tensor or address starts on a ``VEC_BYTES`` boundary
    (the kernels' vector path; else they take their per-row loads), else
    0."""
    acc = 0
    for p in items:
        acc |= p if type(p) is int else p.data_ptr()
    return int(acc % VEC_BYTES == 0)


def check_out(out, x):
    """``out``, checked to be a contiguous tensor like x that a launch may
    write its result into."""
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like x")
    return out


def max_rows(span: int) -> int:
    """The largest n the stencil, DIA and CG step kernels take with offsets
    up to ``span``: 32-bit indices (``INDEX_SLACK``)."""
    return 2**31 - 1 - INDEX_SLACK - span


def run_rows(dtype) -> int:
    """Elements of ``dtype`` in one 16-byte vector (4 for f32, 8 for bf16,
    16 for int8): the rows a thread of the DIA kernel takes for diagonals of
    ``dtype``."""
    return VEC_BYTES // torch.empty((), dtype=dtype).element_size()
