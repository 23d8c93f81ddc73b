"""Red-black IC(0) apply on a constant-coefficient stencil: the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel is ``csrc/rbic.cu``.  It replaces no TPU kernel: the JAX package
applies ``RedBlackICPreconditioner`` by XLA fusions of ``_shift_sum``
(``iterativesolvers_tpu/operators/preconditioners.py``).  It takes the
preconditioner that ``RedBlackICPreconditioner.from_stencil`` builds from an
f32 stencil on a nested grid (:func:`takes`: strides 1, e0, e0 e1, ..., n
their product), applied to a 1-D f32 CUDA x without a mesh.  With ``a_t``
the coefficient of term ``t = (o_t, stride, extent)``, ``m_t`` its grid mask
(the stencil's rule), ``s_r = 1/sqrt(center)`` and ``s_b`` the black pivot's
``1/sqrt``:

    pass 0:  w = x s_r                                         red rows
             w = ((x - sum_t m_t a_t ((x s_r) s_r)[i + o_t]) s_b) s_b   black
    pass 1:  z = (w - s_r sum_t m_t a_t w[i + o_t]) s_r        red rows
             z = w                                             black rows

which is the plain version :func:`rbic_apply_plain` operation for operation:
a valid term couples rows of two colours, so a black row's terms read red
rows and a red row's read black ones.  ``s_b`` depends only on which terms
are valid: :class:`RBICForm` holds a table of ``2**T`` scales by those bits,
``s_r`` after them, built on the device with the arithmetic that builds
``s_inv``, so that each entry has its bits (``from_stencil``).  The kernel
therefore reads no coefficient or mask stream.

:func:`rbic_apply` launches the kernel for a CUDA tensor or raises: both
passes in one C call, each launch checked, counted once an apply in
``rbic_apply.launches``.  The form keeps one launch plan (``RBICForm.plan``,
made at the first call): the grids, the packed terms and pass 0's output w,
reused by every apply on the stream it was made on.  The plain version takes
the eager apply's own arrays (the masked coefficient streams, ``s_inv`` and
the red mask): ``RedBlackICPreconditioner`` applies it to every x the kernel
does not take, CPU tensors among them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._launch import (aligned, grid_for, launch, library, max_rows, query,
                      raw_stream)
from .cuda_stencil import MAX_TERMS, STENCIL_RUN, grouped_terms

__all__ = ["RBICForm", "rbic_apply", "rbic_apply_plain", "shift_sum",
           "takes", "validity", "MAX_TERMS"]


def grid_axes(n, terms):
    """The (stride, extent) axes of ``terms`` in stride order where they nest
    (the first stride 1, each next the one before times its extent, n the
    last times its extent), else None."""
    axes = sorted({(s, e) for (_, s, e) in terms})
    stride = 1
    for s, e in axes:
        if s != stride:
            return None
        stride *= e
    return axes if axes and stride == n else None


def takes(n, terms, dtype) -> bool:
    """Whether the kernel takes the red-black IC(0) of the stencil ``terms``
    (unit steps, as ``from_stencil`` checks) on n rows in ``dtype``: f32, 2
    to ``MAX_TERMS`` terms on a nested grid, 32-bit row indices."""
    span = max((abs(o) for (o, _, _) in terms), default=0)
    return (dtype == torch.float32 and 2 <= len(terms) <= MAX_TERMS
            and grid_axes(n, terms) is not None and n <= max_rows(span))


def validity(n, terms, device):
    """(T, n) bool: where each term is valid, the stencil's grid rule (the
    masks of ``from_stencil``), in the terms' order."""
    i = torch.arange(n, device=device)
    out = []
    for o, s, e in terms:
        p = (i // s) % e + o // s
        out.append((p >= 0) & (p < e))
    return torch.stack(out) if out else torch.zeros((0, n), dtype=torch.bool,
                                                    device=device)


def shift_sum(offsets, streams, u, axis: int = 0):
    """``sum_o streams_o * shift(u, o)`` along ``axis`` (the length-n axis):
    ``acc[i] += streams_o[i] * u[i + o]`` where ``0 <= i + o < n``, term by
    term in the order of ``offsets``, each a multiply-add of slices into one
    accumulator of ``promote(u, streams)`` (the JAX package's one padded
    pass; reads past either end are its zero padding).  ``u`` is 1-D, or 2-D
    with the streams broadcast along the other axis.  The term sums of the
    plain version, of ``EisenstatSSOROperator`` and of ``RBReducedSystem``."""
    n = u.shape[axis]
    dt = torch.promote_types(u.dtype, streams[0].dtype)
    acc = torch.zeros(u.shape, dtype=dt, device=u.device)
    for o, c in zip(offsets, streams):
        lo, hi = max(0, -o), min(n, n - o)
        if hi <= lo:
            continue
        cc = c[lo:hi]
        if u.ndim == 2:
            cc = cc[:, None] if axis == 0 else cc[None, :]
        acc.narrow(axis, lo, hi - lo).addcmul_(
            cc, u.narrow(axis, lo + o, hi - lo))
    return acc


def rbic_apply_plain(offsets, mcs, s_inv, red, x, axis: int = 0):
    """z = M^{-1} x in plain PyTorch from the eager apply's arrays: the
    masked coefficient streams ``mcs`` of the terms at ``offsets``, the
    scales ``s_inv`` and the red mask ``red``; x 1-D, or 2-D along the
    length-n ``axis``.  The kernel's function, in promote(x, mcs)."""
    s = s_inv
    if x.ndim == 2:
        s, red = ((s[:, None], red[:, None]) if axis == 0
                  else (s[None, :], red[None, :]))
    # L solve: y_r = x_r s_r ; y_b = (x_b - sum_o a_o u[+o]) s_b with
    # u = y_r s_r at red slots (L_br = a_o s_r)
    u = torch.where(red, x * s * s, 0)
    y = torch.where(red, x * s, (x - shift_sum(offsets, mcs, u, axis)) * s)
    # L^T solve: z_b = y_b s_b ; z_r = (y_r - s_r sum_o a_o v[+o]) s_r
    # with v = z_b at black slots
    v = torch.where(red, 0, y * s)
    return torch.where(red, (y - s * shift_sum(offsets, mcs, v, axis)) * s,
                       y * s)


class RBICForm:
    """The constant-coefficient form of a red-black IC(0): n, the stencil's
    terms and f32 coefficients in their order, and ``scales``, the device
    table of ``2**T + 1`` scales (the black one by validity bits, bit t for
    term t, then the red one).  ``plan`` is the kernel's launch plan, made
    at the first call."""

    __slots__ = ("n", "terms", "coeffs", "scales", "plan")

    def __init__(self, n, terms, coeffs, scales):
        self.n = int(n)
        self.terms = tuple((int(o), int(s), int(e)) for (o, s, e) in terms)
        self.coeffs = tuple(float(c) for c in coeffs)
        self.scales = scales
        self.plan = None


class _Plan(NamedTuple):
    """A launch's constant part: each pass's grid, the packed terms (``buf``,
    by address in ``terms``), and pass 0's output ``w`` with the stream it
    serves (``stream``)."""

    grid0: int
    grid1: int
    terms: int
    buf: object
    stream: int
    w: torch.Tensor


def pack_args(form: RBICForm):
    """The arguments of ``its_rbic_pack_terms`` after the buffer: those of
    ``stencil.cuh``'s ``pack_terms`` for the terms, bit t for term t and
    the center's bit T above them, the sum's offsets sorted with the
    center's 0 (the kernel reads only their first and last, no
    coefficient); then the offsets and coefficients in the terms' order
    (ctypes arrays)."""
    T = len(form.terms)
    offs = [o for (o, _, _) in form.terms]
    return grouped_terms(form.terms, range(T)) + (
        T + 1, T, (ctypes.c_int * (T + 1))(*sorted(offs + [0])),
        (ctypes.c_float * (T + 1))(), (ctypes.c_int * T)(*offs),
        (ctypes.c_float * T)(*form.coeffs))


def _plan(form: RBICForm, x, stream) -> _Plan:
    lib = library("rbic")
    buf = ctypes.create_string_buffer(lib.its_rbic_terms_bytes())
    packed = pack_args(form)      # alive through the call
    args = [a if isinstance(a, int) else ctypes.addressof(a) for a in packed]
    if lib.its_rbic_pack_terms(buf, *args) != 0:
        raise ValueError("red-black IC(0) terms the kernel does not take")
    grid0, grid1 = (grid_for(query(lib.its_rbic_blocks_per_sm, p,
                                   device=x.device),
                             x.device, form.n, STENCIL_RUN) for p in (0, 1))
    return _Plan(grid0, grid1, ctypes.addressof(buf), buf, stream,
                 torch.empty_like(x, memory_format=torch.contiguous_format))


def rbic_apply(form: RBICForm, x):
    """z = M^{-1} x for the form of a red-black IC(0) and a contiguous 1-D
    f32 CUDA x on the form's device, by the kernel; see the module
    docstring."""
    if x.ndim != 1 or x.shape[0] != form.n:
        raise ValueError(f"x must have shape ({form.n},), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"the red-black IC(0) kernel takes f32 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"red-black IC(0) kernel runs on CUDA tensors, got "
                         f"{dev}")
    if dev != form.scales.device:
        raise ValueError(f"x lies on {dev}, the preconditioner on "
                         f"{form.scales.device}")
    stream = raw_stream(dev)
    plan = form.plan
    if plan is None:
        plan = form.plan = _plan(form, x, stream)
    # w is the plan's on its stream; another stream takes a w of its own
    w = plan.w if stream == plan.stream else torch.empty_like(x)
    z = torch.empty_like(x)
    # each pass's vector path: its input and output on 16-byte boundaries
    xp, wp, zp = x.data_ptr(), w.data_ptr(), z.data_ptr()
    launch(library("rbic").its_rbic_apply, xp, wp, zp, form.scales.data_ptr(),
           form.n, plan.grid0, plan.grid1, aligned(xp, wp), aligned(wp, zp),
           plan.terms, stream, device=dev, what="red-black IC(0)")
    rbic_apply.launches += 1
    return z


rbic_apply.launches = 0
