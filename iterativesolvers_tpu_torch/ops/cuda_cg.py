"""The vector work of a CG step on a real f32 solve vector: the CUDA kernels'
wrappers and their plain PyTorch versions.

The kernels are ``csrc/cg_step.cu``.  They replace no TPU kernel: the JAX
package's CG step (``iterativesolvers_tpu/solvers/cg.py`` ``_cg_step``) is
one XLA fusion around its product.  ``solvers/cg.py`` takes them for a
contiguous 1-D f32 solve vector (:func:`takes`), on any operator, on one
card or on a mesh; around the operator's ``mv_dot``, whose launch stays as
it is:

    cg_rho        rho = <c, r>                        (preconditioned only)
    cg_direction  beta = rho / rho_prev;  u' = c + beta u
    cg_update     alpha = rho / sigma;  x' = x + alpha u';  r' = r - alpha c'
                  |r'|^2 reduced in the launch; on one card also the next
                  residual, iteration count and log slot

Without a preconditioner ``cg_direction`` takes ``rho = residual^2`` of the
state (``square=True``), the reference's unpreconditioned recurrence, so the
step reduces nothing before its product.  Every scalar stays on the device
(0-d tensors in and out): no host read, and the launches may be captured in
a CUDA graph.  Masked by the 0-d bool ``live``: where it is false the
outputs are the inputs' bits (copies).

A CUDA tensor launches the kernel, counted in the wrapper's ``.launches``; a
CPU tensor takes the plain version (``*_plain``), which computes the same
roundings (module ``csrc/cg_step.cu``'s comment) and sums in the kernels'
order (:func:`kernel_sum`) on a grid of its own (:func:`plain_grid`).  Given
a launch's grid, a plain version on the card gives the launch's bits.  What
does not change from call to call (the grids, the blocks' partial sums, the
ticket of the in-launch sum) is kept per n, device and stream
(:func:`launch_plan`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ._launch import (THREADS, aligned, dot_ticket, grid_for, launch,
                      library, max_rows, query, raw_stream)

__all__ = ["takes", "cg_rho", "cg_direction", "cg_update", "cg_rho_plain",
           "cg_direction_plain", "cg_update_plain", "kernel_sum",
           "plain_grid", "launch_plan", "RUN"]

# rows a thread takes at once (csrc/cg_step.cu kRun)
RUN = 4
# the grid of the plain version on the CPU: 8 blocks on each of an H100
# SXM's 132 SMs, as the kernels' occupancy gives there
PLAIN_BLOCKS = 8 * 132
# kernel_of's order in csrc/cg_step.cu
_RHO, _DIRECTION, _UPDATE = range(3)


def takes(*vectors) -> bool:
    """Whether a CG step on these vectors takes this module's route: each
    a contiguous 1-D f32 tensor of one length on a CUDA card or the CPU.
    It reads only what a tensor holds (dtype, dim, numel, get_device): a
    step's host time counts beside ~50 µs kernels."""
    v0 = vectors[0]
    if not (v0.is_cuda or v0.is_cpu):
        return False
    n, index = v0.numel(), v0.get_device()
    for v in vectors:
        if (v.dtype is not torch.float32 or v.dim() != 1 or v.numel() != n
                or not v.is_contiguous() or v.get_device() != index):
            return False
    return True


def plain_grid(n: int) -> int:
    """The grid the plain version sums on where none is given: as many
    blocks as n's runs fill, at most ``PLAIN_BLOCKS``."""
    runs = -(-int(n) // RUN)
    return max(1, min(-(-runs // THREADS), PLAIN_BLOCKS))


def _shuffle_tree(v):
    """Lane 0 of a warp's ``__shfl_down_sync`` tree over the last axis (32
    lanes): lane l adds lane l + o for o = 16, 8, 4, 2, 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _block_sum(v):
    """``common.cuh``'s ``block_sum`` over the last axis (``THREADS``
    values): each warp's tree, then the tree of the warp sums in the first
    warp, its other lanes 0."""
    w = _shuffle_tree(v.reshape(v.shape[:-1] + (THREADS // 32, 32)))
    return _shuffle_tree(torch.cat(
        [w, w.new_zeros(w.shape[:-1] + (32 - w.shape[-1],))], dim=-1))


def kernel_sum(p, grid: int):
    """The sum of the f32 products ``p`` (1-D) in the kernels' order on
    ``grid`` blocks: thread t of block b adds the rows of runs j = b
    THREADS + t + m grid THREADS (m = 0, 1, ...) of RUN rows each, in row
    order, from 0; each block's ``_block_sum``; then thread t of the last
    block adds partials t, t + THREADS, ... from 0, and ``_block_sum``.
    A 0-d tensor on p's device."""
    n, grid = p.shape[0], int(grid)
    span = grid * THREADS * RUN
    steps = max(1, -(-n // span))
    q = p.new_zeros(steps * span)
    q[:n] = p
    q = q.view(steps, grid, THREADS, RUN)
    local = p.new_zeros(grid, THREADS)
    for m in range(steps):
        for e in range(RUN):
            local = local + q[m, :, :, e]
    parts = _block_sum(local)
    rows = -(-grid // THREADS)
    pp = p.new_zeros(rows * THREADS)
    pp[:grid] = parts
    v = p.new_zeros(THREADS)
    for row in pp.view(rows, THREADS):
        v = v + row
    return _block_sum(v)


def cg_rho_plain(c, r, grid=None):
    """<c, r> of two f32 vectors, summed in the kernels' order."""
    return kernel_sum(c * r, plain_grid(c.shape[0]) if grid is None else grid)


def cg_direction_plain(c, u, rho_src, rho_prev, live, *, square=False):
    """``(u', rho')``: rho = ``rho_src``^2 (``square``) or ``rho_src``,
    u' = c + (rho / rho_prev) u where ``live``, else u; rho' = rho where
    ``live``, else ``rho_prev``."""
    rho = rho_src * rho_src if square else rho_src
    u2 = torch.where(live, c + (rho / rho_prev) * u, u)
    return u2, torch.where(live, rho, rho_prev)


def cg_update_plain(x, u, r, c, rho, sigma, live, residual=None, k=None,
                    log=None, grid=None):
    """With alpha = rho / sigma: x' = x + alpha u (one rounding) and r' =
    r - (alpha c) (the product rounded first) where ``live``, else x and r.
    Returns ``(x', r', |r'|^2)`` (the sum in the kernels' order on
    ``grid``); with
    ``residual``, ``k`` and ``log``, ``(x', r', residual', k')``, where
    residual' = sqrt(|r'|^2) and ``log``'s slot min(max(k, 0), len - 1)
    takes it (in place), and k' = k + 1, where ``live``; else residual and
    k."""
    alpha = torch.where(live, rho / sigma, 0.0)
    x2 = torch.where(live, torch.addcmul(x, alpha, u), x)
    r2 = torch.where(live, r - alpha * c, r)
    rr = kernel_sum(r2 * r2, plain_grid(r.shape[0]) if grid is None else grid)
    if residual is None:
        return x2, r2, rr
    # f64's square root rounded to f32: the correctly rounded f32 one
    res = torch.where(live, torch.sqrt(rr.double()).float(), residual)
    slot = k.clamp(min=0, max=log.shape[0] - 1).reshape(1)
    kept = log.index_select(0, slot)[0]
    log.index_put_((slot,), torch.where(live, res, kept).reshape(1))
    return x2, r2, res, k + live.to(k.dtype)


class Plan(NamedTuple):
    """A launch's constant part on one device and stream: each kernel's
    grid (rho, direction, update), the blocks' partial sums (``partials``,
    by address in ``partials_ptr``), a float past them where the one-card
    update leaves its sum (``sum_ptr``), the stream's ticket, and a 0-d f32
    tensor on the device, the template of the 0-d outputs."""

    grids: tuple
    partials_ptr: int
    sum_ptr: int
    ticket: int
    partials: torch.Tensor
    scalar: torch.Tensor


@functools.lru_cache(maxsize=None)
def launch_plan(n, device, stream) -> Plan:
    """The :class:`Plan` for n rows on ``device``'s stream ``stream`` (a
    raw handle): as many blocks as the SMs hold, from each kernel's
    occupancy; one partial a block of the largest grid, shared by the two
    launches that sum (a stream runs one at a time), and the stream's
    ticket (``_launch.dot_ticket``).  Kept for the process: a captured
    graph holds their addresses."""
    if n > max_rows(0):
        raise ValueError(f"n = {n} is too large for 32-bit row indices")
    fn = library("cg_step").its_cg_blocks_per_sm
    grids = tuple(grid_for(query(fn, w, device=device), device, n, RUN)
                  for w in (_RHO, _DIRECTION, _UPDATE))
    partials = torch.empty(max(grids) + 1, dtype=torch.float32, device=device)
    ptr = partials.data_ptr()
    return Plan(grids, ptr, ptr + 4 * max(grids),
                dot_ticket(device, stream).data_ptr(), partials,
                torch.empty((), dtype=torch.float32, device=device))


def _vectors(*vectors):
    """``(n, card index or -1 for the CPU)`` of the vectors, checked by
    :func:`takes`."""
    if not takes(*vectors):
        raise ValueError("the CG step kernels take contiguous 1-D f32 "
                         "vectors of one length on one device")
    return vectors[0].numel(), vectors[0].get_device()


# the dtypes of each launch's 0-d inputs, in the order of its C call: the
# direction's rho source, rho_prev and live; the update's rho, sigma and
# live, and on one card the residual and the count
_DIRECTION_SCALARS = (torch.float32, torch.float32, torch.bool)
_UPDATE_SCALARS = (torch.float32, torch.float32, torch.bool, torch.float32,
                   torch.int64)


def _scalars(index, dtypes, *scalars):
    """The addresses of ``scalars``, each checked: a 0-d tensor of its
    entry of ``dtypes`` on card ``index``."""
    ptrs = []
    for t, dtype in zip(scalars, dtypes):
        if t.dim() or t.dtype is not dtype or t.get_device() != index:
            raise ValueError(f"a 0-d {dtype} tensor on cuda:{index} "
                             f"expected, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def cg_rho(c, r):
    """<c, r> as a 0-d f32 tensor (module docstring)."""
    n, index = _vectors(c, r)
    if index < 0:
        return cg_rho_plain(c, r)
    dev = c.device
    stream = raw_stream(dev)
    plan = launch_plan(n, dev, stream)
    out = torch.empty_like(plan.scalar)
    cp, rp = c.data_ptr(), r.data_ptr()
    launch(library("cg_step").its_cg_rho, cp, rp, plan.partials_ptr,
           plan.ticket, out.data_ptr(), n, plan.grids[_RHO], aligned(cp, rp),
           stream, device=dev, what="CG rho")
    cg_rho.launches += 1
    return out


def cg_direction(c, u, rho_src, rho_prev, live, *, square=False):
    """``(u', rho')`` of :func:`cg_direction_plain`, by one launch on a
    CUDA tensor."""
    n, index = _vectors(c, u)
    if index < 0:
        return cg_direction_plain(c, u, rho_src, rho_prev, live,
                                  square=square)
    dev = u.device
    stream = raw_stream(dev)
    plan = launch_plan(n, dev, stream)
    src, prev, on = _scalars(index, _DIRECTION_SCALARS, rho_src, rho_prev,
                             live)
    out = torch.empty_like(u)
    rho = torch.empty_like(plan.scalar)
    cp, up, op = c.data_ptr(), u.data_ptr(), out.data_ptr()
    launch(library("cg_step").its_cg_direction, cp, up, op, src, int(square),
           prev, on, rho.data_ptr(), n, plan.grids[_DIRECTION],
           aligned(cp, up, op), stream, device=dev, what="CG direction")
    cg_direction.launches += 1
    return out, rho


def cg_update(x, u, r, c, rho, sigma, live, residual=None, k=None, log=None):
    """What :func:`cg_update_plain` returns, by one launch on a CUDA tensor;
    ``log`` (a contiguous 1-D f32 tensor) is written in place."""
    n, index = _vectors(x, u, r, c)
    if index < 0:
        return cg_update_plain(x, u, r, c, rho, sigma, live, residual, k, log)
    dev = x.device
    stream = raw_stream(dev)
    plan = launch_plan(n, dev, stream)
    if residual is None:
        scalars = _scalars(index, _UPDATE_SCALARS, rho, sigma, live)
        rr = torch.empty_like(plan.scalar)
        tail = (rr.data_ptr(), None, None, None, None, None, 0)
    else:
        rho_p, sigma_p, live_p, res_p, k_p = _scalars(
            index, _UPDATE_SCALARS, rho, sigma, live, residual, k)
        scalars = (rho_p, sigma_p, live_p)
        if (log.dtype is not torch.float32 or log.dim() != 1
                or not log.is_contiguous() or log.get_device() != index):
            raise ValueError("the log must be a contiguous 1-D f32 tensor "
                             "on the vectors' card")
        res, k2 = torch.empty_like(plan.scalar), torch.empty_like(k)
        tail = (plan.sum_ptr, res_p, res.data_ptr(), k_p, k2.data_ptr(),
                log.data_ptr(), log.numel())
    x2, r2 = torch.empty_like(x), torch.empty_like(r)
    ptrs = (x.data_ptr(), u.data_ptr(), r.data_ptr(), c.data_ptr(),
            x2.data_ptr(), r2.data_ptr())
    launch(library("cg_step").its_cg_update, *ptrs, *scalars,
           plan.partials_ptr, plan.ticket, *tail, n, plan.grids[_UPDATE],
           aligned(*ptrs), stream, device=dev, what="CG update")
    cg_update.launches += 1
    if residual is None:
        return x2, r2, rr
    return x2, r2, res, k2


cg_rho.launches = 0
cg_direction.launches = 0
cg_update.launches = 0
