"""Multi-device distribution: row-partitioned operators over a 1-D mesh of
ranks (port of ``iterativesolvers_tpu/parallel/sharded.py``).

Process model.  The JAX package runs one controller that sees every device,
and ``shard_map`` runs a per-shard body for each.  Here each rank is its own
process under ``torch.distributed``: it holds its block of rows of every
length-n vector as a plain local tensor on its device, and the small solver
state (Hessenberg, Givens, scalars) replicated.  Everything that crosses
ranks goes through the :class:`RowMesh`: the allreduces of the solvers' dots
and norms (``solvers/common.norm`` / ``vdot`` take ``op.mesh``) and the halo
exchange of the operators' products.  No ``DTensor``: the kernels take raw
pointers, and every collective of a step is written out where it happens.

Row blocks: rank r owns rows ``[r * nloc, min((r + 1) * nloc, n))`` with
``nloc = ceil(n / D)``; the halo and ELL operators need ``n % D == 0``,
``DenseMeshOperator`` takes any n (the last blocks short or empty).

Every name of the JAX module is here, and ``gather_vector`` (the
counterpart of ``np.asarray`` on a sharded JAX array) besides.  A 2-D
``(slice, chip)`` mesh (:func:`slice_mesh`) partitions rows over the
flattened slice-major rank order, as the JAX one does, and reduces in two
levels: within each slice, then across the slices.

``shard_dia`` / ``shard_ell``.  The JAX package places a DIA or ELL
matrix's arrays row-sharded under GSPMD and lets XLA partition the ordinary
product: the shifted reads of a DIA product lower to collective-permutes,
the gather of an ELL product to an all-gather of x
(``tests/test_hlo_collectives.py``).  The result is still a ``DIAMatrix`` /
``ELLMatrix`` and works wherever one does.  ``torch.distributed`` has no
partitioner, so here they return :class:`RowShardedDIAMatrix` and
:class:`RowShardedELLOperator`, subclasses of the port's ``DIAMatrix`` and
``ELLMatrix`` that hold this rank's rows and issue those collectives
themselves: a DIA product fetches the ranges of x its offsets read from the
ranks that own them (:meth:`RowMesh.fetch`, any number of blocks away, any
rectangular shape), an ELL product all-gathers x.  What the JAX package
hands back whole (``diagonal()``, ``to_csr()``, ``to_dense()``, ``data``)
every rank gets whole, by one gather; a route that needs a whole vector (a
global triangular sweep) gathers it once and keeps this rank's rows of the
result.  Where D does not divide n (and m) the JAX package's ``device_put``
raises ``ValueError`` (an uneven ``NamedSharding``), and so do they.
:class:`HaloDIAOperator` stays the port of the JAX package's explicit halo
operator, which refuses a halo wider than a block as that one does.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..operators.linear_operator import LinearOperator
from ..operators.sparse import DIAMatrix, ELLMatrix
from ..operators.stencil import StencilOperator, _conj
from ..ops.cuda_spmv import (dia_spmv, dia_spmv_dot, dia_spmv_plain,
                             dia_spmv_rows)
from ..ops.cuda_stencil import stencil_apply, stencil_apply_rows
from ..utils.convert import host_tensor
from ..utils.dtypes import as_dtype
from ..utils.profiling import span

__all__ = [
    "RowMesh",
    "SliceMesh",
    "row_mesh",
    "slice_mesh",
    "shard_vector",
    "shard_dia",
    "shard_ell",
    "replicate",
    "gather_vector",
    "HaloDIAOperator",
    "HaloStencilOperator",
    "RowShardedELLOperator",
    "DenseMeshOperator",
]

# the collectives a mesh issues, counted by kind in ``RowMesh.counts``
COLLECTIVES = ("exchange", "fetch", "all_reduce", "all_gather",
               "reduce_scatter")
# and the replays of captured steps (``solvers/common.StepGraphs``): the
# graphs launched and the steps they ran
REPLAYS = ("replay", "replay_steps")

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# moved as bytes by the all-gather (gloo has no such element type)
_AS_BYTES = (torch.bfloat16, torch.int8, torch.bool)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def row_block(n: int, D: int, rank: int):
    """``(lo, hi)``: the global rows of ``rank``'s block of an n-vector over
    D ranks (``nloc = ceil(n / D)`` rows each; the last blocks are shorter,
    or empty, when D does not divide n)."""
    nloc = -(-int(n) // int(D))
    lo = min(rank * nloc, n)
    return lo, min(lo + nloc, n)


def _merge(intervals):
    """The union of half-open ``(lo, hi)`` intervals as disjoint maximal
    ones, ascending."""
    out = []
    for u, v in sorted(intervals):
        if out and u <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], v))
        else:
            out.append((u, v))
    return out


class FetchPlan:
    """Which ranges of a source vector each rank of a DIA product reads
    outside its own block, and from whom.

    The product's output rows are partitioned as an ``n_out``-vector over
    D ranks, its source as an ``n_src``-vector (``row_block``); output row
    i reads source entry ``i + s`` for each ``shift`` s, and nothing
    outside ``[0, n_src)``.  ``need[r]`` holds the maximal ranges rank r
    reads outside its own source block; ``parts(r, s)`` the pieces of them
    that rank s owns.  Everything follows from ``(n_out, n_src, D,
    shifts)``, so every rank knows what every other rank needs."""

    def __init__(self, n_out: int, n_src: int, D: int, shifts):
        self.n_out, self.n_src, self.D = int(n_out), int(n_src), int(D)
        self.shifts = tuple(sorted({int(s) for s in shifts}))
        self.need = [self._need(r) for r in range(self.D)]

    def src_block(self, r):
        return row_block(self.n_src, self.D, r)

    def _need(self, r):
        a, b = row_block(self.n_out, self.D, r)
        lo, hi = self.src_block(r)
        ivs = []
        for s in self.shifts:
            u, v = max(a + s, 0), min(b + s, self.n_src)
            if u < min(v, lo):
                ivs.append((u, min(v, lo)))
            if max(u, hi) < v:
                ivs.append((max(u, hi), v))
        return _merge(ivs)

    def owners(self, u, v):
        """The ranks whose source blocks meet ``[u, v)``, ascending."""
        nloc = -(-self.n_src // self.D)
        return range(u // nloc, min((v - 1) // nloc, self.D - 1) + 1)

    def parts(self, r, s):
        """The pieces of ``need[r]`` in rank s's source block, ascending."""
        lo, hi = self.src_block(s)
        return [(max(u, lo), min(v, hi)) for u, v in self.need[r]
                if max(u, lo) < min(v, hi)]

    def volume(self, r):
        """Entries rank r receives a product."""
        return sum(v - u for u, v in self.need[r])


class RowMesh:
    """A 1-D mesh of ranks over the row-partition axis: the default process
    group of ``torch.distributed`` with this rank's ``rank``, the number of
    ranks ``size`` (the JAX mesh's D), this rank's ``device`` and the
    ``backend`` the caller chose.  Made by :func:`row_mesh`."""

    def __init__(self, rank: int, size: int, device, backend: str,
                 owns_group: bool = False):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self._owns_group = owns_group
        # collectives issued, by kind (COLLECTIVES); a one-rank mesh issues
        # none.  utils/profiling.collective_counts reads them over a window.
        # A replayed graph adds the collectives it holds, and counts itself
        # and its steps (REPLAYS).
        self.counts = dict.fromkeys(COLLECTIVES + REPLAYS, 0)

    def __repr__(self):
        return (f"RowMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    def rows(self, n: int):
        """``(lo, hi)``: this rank's global rows of a length-n vector."""
        return row_block(n, self.size, self.rank)

    def all_reduce(self, t, op: str = "sum"):
        """Reduce ``t`` over the ranks in place (``op`` "sum" or "max");
        returns ``t``.  Every rank gets the same bits, so replicated state
        computed from the result agrees across ranks."""
        if self.size > 1:
            self.counts["all_reduce"] += 1
            with span("its.allreduce"):
                dist.all_reduce(t, op=_REDUCE_OPS[op])
        return t

    def _host(self, t):
        """The tensor the transport takes: gloo moves no CUDA tensor in a
        send, receive or gather, so on gloo a CUDA tensor is copied to the
        host; the compute stays on the card.  NCCL takes it as it is."""
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type == "cuda":
            return t.cpu()
        return t

    def exchange(self, first, last):
        """The halo exchange (``ppermute`` over the ring in the JAX package):
        this rank sends ``last`` (its last rows) to the next rank and
        ``first`` to the previous one, and returns ``(left, right)``: the
        previous rank's ``last`` and the next rank's ``first``, wrapping
        around at the ends as the JAX ring does (the operators mask what
        wraps).  On a gloo mesh the slabs travel through host buffers
        (``_host``) while the compute stays on the card: gloo has no GPU
        send or receive.  The backend is the caller's choice, never a
        reaction to a failure."""
        if self.size == 1:
            return last, first
        self.counts["exchange"] += 1
        nxt = (self.rank + 1) % self.size
        prv = (self.rank - 1) % self.size
        with span("its.exchange"):
            s_last, s_first = self._host(last), self._host(first)
            left, right = torch.empty_like(s_last), torch.empty_like(s_first)
            ops = [dist.P2POp(dist.isend, s_last, nxt, tag=0),
                   dist.P2POp(dist.isend, s_first, prv, tag=1),
                   dist.P2POp(dist.irecv, left, prv, tag=0),
                   dist.P2POp(dist.irecv, right, nxt, tag=1)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return left.to(last.device), right.to(first.device)

    def all_gather(self, t):
        """``t`` of every rank, in rank order (equal shapes on all ranks),
        on ``t``'s device.  Types that gloo does not reduce (bfloat16, int8,
        bool) travel as their bytes."""
        if self.size == 1:
            return [t]
        if t.dtype in _AS_BYTES:
            return [o.view(t.dtype) for o in self.all_gather(
                t.contiguous().view(torch.uint8))]
        self.counts["all_gather"] += 1
        src = self._host(t)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src)
        return [o.to(t.device) for o in out]

    def gather_rows(self, t, axis: int = 0):
        """The whole vector (or panel along ``axis``) from every rank's
        equal-sized block ``t``: one all-gather (``all_gather(tiled=True)``
        in the JAX package)."""
        return torch.cat(self.all_gather(t), dim=axis)

    def fetch(self, t, plan: "FetchPlan", axis: int = 0):
        """The ranged fetch of a DIA product: this rank's block ``t`` of a
        vector (or panel along ``axis``) partitioned as ``plan.n_src``
        gives every rank the ranges of it that ``plan`` says that rank
        reads outside its own block, from whichever ranks own them, in one
        ``batch_isend_irecv``: each rank sends each other rank one buffer,
        the ranges it needs from this block in order, each range once.
        Every rank derives every other rank's ranges from the plan, so no
        sizes travel.  Returns this rank's ``[(lo, hi, values)]``, the
        maximal global ranges it reads outside its block, ascending (what
        GSPMD's collective-permutes move for the JAX package's
        ``DIAMatrix.mv``).  On gloo a CUDA tensor travels through host
        buffers (``_host``)."""
        if self.size == 1:
            return []
        self.counts["fetch"] += 1
        me, own = self.rank, plan.src_block(self.rank)
        ops = []
        for r in range(self.size):
            parts = plan.parts(r, me)
            if r != me and parts:
                buf = self._host(torch.cat(
                    [t.narrow(axis, u - own[0], v - u) for u, v in parts],
                    dim=axis))
                ops.append(dist.P2POp(dist.isend, buf, r))
        recv = {}
        host = self.backend == "gloo" and t.device.type == "cuda"
        for s in range(self.size):
            parts = plan.parts(me, s)
            if s != me and parts:
                shape = list(t.shape)
                shape[axis] = sum(v - u for u, v in parts)
                recv[s] = torch.empty(shape, dtype=t.dtype,
                                      device="cpu" if host else t.device)
                ops.append(dist.P2POp(dist.irecv, recv[s], s))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        at = dict.fromkeys(recv, 0)
        out = []
        for u, v in plan.need[me]:
            segs = []
            for s in plan.owners(u, v):
                a, b = plan.src_block(s)
                w = min(v, b) - max(u, a)
                segs.append(recv[s].narrow(axis, at[s], w))
                at[s] += w
            out.append((u, v, torch.cat(segs, dim=axis).to(t.device)))
        return out

    def reduce_scatter(self, t):
        """Sum ``t`` (``size * nloc`` rows along axis 0, the same shape on
        every rank) over the ranks and return this rank's block of ``nloc``
        rows: one reduce-scatter (``psum_scatter(tiled=True)`` in the JAX
        package).  On gloo a CUDA tensor goes through a host buffer."""
        if self.size == 1:
            return t
        if t.shape[0] % self.size:
            raise ValueError(f"{t.shape[0]} rows do not split over "
                             f"{self.size} ranks")
        self.counts["reduce_scatter"] += 1
        src = self._host(t)
        out = src.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, src)
        return out.to(t.device)

    def close(self):
        """Destroy the process group if :func:`row_mesh` created it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


class SliceMesh(RowMesh):
    """A 2-D ``(slice, chip)`` mesh of ``n_slices * chips_per_slice``
    ranks: rank ``r = s * chips_per_slice + c`` is chip c of slice s, so row
    blocks are slice-major and the halo ring is the 1-D ring over the ranks
    in order (one hop across a slice boundary per slice pair).  A sum runs
    in two levels, as XLA decomposes the JAX package's reduction over
    ``(slice, chip)``: within the slice (the ranks of one s), then across
    the slices (the ranks of one c).  Every rank ends with the same bits:
    the first level leaves one value per slice on all its ranks, and each
    second-level group sums those same values in the same order.  Made by
    :func:`slice_mesh`; gathers and reduce-scatters run over all ranks."""

    def __init__(self, rank, size, device, backend, n_slices,
                 chips_per_slice, chip_group, slice_group, owns_group=False):
        super().__init__(rank, size, device, backend, owns_group)
        self.n_slices = int(n_slices)
        self.chips_per_slice = int(chips_per_slice)
        self._chip_group = chip_group
        self._slice_group = slice_group
        # the all-reduces of each level (counts["all_reduce"] holds both)
        self.level_counts = {"chip": 0, "slice": 0}

    @property
    def shape(self):
        return (self.n_slices, self.chips_per_slice)

    def __repr__(self):
        return (f"SliceMesh(rank={self.rank}, shape={self.shape}, "
                f"device={self.device}, backend={self.backend!r})")

    def all_reduce(self, t, op: str = "sum"):
        for level, group, width in (("chip", self._chip_group,
                                     self.chips_per_slice),
                                    ("slice", self._slice_group,
                                     self.n_slices)):
            if width > 1:
                self.counts["all_reduce"] += 1
                self.level_counts[level] += 1
                dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
        return t


def _init_group(backend, device, init_method, rank, world_size, timeout):
    """The default process group (created here unless it exists, then
    owned), this rank, the world size and this rank's device."""
    owns = False
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=float(timeout)))
        owns = True
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    r, D = dist.get_rank(), dist.get_world_size()
    if device is None:
        device = torch.device("cuda", r % max(torch.cuda.device_count(), 1))
    device = torch.device(device)
    # fail here, not at the first product, when the device does not exist
    torch.empty(0, device=device)
    return owns, r, D, device


def row_mesh(backend: str, device=None, *, init_method: str = "env://",
             rank: int | None = None, world_size: int | None = None,
             timeout: float = 300.0) -> RowMesh:
    """The 1-D mesh over every rank of ``torch.distributed``'s default
    process group, created here (with ``init_method``, ``rank``,
    ``world_size`` and ``timeout`` seconds, after which a hung collective
    raises) unless it exists.

    ``backend``: ``"nccl"`` when every rank has its own card, ``"gloo"``
    when ranks share a card (NCCL refuses two ranks on one card) or run on
    the CPU.  ``device``: where this rank's tensors live; by default the
    card ``rank % device_count``."""
    owns, r, D, device = _init_group(backend, device, init_method, rank,
                                     world_size, timeout)
    return RowMesh(r, D, device, backend, owns_group=owns)


def slice_mesh(n_slices: int, chips_per_slice: int | None = None,
               backend: str = "gloo", device=None, *,
               init_method: str = "env://", rank: int | None = None,
               world_size: int | None = None,
               timeout: float = 300.0) -> SliceMesh:
    """The 2-D ``(slice, chip)`` mesh (:class:`SliceMesh`) over every rank
    of the default process group, made as :func:`row_mesh` makes it; its
    world must hold ``n_slices * chips_per_slice`` ranks
    (``chips_per_slice`` defaults to world // n_slices).  Each level's
    groups carry the same ``timeout``."""
    owns, r, D, device = _init_group(backend, device, init_method, rank,
                                     world_size, timeout)
    S = int(n_slices)
    C = int(chips_per_slice) if chips_per_slice is not None else D // S
    if S < 1 or C < 1 or S * C != D:
        raise ValueError(f"a ({S}, {C}) slice mesh needs {S * C} ranks, the "
                         f"process group has {D}")
    td = datetime.timedelta(seconds=float(timeout))
    chip_group = slice_group = None
    # every rank makes every group, in the same order
    for s in range(S):
        g = dist.new_group([s * C + c for c in range(C)], timeout=td)
        if r // C == s:
            chip_group = g
    for c in range(C):
        g = dist.new_group([s * C + c for s in range(S)], timeout=td)
        if r % C == c:
            slice_group = g
    return SliceMesh(r, D, device, backend, S, C, chip_group, slice_group,
                     owns_group=owns)


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else host_tensor(v)


def shard_vector(v, mesh: RowMesh):
    """This rank's block of rows of the length-n vector ``v`` (a tensor or
    host array), copied to the mesh's device."""
    t = _as_tensor(v)
    lo, hi = row_block(t.shape[0], mesh.size, mesh.rank)
    return t[lo:hi].to(mesh.device, copy=True)


def shard_dia(A: DIAMatrix, mesh: RowMesh) -> "RowShardedDIAMatrix":
    """A DIA matrix row-sharded on the mesh (the JAX package's
    ``shard_dia``): the :class:`RowShardedDIAMatrix` of ``A``, each rank
    its rows of the diagonals on its device, any offsets, square or
    rectangular.  ``ValueError`` where D does not divide both dimensions."""
    return RowShardedDIAMatrix.from_whole(A, mesh)


def shard_ell(A: ELLMatrix, mesh: RowMesh) -> "RowShardedELLOperator":
    """An ELL matrix row-sharded on the mesh (with its adjoint, if it
    carries one): the :class:`RowShardedELLOperator` of ``A``, whose product
    all-gathers x as XLA does for the JAX package's GSPMD form.
    ``ValueError`` where D does not divide both dimensions."""
    return RowShardedELLOperator(A, mesh)


def replicate(x, mesh: RowMesh):
    """The whole of ``x`` on this rank's device (small replicated state)."""
    return _as_tensor(x).to(mesh.device, copy=True)


def gather_vector(v_loc, mesh: RowMesh):
    """The whole vector from every rank's block (each rank gets it): the
    counterpart of ``np.asarray`` on a row-sharded JAX array, for tests and
    checks, not for the solvers' steps."""
    lens = mesh.all_gather(torch.tensor([v_loc.shape[0]], device=v_loc.device))
    lens = [int(n) for n in lens]
    pad = max(lens)
    buf = v_loc.new_zeros((pad,) + tuple(v_loc.shape[1:]))
    buf[: v_loc.shape[0]] = v_loc
    parts = mesh.all_gather(buf)
    return torch.cat([p[:n] for p, n in zip(parts, lens)])


class _MeshOperator(LinearOperator):
    """An operator whose vectors are row blocks over ``self.mesh``: its
    shape is global, its products act on this rank's block, and its
    ``mv_dot`` reduces the dot over the mesh."""

    @property
    def device(self):
        return self.mesh.device

    def mv_dot(self, x):
        y = self.mv(x)
        return y, self.mesh.all_reduce(torch.sum(x.conj() * y))


def _check_even(shape, D):
    if shape[0] % D or shape[1] % D:
        raise ValueError(f"shape {tuple(shape)} must divide evenly over {D} "
                         "devices")


def _window(t, lo, pieces, u, v):
    """Global entries ``[u, v)`` of a row-partitioned vector (or panel
    along axis 0) from this rank's block ``t`` (rows from ``lo``) and the
    fetched ``pieces``; 0 where neither holds them (outside the vector)."""
    out = t.new_zeros((v - u,) + tuple(t.shape[1:]))
    for a, b, vals in [(lo, lo + t.shape[0], t), *pieces]:
        p, q = max(a, u), min(b, v)
        if p < q:
            out[p - u:q - u] = vals[p - a:q - a]
    return out


class RowShardedDIAMatrix(_MeshOperator, DIAMatrix):
    """A DIA matrix whose diagonals are row-sharded over a mesh: the JAX
    package's ``shard_dia`` result, which is a ``DIAMatrix`` and works
    wherever one does, so this is a :class:`DIAMatrix` too.

    Rank r holds rows ``[r n/D, (r+1) n/D)`` of every diagonal (``diags``)
    on the mesh's device; a product's x is its block of the m columns, y
    its block of the n rows, and any offsets and any (n, m) with D dividing
    both are taken.  A product fetches the ranges of x its offsets read
    outside the rank's block (:meth:`RowMesh.fetch`, one batch of sends and
    receives, from any number of blocks away) and computes the rest from
    the block alone: on a square matrix with a 1-D f32 x and f32, bf16 or
    int8 diagonals that interior is the DIA kernel on the block
    (``dia_spmv`` / ``dia_spmv_dot`` / ``dia_spmv_rows``, which read 0
    outside it, as ``DIAMatrix`` dispatches), on anything else its plain
    version; diagonals with no read inside the block stay out of it.  The
    fetched reads are added after (the boundary terms), and ``mv_dot``
    adds their share to the kernel's dot of the interior before the
    all-reduce.  ``rmv`` is the product of the adjoint, a row-sharded DIA
    matrix of offsets ``-o`` built at the first call (one fetch a
    diagonal).  ``diagonal()``, ``to_csr()``, ``to_dense()``, ``data`` and
    :meth:`unsharded` are whole on every rank (one all-gather);
    ``astype`` stays sharded."""

    def __init__(self, diags, offsets, shape, mesh: RowMesh):
        n, m = int(shape[0]), int(shape[1])
        D = mesh.size
        _check_even((n, m), D)
        self.mesh = mesh
        self._shape = (n, m)
        self.offsets = tuple(int(o) for o in offsets)
        self.diags = tuple(_as_tensor(d).to(mesh.device).contiguous()
                           for d in diags)
        self.n_local, self.m_local = n // D, m // D
        if any(d.shape != (self.n_local,) for d in self.diags):
            raise ValueError(f"each diagonal needs this rank's {self.n_local}"
                             " rows")
        self.row_lo = mesh.rank * self.n_local
        self.col_lo = mesh.rank * self.m_local
        self._plan = FetchPlan(n, m, D, self.offsets)
        # the block's own offsets, and the diagonals that read inside it
        shift = self.row_lo - self.col_lo
        self._inner = tuple((k, off + shift)
                            for k, off in enumerate(self.offsets)
                            if -self.n_local < off + shift < self.m_local)
        self._adjoint = None

    @classmethod
    def from_whole(cls, A: DIAMatrix, mesh: RowMesh):
        """This rank's rows of the whole matrix ``A`` (on any device)."""
        _check_even(A.shape, mesh.size)
        lo, hi = mesh.rows(A.shape[0])
        return cls([d[lo:hi].to(mesh.device, copy=True) for d in A.diags],
                   A.offsets, A.shape, mesh)

    # -- whole on every rank ---------------------------------------------------
    def unsharded(self) -> DIAMatrix:
        """The whole matrix on this rank's device: one all-gather."""
        whole = self.mesh.gather_rows(torch.stack(self.diags, dim=1))
        return DIAMatrix(list(whole.T), self.offsets, self._shape,
                         device=self.device)

    @property
    def data(self):
        """(ndiag, n), whole (one all-gather)."""
        return self.unsharded().data

    def diagonal(self):
        """(main diagonal, ``d != 0``) whole on every rank (one all-gather of
        the main diagonal), as ``DIAMatrix.diagonal``."""
        if 0 not in self.offsets:
            return DIAMatrix.diagonal(self)
        d = self.mesh.gather_rows(self.diags[self.offsets.index(0)])
        d = d[:min(self._shape)]
        return d, d != 0

    def to_csr(self):
        return self.unsharded().to_csr()

    def to_dense(self):
        return self.unsharded().to_dense()

    def astype(self, dtype) -> "RowShardedDIAMatrix":
        """This rank's diagonals in ``dtype``, still sharded (no
        collective)."""
        dt = as_dtype(dtype)
        return RowShardedDIAMatrix([d.to(dt) for d in self.diags],
                                   self.offsets, self._shape, self.mesh)

    # -- products -------------------------------------------------------------
    def _interior(self, x, u=None, rows=False):
        """The block's own product (reads outside it 0): the DIA kernel's
        wrappers (their plain version on a CPU tensor) where ``DIAMatrix``
        would take them, else ``dia_spmv_plain``; with ``u`` the kernel's
        ``(y, <u, y>)``; ``rows``: x is a (k, m_local) panel for
        ``dia_spmv_rows``."""
        ds = [self.diags[k] for k, _ in self._inner]
        offs = [o for _, o in self._inner]
        if not ds:
            dt = torch.promote_types(self.dtype, x.dtype)
            shape = ((x.shape[0], self.n_local) if rows
                     else (self.n_local,) + tuple(x.shape[1:]))
            y = torch.zeros(shape, dtype=dt, device=x.device)
            return (y, y.new_zeros(())) if u is not None else y
        if rows:
            return dia_spmv_rows(ds, offs, x)
        if self._use_kernel(x):
            if u is not None:
                return dia_spmv_dot(ds, offs, x, u)
            return dia_spmv(ds, offs, x)
        return dia_spmv_plain(ds, offs, x)

    def _add_fetched(self, y, pieces, axis=0, u=None):
        """Add each diagonal's reads of the fetched ``pieces`` to y (rows
        along ``axis``); with ``u``, returns ``<u, the additions>``."""
        dot = None
        for d, off in zip(self.diags, self.offsets):
            a = self.row_lo + off
            for p, q, t in pieces:
                lo, hi = max(a, p), min(a + self.n_local, q)
                if lo >= hi:
                    continue
                dd = d[lo - a:hi - a].to(y.dtype)
                if y.ndim == 2:
                    dd = dd[:, None] if axis == 0 else dd[None, :]
                delta = dd * t.narrow(axis, lo - p, hi - lo)
                y.narrow(axis, lo - a, hi - lo).add_(delta)
                if u is not None:
                    part = torch.sum(u.narrow(axis, lo - a, hi - lo).conj()
                                     * delta)
                    dot = part if dot is None else dot + part
        return dot

    def mv(self, x):
        pieces = self.mesh.fetch(x, self._plan)
        y = self._interior(x)
        self._add_fetched(y, pieces)
        return y

    def mv_dot(self, x):
        if not self._use_kernel(x):
            return super().mv_dot(x)
        pieces = self.mesh.fetch(x, self._plan)
        y, dot = self._interior(x, u=x)
        extra = self._add_fetched(y, pieces, u=x)
        if extra is not None:
            dot = dot + extra
        return y, self.mesh.all_reduce(dot)

    def mv_rows(self, Xr):
        """Row-panel product of the (k, m_local) panel ``Xr``: one fetch of
        the panel's column ranges, the kernel once a row on the block
        (``dia_spmv_rows``) where ``DIAMatrix`` takes it, else the product
        of the columns ``Xr.T``."""
        if not self._use_kernel(Xr, ndim=2):
            return self.mv(Xr.T).T
        pieces = self.mesh.fetch(Xr, self._plan, axis=1)
        Y = self._interior(Xr, rows=True)
        self._add_fetched(Y, pieces, axis=1)
        return Y

    def _adjoint_matrix(self) -> "RowShardedDIAMatrix":
        """A^H as a row-sharded DIA matrix: diagonal ``-o`` holds
        ``conj(A[j - o, j])`` at row j, this rank's rows fetched once a
        diagonal."""
        if self._adjoint is None:
            n, m = self._shape
            a, b = self.mesh.rows(m)
            diags = []
            for d, off in zip(self.diags, self.offsets):
                pieces = self.mesh.fetch(d, FetchPlan(m, n, self.mesh.size,
                                                      (-off,)))
                diags.append(_window(d, self.row_lo, pieces, a - off,
                                     b - off).conj())
            self._adjoint = RowShardedDIAMatrix(
                diags, [-o for o in self.offsets], (m, n), self.mesh)
        return self._adjoint

    def rmv(self, x):
        return self._adjoint_matrix().mv(x)


def _halo_slices(mesh, x, halo):
    """(left, right) halos of x's row block: the exchange over the mesh, or
    the block's own ends (``x[-halo:]``, ``x[:halo]``) on one rank, as the
    JAX package takes them there."""
    if mesh.size > 1:
        return mesh.exchange(x[:halo], x[-halo:])
    return x[x.shape[0] - halo:], x[:halo]


def _halo_rows(mesh, Xr, halo):
    """(left, right) halos of a (k, n_local) row panel: its (k, halo) edge
    slabs in one exchange (each direction one message for all k rows)."""
    n_local = Xr.shape[1]
    if mesh.size > 1:
        return mesh.exchange(Xr[:, :halo], Xr[:, n_local - halo:])
    return Xr[:, n_local - halo:], Xr[:, :halo]


class HaloDIAOperator(_MeshOperator):
    """Row-partitioned DIA SpMV with an explicit halo exchange.

    Each rank owns ``n_local = n / D`` rows of the diagonals and of every
    vector.  A product exchanges the ``halo`` boundary entries of x with the
    neighbouring ranks (``RowMesh.exchange``), computes the interior from
    the local block alone (zero-padded shifted multiply-adds) and adds the
    halo values as |offset|-sized boundary corrections.  Values that wrap
    around the ring at the global boundary meet structurally zero diagonal
    entries.  The interior is plain PyTorch, as in the JAX package (XLA
    there, no Pallas kernel).

    ``dia`` is the port's :class:`DIAMatrix` of the whole matrix, on any
    device; each rank keeps its rows on the mesh's device.  The diagonals'
    own halos, which ``rmv`` needs, are exchanged once here (the JAX package
    permutes them in every ``rmv``).
    """

    def __init__(self, dia: DIAMatrix, mesh: RowMesh):
        n, m = dia.shape
        if n != m:
            raise ValueError("HaloDIAOperator requires a square operator")
        D = mesh.size
        if n % D != 0:
            raise ValueError(f"n={n} must divide evenly over {D} devices")
        n_local = n // D
        halo = max((abs(o) for o in dia.offsets), default=0)
        if halo > n_local:
            raise ValueError(
                f"stencil halo {halo} exceeds local block {n_local}; "
                "use fewer devices or a larger problem")
        self.mesh = mesh
        self.halo = halo
        self.n_local = n_local
        self.offsets = dia.offsets
        self._shape = dia.shape
        lo = mesh.rank * n_local
        self.diags = tuple(d[lo:lo + n_local].to(mesh.device, copy=True)
                           for d in dia.diags)
        self._data_halos = ([_halo_slices(mesh, d, halo) for d in self.diags]
                            if halo else None)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.diags[0].dtype

    def _padded(self, x):
        z = x.new_zeros((self.halo,) + tuple(x.shape[1:]))
        return torch.cat([z, x, z])

    def mv(self, x):
        halo, n_local = self.halo, self.n_local
        col = (lambda d: d) if x.ndim == 1 else (lambda d: d[:, None])
        if halo:
            left, right = _halo_slices(self.mesh, x, halo)
        # interior: the local block alone, halo slots zero-padded
        xz = self._padded(x)
        y = torch.zeros_like(x)
        for d, off in zip(self.diags, self.offsets):
            y = y + col(d) * xz[halo + off:halo + off + n_local]
        # boundary corrections from the exchanged halos
        for d, off in zip(self.diags, self.offsets):
            if off < 0:
                y[:-off] += col(d[:-off]) * left[halo + off:]
            elif off > 0:
                y[n_local - off:] += col(d[n_local - off:]) * right[:off]
        return y

    def mv_rows(self, Xr):
        """Row-panel product: ``Xr`` is (k, n_local), this rank's columns of
        k vectors as rows.  The same algebra as ``mv`` on the minor axis,
        with one exchange of the (k, halo) edge slabs."""
        halo, n_local = self.halo, self.n_local
        if halo:
            left, right = _halo_rows(self.mesh, Xr, halo)
        z = Xr.new_zeros((Xr.shape[0], halo))
        xz = torch.cat([z, Xr, z], dim=1)
        Y = torch.zeros_like(Xr)
        for d, off in zip(self.diags, self.offsets):
            Y = Y + d * xz[:, halo + off:halo + off + n_local]
        for d, off in zip(self.diags, self.offsets):
            if off < 0:
                Y[:, :-off] += d[:-off] * left[:, halo + off:]
            elif off > 0:
                Y[:, n_local - off:] += d[n_local - off:] * right[:, :off]
        return Y

    def rmv(self, x):
        # (A^H x)[i] = sum_o conj(A[i - o, i]) x[i - o]
        #            = sum_o conj(data[o, i - o]) x[i - o]
        halo, n_local = self.halo, self.n_local
        col = (lambda d: d) if x.ndim == 1 else (lambda d: d[:, None])
        if halo:
            left, right = _halo_slices(self.mesh, x, halo)
        xz = self._padded(x)
        y = torch.zeros_like(x)
        for d, off in zip(self.diags, self.offsets):
            dz = self._padded(d)
            y = y + (col(dz[halo - off:halo - off + n_local]).conj()
                     * xz[halo - off:halo - off + n_local])
        for (dl, dr), off in zip(self._data_halos or (), self.offsets):
            if off > 0:
                y[:off] += col(dl[halo - off:]).conj() * left[halo - off:]
            elif off < 0:
                y[n_local + off:] += col(dr[:-off]).conj() * right[:-off]
        return y


class HaloStencilOperator(_MeshOperator):
    """Row-partitioned matrix-free stencil SpMV with an explicit halo
    exchange: the distributed form of :class:`StencilOperator`.

    Shard-edge validity must be decidable locally, so every (offset,
    stride, extent) term must satisfy one of (checked here; both hold for
    the natural outermost-axis split of a regular grid):

    * ``stride*extent`` divides ``n_local``: the term's Dirichlet mask is
      periodic and shard-aligned, identical on every rank;
    * ``n_local`` divides ``stride*extent``: extent boundaries coincide
      with shard boundaries, so in-shard reads are always on-grid and the
      global mask is needed only for the halo-sized edge corrections.

    A real 1-D f32 / bf16 x takes the whole product of the rank's rows in
    the stencil kernel's halo form (``stencil_apply`` with ``base``,
    ``n_global`` and the exchanged planes), which masks each row as its
    global row and reads the planes where a column leaves the block: one
    launch on a card, its plain version on the CPU; ``mv_dot`` allreduces
    its dot.  That is the bits of the whole vector's one-card product, row
    for row.

    Other x (other dtypes, 2-D x) and ``mv_rows`` take the eager route
    (``_eager``): the local interior (every contribution from the rank's own
    rows, reads outside the block zero) comes first, the port's stencil
    kernel on the block, ``n = n_local``, for a real f32 / bf16 panel (the
    JAX package runs its Pallas kernel per shard with ``stencil_plan(n_local,
    ...)``), whose local masks give the global ones inside the block under
    the two rules above, and the JAX package's masked shifted slices
    otherwise; then the edge corrections from the planes under the global
    Dirichlet mask (``_edge_terms``), added after the interior's sum.
    ``mv_dot`` adds their share to the interior's ``<x, Ax>`` and
    allreduces it.

    :meth:`capturable` says whether a solve's steps on this operator may be
    captured in a CUDA graph and replayed (``solvers/common.StepGraphs``).
    """

    def __init__(self, st: StencilOperator, mesh: RowMesh):
        if not isinstance(st, StencilOperator):
            raise TypeError("HaloStencilOperator wraps a StencilOperator")
        n = st.n
        D = mesh.size
        if n % D != 0:
            raise ValueError(f"n={n} must divide evenly over {D} devices")
        n_local = n // D
        halo = max((abs(o) for (o, _, _) in st.terms), default=0)
        if halo > n_local:
            raise ValueError(
                f"stencil halo {halo} exceeds local block {n_local}; "
                "use fewer devices or a larger problem")
        for (off, s, e) in st.terms:
            span = s * e
            if not (n_local % span == 0 or span % n_local == 0):
                raise ValueError(
                    f"term (off={off}, stride={s}, extent={e}): span {span} "
                    f"must divide or be a multiple of n_local={n_local} so "
                    "shard-edge validity is locally decidable (split along "
                    "the grid's outermost axis)")
        self.mesh = mesh
        self.halo = halo
        self.n_local = n_local
        self.n = n
        self.terms = st.terms
        self.center = st.center
        self.coeffs = st.coeffs
        self._dtype = st.dtype
        self._edges = {}

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def _stencil(self, conj):
        """(center, [(off, stride, extent)], coeffs) of A or of A^H."""
        cj = _conj if conj else (lambda c: c)
        eff = tuple((-o if conj else o, s, e) for (o, s, e) in self.terms)
        return cj(self.center), eff, tuple(cj(c) for c in self.coeffs)

    def _edge_terms(self, conj):
        """Per off-diagonal term ``(off, coeff, valid)``: the global
        Dirichlet mask at the |off| edge rows of this rank's block, fixed
        for the operator and so computed once."""
        if conj not in self._edges:
            _, eff, cs = self._stencil(conj)
            base = self.mesh.rank * self.n_local
            out = []
            for (off, s, e), c in zip(eff, cs):
                if off == 0:
                    continue
                rows = (np.arange(-off) if off < 0
                        else self.n_local - off + np.arange(off))
                pos = ((base + rows) // s) % e + off // s
                valid = torch.from_numpy((pos >= 0) & (pos < e))
                out.append((off, c, valid.to(self.device)))
            self._edges[conj] = out
        return self._edges[conj]

    def _local_interior(self, eff, cs, center, x_loc, with_dot=False):
        """Shard-local stencil, out-of-range reads zero (halo corrections
        are added separately): the stencil kernel on the block for a real
        1-D f32 / bf16 x, masked shifted slices otherwise.  With
        ``with_dot`` returns ``(y, <x, y>)``."""
        n_local, halo = self.n_local, self.halo
        if (x_loc.ndim == 1 and x_loc.dtype in _KERNEL_DTYPES
                and not self._dtype.is_complex):
            return stencil_apply(n_local, center, eff, cs, x_loc,
                                 with_dot=with_dot)
        x_loc = x_loc.to(torch.promote_types(self._dtype, x_loc.dtype))
        i = torch.arange(n_local, device=x_loc.device)
        z = x_loc.new_zeros((halo,) + tuple(x_loc.shape[1:]))
        xz = torch.cat([z, x_loc, z])
        y = center * x_loc
        for (off, s, e), c in zip(eff, cs):
            shifted = xz[halo + off:halo + off + n_local]
            if s * e <= n_local:
                # shard-aligned periodic mask (identical on every shard)
                p = (i // s) % e + off // s
                valid = (p >= 0) & (p < e)
                valid = valid if x_loc.ndim == 1 else valid[:, None]
                y = y + torch.where(valid, c * shifted, 0)
            else:
                # extent boundaries are shard boundaries: every in-shard
                # read is on-grid, off-grid reads fell into the zero padding
                y = y + c * shifted
        if with_dot:
            return y, torch.sum(x_loc.conj() * y)
        return y

    def _kernel_dtype(self, dtype) -> bool:
        """Whether vectors of ``dtype`` take the halo form (one launch of
        the kernel on a card, its plain version on the CPU)."""
        return (self.halo > 0 and dtype in _KERNEL_DTYPES
                and not self._dtype.is_complex)

    def _folds(self, x) -> bool:
        """Whether a product of ``x`` is the halo form."""
        return x.ndim == 1 and self._kernel_dtype(x.dtype)

    def capturable(self, dtype) -> bool:
        """A mesh of several cards over NCCL (whose collectives a capture
        takes) and products that are the halo form's one launch, with no
        host read and no host-side state."""
        mesh = self.mesh
        return (mesh.size > 1 and mesh.backend == "nccl"
                and mesh.device.type == "cuda"
                and self._kernel_dtype(as_dtype(dtype)))

    def _apply(self, x, conj: bool, with_dot: bool = False):
        if not self._folds(x):
            return self._eager(x, conj, with_dot)
        n_local = self.n_local
        center, eff, cs = self._stencil(conj)
        left, right = _halo_slices(self.mesh, x, self.halo)
        out = stencil_apply(n_local, center, eff, cs, x, with_dot=with_dot,
                            base=self.mesh.rank * n_local, n_global=self.n,
                            left=left, right=right)
        if with_dot:
            return out[0], self.mesh.all_reduce(out[1])
        return out

    def _eager(self, x, conj: bool, with_dot: bool = False):
        """The product as the local interior, then the edge corrections
        (``_edge_terms``): the route of every x the halo form does not
        take."""
        halo, n_local = self.halo, self.n_local
        center, eff, cs = self._stencil(conj)
        if halo:
            left, right = _halo_slices(self.mesh, x, halo)
        out = self._local_interior(eff, cs, center, x, with_dot)
        y, dot = out if with_dot else (out, None)
        # boundary corrections: |off|-sized adds from the exchanged halos,
        # gated on the global Dirichlet mask at the edge rows
        for off, c, valid in self._edge_terms(conj):
            valid = valid if x.ndim == 1 else valid[:, None]
            if off < 0:
                delta = torch.where(valid, c * left[halo + off:], 0)
                y[:-off] += delta
                xr = x[:-off]
            else:
                delta = torch.where(valid, c * right[:off], 0)
                y[n_local - off:] += delta
                xr = x[n_local - off:]
            if with_dot:
                dot = dot + torch.sum(xr.conj() * delta)
        if with_dot:
            return y, self.mesh.all_reduce(dot)
        return y

    def mv(self, x):
        return self._apply(x, conj=False)

    def rmv(self, x):
        return self._apply(x, conj=True)

    def mv_dot(self, x):
        return self._apply(x, conj=False, with_dot=True)

    def mv_rows(self, Xr):
        """Row-panel product: ``Xr`` is (k, n_local), this rank's columns of
        k vectors as rows.  One exchange of the (k, halo) edge slabs; the
        interior is the stencil kernel once a row on the local block
        (``stencil_apply_rows`` with ``n = n_local``) for a real f32 / bf16
        panel, the masked shifted slices otherwise; then the edge
        corrections under the global Dirichlet mask (``_edge_terms``)."""
        halo, n_local = self.halo, self.n_local
        center, eff, cs = self._stencil(False)
        if halo:
            left, right = _halo_rows(self.mesh, Xr, halo)
        if Xr.dtype in _KERNEL_DTYPES and not self._dtype.is_complex:
            Y = stencil_apply_rows(n_local, center, eff, cs, Xr)
        else:
            Y = self._local_interior(eff, cs, center, Xr.T).T
        for off, c, valid in self._edge_terms(False):
            if off < 0:
                Y[:, :-off] += torch.where(valid, c * left[:, halo + off:], 0)
            else:
                Y[:, n_local - off:] += torch.where(valid, c * right[:, :off],
                                                    0)
        return Y.contiguous()


class RowShardedELLOperator(_MeshOperator, ELLMatrix):
    """Row-partitioned product of an unstructured ELL matrix: the JAX
    package's ``shard_ell`` result (an ``ELLMatrix`` whose panels are
    row-sharded), so an :class:`ELLMatrix` too.

    A row block may read any entry of x, so ``mv`` all-gathers x (one
    collective) and runs the ELL product of this rank's rows (``local``,
    the eager ``ELLMatrix`` gather, sum and product).  A rectangular (m, n)
    operator takes x sharded by its n columns and gives y sharded by its m
    rows; both must divide over the ranks.  ``rmv`` is the product of the
    row-sharded precomputed adjoint (``adj``, from
    ``ELLMatrix.with_adjoint``), or without one sums this rank's rows'
    contributions into a full-length partial and reduce-scatters it: one
    reduce-scatter, never an all-reduce of the whole output.  ``data`` and
    ``cols`` are this rank's rows; ``to_csr``, ``to_dense`` and
    :meth:`unsharded` whole on every rank (an all-gather of each panel);
    ``astype``, ``with_chunked_gather`` and ``with_adjoint`` stay sharded.

    ``ell`` is the port's :class:`ELLMatrix` of the whole matrix, on any
    device; each rank keeps its rows on the mesh's device.
    """

    def __init__(self, ell: ELLMatrix, mesh: RowMesh):
        _check_even(ell.shape, mesh.size)
        adj = (RowShardedELLOperator(ell.adj, mesh) if ell.adj is not None
               else None)
        self._set(mesh, ell.shape, self._rows_of(ell, mesh), adj)

    def _set(self, mesh, shape, local, adj):
        self.mesh = mesh
        self._shape = (int(shape[0]), int(shape[1]))
        self.local = local
        self.adj = adj
        # this rank's rows of the adjoint (the product ``rmv`` runs)
        self.local_adj = adj.local if adj is not None else None
        return self

    def _with(self, local, adj) -> "RowShardedELLOperator":
        return object.__new__(RowShardedELLOperator)._set(
            self.mesh, self._shape, local, adj)

    @staticmethod
    def _rows_of(ell, mesh):
        lo, hi = mesh.rows(ell.shape[0])
        return ELLMatrix(ell.data[lo:hi], ell.cols[lo:hi],
                         (hi - lo, ell.shape[1]),
                         gather_chunk_rows=ell._gather_chunk_rows,
                         device=mesh.device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def data(self):
        return self.local.data

    @property
    def cols(self):
        return self.local.cols

    @property
    def _gather_chunk_rows(self):
        return self.local._gather_chunk_rows

    @property
    def row_width(self):
        return self.local.row_width

    def unsharded(self) -> ELLMatrix:
        """The whole matrix (and its adjoint) on this rank's device: an
        all-gather of each panel."""
        adj = self.adj.unsharded() if self.adj is not None else None
        return ELLMatrix(self.mesh.gather_rows(self.data),
                         self.mesh.gather_rows(self.cols), self._shape,
                         adj=adj, gather_chunk_rows=self._gather_chunk_rows,
                         device=self.device)

    def to_csr(self):
        return self.unsharded().to_csr()

    def to_dense(self):
        return self.unsharded().to_dense()

    def astype(self, dtype) -> "RowShardedELLOperator":
        adj = self.adj.astype(dtype) if self.adj is not None else None
        return self._with(self.local.astype(dtype), adj)

    def with_chunked_gather(self, chunk_rows: int) -> "RowShardedELLOperator":
        adj = (self.adj.with_chunked_gather(chunk_rows)
               if self.adj is not None else None)
        return self._with(self.local.with_chunked_gather(chunk_rows), adj)

    def with_adjoint(self) -> "RowShardedELLOperator":
        """A copy carrying the row-sharded adjoint: the whole matrix's
        ``with_adjoint`` (its CSR on the host, as one device builds it),
        each rank keeping its rows of it."""
        if self.adj is not None:
            return self
        whole = self.unsharded().with_adjoint()
        return self._with(self.local, RowShardedELLOperator(whole.adj,
                                                            self.mesh))

    def mv(self, x):
        return self.local.mv(self.mesh.gather_rows(x))

    def rmv(self, x):
        if self.adj is not None:
            return self.adj.mv(x)
        return self.mesh.reduce_scatter(self.local.rmv(x))


class DenseMeshOperator(_MeshOperator):
    """A dense square matrix row-partitioned over the mesh at any n.

    The halo and ELL operators need ``n % D == 0``; this one takes the
    :func:`row_block` split, ``nloc = ceil(n / D)`` rows a rank with the
    last blocks short (or empty), so it carries the mesh-operator contract
    where D does not divide n.  Its role, as in the JAX package, is the
    sharded-panel GMRES route's zero-padded last shard
    (``panel_ortho.panel_layout``).  ``mv`` all-gathers x (each block padded
    to ``nloc``) and multiplies this rank's rows; ``rmv`` multiplies the
    adjoint of this rank's rows into a full-length partial and
    reduce-scatters the partials.
    """

    def __init__(self, mat, mesh: RowMesh):
        mat = _as_tensor(mat)
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError("DenseMeshOperator requires a square matrix")
        n = int(mat.shape[0])
        self.mesh = mesh
        self._n = n
        self.nloc = -(-n // mesh.size)
        lo, hi = mesh.rows(n)
        self.mat = mat[lo:hi].to(mesh.device, copy=True)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.mat.dtype

    def _pad(self, x, rows):
        if x.shape[0] == rows:
            return x
        z = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
        return torch.cat([x, z])

    def mv(self, x):
        xg = self.mesh.gather_rows(self._pad(x, self.nloc))[: self._n]
        return self.mat @ xg

    def rmv(self, x):
        part = self.mat.conj().T @ x
        full = self._pad(part, self.nloc * self.mesh.size)
        return self.mesh.reduce_scatter(full)[: self.mat.shape[0]]
