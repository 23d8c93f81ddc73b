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
(``tests/test_hlo_collectives.py``).  ``torch.distributed`` has no
partitioner, so here they return the operators that issue exactly those
collectives, :class:`HaloDIAOperator` and :class:`RowShardedELLOperator`;
the ordinary solvers take them unchanged.  Where D does not divide n the
JAX package's ``device_put`` raises ``ValueError`` (an uneven
``NamedSharding``), and so do they.  One case differs: a DIA halo wider
than a rank's block, which GSPMD partitions and ``HaloDIAOperator``
refuses (``ValueError``: use fewer ranks).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..operators.linear_operator import LinearOperator
from ..operators.sparse import DIAMatrix, ELLMatrix
from ..operators.stencil import StencilOperator, _conj
from ..ops.cuda_stencil import stencil_apply, stencil_apply_rows
from ..utils.convert import host_tensor

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
COLLECTIVES = ("exchange", "all_reduce", "all_gather", "reduce_scatter")

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def row_block(n: int, D: int, rank: int):
    """``(lo, hi)``: the global rows of ``rank``'s block of an n-vector over
    D ranks (``nloc = ceil(n / D)`` rows each; the last blocks are shorter,
    or empty, when D does not divide n)."""
    nloc = -(-int(n) // int(D))
    lo = min(rank * nloc, n)
    return lo, min(lo + nloc, n)


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
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def __repr__(self):
        return (f"RowMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    def rows(self, n: int):
        """``(lo, hi)``: this rank's global rows of a length-n vector."""
        return row_block(n, self.size, self.rank)

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns ``t``.  Every rank
        gets the same bits, so replicated state computed from the result
        agrees across ranks."""
        if self.size > 1:
            self.counts["all_reduce"] += 1
            dist.all_reduce(t)
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
        on ``t``'s device."""
        if self.size == 1:
            return [t]
        self.counts["all_gather"] += 1
        src = self._host(t)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src)
        return [o.to(t.device) for o in out]

    def gather_rows(self, t):
        """The whole vector (or row panel along axis 0) from every rank's
        equal-sized block ``t``: one all-gather (``all_gather(tiled=True)``
        in the JAX package)."""
        return torch.cat(self.all_gather(t))

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

    def all_reduce(self, t):
        for level, group, width in (("chip", self._chip_group,
                                     self.chips_per_slice),
                                    ("slice", self._slice_group,
                                     self.n_slices)):
            if width > 1:
                self.counts["all_reduce"] += 1
                self.level_counts[level] += 1
                dist.all_reduce(t, group=group)
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


def shard_dia(A: DIAMatrix, mesh: RowMesh) -> "HaloDIAOperator":
    """A DIA matrix row-sharded on the mesh, for the ordinary solvers: the
    :class:`HaloDIAOperator` of ``A``, whose product exchanges the halos as
    the collective-permutes XLA places for the JAX package's GSPMD form
    (module docstring).  ``ValueError`` where D does not divide n."""
    return HaloDIAOperator(A, mesh)


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

    The local interior (every contribution from the rank's own rows, reads
    outside the block zero) is the port's stencil kernel on the block,
    ``stencil_apply`` with ``n = n_local`` (the JAX package runs its Pallas
    kernel per shard with ``stencil_plan(n_local, ...)``): the kernel reads
    0 outside ``[0, n_local)``, and its local masks give the global ones
    inside the block under the two rules above.  Other dtypes (f64,
    complex, 2-D x) take the JAX package's masked shifted slices.  ``mv_dot``
    takes the local ``<x, Ax>`` from the kernel's pass, adds the edge
    corrections' share and allreduces it.
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

    def _apply(self, x, conj: bool, with_dot: bool = False):
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


class RowShardedELLOperator(_MeshOperator):
    """Row-partitioned product of an unstructured ELL matrix.

    A row block may read any entry of x, so ``mv`` all-gathers x (one
    collective) and runs the ELL product of this rank's rows (the eager
    ``ELLMatrix`` gather, sum and product).  A rectangular (m, n) operator
    takes x sharded by its n columns and gives y sharded by its m rows; both
    must divide over the ranks.  ``rmv`` runs the same product on this
    rank's rows of the precomputed adjoint (``ELLMatrix.with_adjoint``), or
    without one sums its rows' contributions into a full-length partial and
    reduce-scatters it: one reduce-scatter, never an all-reduce of the
    whole output.

    ``ell`` is the port's :class:`ELLMatrix` of the whole matrix, on any
    device; each rank keeps its rows on the mesh's device.
    """

    def __init__(self, ell: ELLMatrix, mesh: RowMesh):
        m, n = ell.shape
        D = mesh.size
        if m % D != 0 or n % D != 0:
            raise ValueError(
                f"shape {tuple(ell.shape)} must divide evenly over {D} "
                "devices")
        self.mesh = mesh
        self._shape = (int(m), int(n))
        self.local = self._rows_of(ell)
        self.local_adj = (self._rows_of(ell.adj) if ell.adj is not None
                          else None)

    def _rows_of(self, ell):
        lo, hi = self.mesh.rows(ell.shape[0])
        return ELLMatrix(ell.data[lo:hi], ell.cols[lo:hi],
                         (hi - lo, ell.shape[1]),
                         gather_chunk_rows=ell._gather_chunk_rows,
                         device=self.mesh.device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.local.dtype

    def mv(self, x):
        return self.local.mv(self.mesh.gather_rows(x))

    def rmv(self, x):
        if self.local_adj is not None:
            return self.local_adj.mv(self.mesh.gather_rows(x))
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
