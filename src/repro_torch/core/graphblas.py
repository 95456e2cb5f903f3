"""High-level GraphBLAS matrix object: the generic operation API.

The torch twin of ``repro.core.graphblas.GraphMatrix`` for the mxv rows
and the mxm rows over graph, dense, ``FrontierBatch`` and ``BitMatrix``
operands, with the multi-source entry points ``msbfs`` and ``ppr``
(``engine``). A ``GraphMatrix`` holds, for each stored orientation (the
matrix and its transpose), the B2SR arrays and the float CSR baseline
twin, all on one device. ``mxv`` and ``mxm``
resolve the Table II/III row from the operand type and the semiring and
look the implementation up in ``repro_torch.core.dispatch`` under
``(op, rhs, out, backend, bucketed, masked, sharded)``; ``tri_count`` is
the ``mxm_sum`` row over the memoized strict lower triangle.

``backend`` selects the compute path:
  "b2sr"       torch word-level bit schemes (``repro_torch.core.ops``)
  "b2sr_cuda"  hand-written CUDA kernels (``repro_torch.kernels``); on a
               CPU graph the wrappers run their plain PyTorch versions
  "csr"        float CSR baseline (``repro_torch.core.csr``)

The ELL and bucketed views are built lazily, on the first ``b2sr`` row
that reads them, and cached per orientation (shared with the transposed
view). On skewed graphs the single-max ELL is far larger than the graph;
the CUDA kernels and the CSR baseline never build it. A matrix wrapped
from a B2SR (``from_b2sr``, every boolean ``mxm`` result) builds its CSR
twin the same way, from its tiles, on the first row that reads it.

``shard(mesh)`` row-partitions both orientations over a
:class:`~repro_torch.core.mesh.ShardMesh` (``core.partition``); every
operation of the sharded graph then resolves to the sharded rows
(``core.ops_sharded``), which launch each shard's kernel on its slot's
device and return the global result, so no caller changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core import b2sr as b2sr_mod
from repro_torch.core import csr as csr_mod
from repro_torch.core import descriptor as descriptor_mod
from repro_torch.core import dispatch
from repro_torch.core import partition as partition_mod
from repro_torch.core.b2sr import (B2SR, B2SRBucketedEll, B2SREll,
                                   combine_tiles, pack_bitvector)
from repro_torch.core.descriptor import _UNSET, Descriptor
from repro_torch.core.dispatch import OpCall
from repro_torch.core.operands import (BitVector, FrontierBatch,
                                      check_operand, operand_kind)
from repro_torch.core.semiring import ARITHMETIC, BOOLEAN, Semiring
from repro_torch.device import DeviceLike, resolve_device

BACKENDS = dispatch.BACKENDS


class Orientation:
    """One stored orientation: B2SR + CSR twin, with lazy ELL/bucketed
    views; without a CSR twin given, it is built from the tiles on first
    use."""

    def __init__(self, b2sr: B2SR, csr: Optional[csr_mod.CSRMatrix] = None):
        self.b2sr = b2sr
        self._csr = csr
        self.ell: Optional[B2SREll] = None
        self.buckets: Optional[B2SRBucketedEll] = None
        #: what the ``b2sr_cuda`` rows derive from ``b2sr`` once (the
        #: SpMM kernels' work items), by key
        self.cache: Dict[str, Any] = {}

    @property
    def csr(self) -> csr_mod.CSRMatrix:
        if self._csr is None:
            m = self.b2sr
            rows, cols = b2sr_mod.b2sr_to_coo(m)
            self._csr = csr_mod.from_coo(rows, cols, m.n_rows, m.n_cols,
                                         device=m.device)
        return self._csr

    def get_ell(self) -> B2SREll:
        if self.ell is None:
            self.ell = b2sr_mod.to_ell(self.b2sr)
        return self.ell

    def get_buckets(self) -> B2SRBucketedEll:
        if self.buckets is None:
            self.buckets = b2sr_mod.to_bucketed(self.b2sr)
        return self.buckets


class LowerTriangle:
    """Memoized strict-lower-triangle operand of ``tri_count`` (L, Lᵀ).

    The split (``row > col``) is taken from the CSR twin on its device.
    L's B2SR is built when asked for (at once for ``b2sr_cuda``, whose
    kernel reads L three ways: as A, as the mask and as Bᵀ); the ELL views
    of L and Lᵀ and the bucketed view only for the ``b2sr`` rows, the CSR
    only for ``csr``.
    """

    def __init__(self, csr: csr_mod.CSRMatrix, tile_dim: int, n: int,
                 build_b2sr: bool = False):
        keep = csr.row_idx > csr.col_idx
        self.rows = csr.row_idx[keep].long()
        self.cols = csr.col_idx[keep].long()
        self.tile_dim, self.n = tile_dim, n
        self._b2sr: Optional[B2SR] = None
        self._csr: Optional[csr_mod.CSRMatrix] = None
        self._ell: Optional[B2SREll] = None
        self._ell_t: Optional[B2SREll] = None
        self._buckets: Optional[B2SRBucketedEll] = None
        #: what a backend's triangle row derives from L once and keeps
        self.cache: dict = {}
        self._parts: dict = {}      # (n_shards, devices) -> L's partition
        if build_b2sr:
            self.b2sr

    @property
    def b2sr(self) -> B2SR:
        if self._b2sr is None:
            self._b2sr = b2sr_mod.coo_to_b2sr(self.rows, self.cols, self.n,
                                              self.n, self.tile_dim,
                                              self.rows.device)
        return self._b2sr

    @property
    def csr(self) -> csr_mod.CSRMatrix:
        if self._csr is None:
            self._csr = csr_mod.from_coo(self.rows, self.cols, self.n,
                                         self.n, device=self.rows.device)
        return self._csr

    @property
    def ell(self) -> B2SREll:
        if self._ell is None:
            self._ell = b2sr_mod.to_ell(self.b2sr)
        return self._ell

    @property
    def ell_t(self) -> B2SREll:
        if self._ell_t is None:
            self._ell_t = b2sr_mod.to_ell(b2sr_mod.transpose(self.b2sr))
        return self._ell_t

    def buckets(self) -> B2SRBucketedEll:
        if self._buckets is None:
            self._buckets = b2sr_mod.to_bucketed(self.b2sr)
        return self._buckets

    def partitioned(self, n_shards: int,
                    devices: Optional[Sequence[torch.device]] = None
                    ) -> "partition_mod.PartitionedB2SR":
        """L row-partitioned for the sharded ``mxm_sum`` row, its blocks on
        ``devices`` (memoized per shard count and devices)."""
        key = (n_shards, None if devices is None else tuple(devices))
        if key not in self._parts:
            self._parts[key] = partition_mod.partition_rows(
                self.b2sr, n_shards, with_buckets=False, devices=devices)
        return self._parts[key]


@dataclasses.dataclass
class GraphMatrix:
    """A homogeneous-graph adjacency matrix, multi-format, on one device."""

    n_rows: int
    n_cols: int
    nnz: int
    tile_dim: int
    fwd: Orientation
    bwd: Optional[Orientation]        # transpose, for vxm / pull traversal
    backend: str = "b2sr"
    use_buckets: bool = True
    degrees_cache: Optional[torch.Tensor] = None
    transposed_cache: Optional["GraphMatrix"] = None
    fingerprint_cache: Optional[str] = None
    tri_cache: Optional[LowerTriangle] = None
    # scale-out state (``shard(mesh)``): the mesh and axes the graph is
    # row-partitioned over, the partitions of the forward and transposed
    # orientations, and the combine layout with its exchange plans; every
    # op resolves to the sharded rows while ``partitioned`` is set
    mesh: Optional[Any] = None
    shard_axes: Optional[tuple] = None
    partitioned: Optional["partition_mod.PartitionedB2SR"] = None
    partitioned_t: Optional["partition_mod.PartitionedB2SR"] = None
    comm: str = "gather"
    xplan: Optional["partition_mod.ExchangePlan"] = None
    xplan_t: Optional["partition_mod.ExchangePlan"] = None

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_coo(rows, cols, n_rows: int, n_cols: int, tile_dim: int = 32,
                 with_transpose: bool = True, backend: str = "b2sr",
                 device: DeviceLike = None) -> "GraphMatrix":
        """Build every representation on ``device`` (``None`` = CUDA)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        dev = resolve_device(device)
        rows = torch.as_tensor(rows, device=dev).to(torch.int64)
        cols = torch.as_tensor(cols, device=dev).to(torch.int64)
        mat = b2sr_mod.coo_to_b2sr(rows, cols, n_rows, n_cols, tile_dim, dev)
        fwd = Orientation(mat, csr_mod.from_coo(rows, cols, n_rows, n_cols,
                                                device=dev))
        bwd = None
        if with_transpose:
            mt = b2sr_mod.coo_to_b2sr(cols, rows, n_cols, n_rows, tile_dim,
                                      dev)
            bwd = Orientation(mt, csr_mod.from_coo(cols, rows, n_cols, n_rows,
                                                   device=dev))
        return GraphMatrix(n_rows=n_rows, n_cols=n_cols, nnz=mat.nnz,
                           tile_dim=tile_dim, fwd=fwd, bwd=bwd,
                           backend=backend)

    @staticmethod
    def from_b2sr(mat: B2SR, with_transpose: bool = True,
                  backend: str = "b2sr") -> "GraphMatrix":
        """Wrap an already-built B2SR (an mxm result) without re-packing,
        on its device. The transpose is ``transpose(mat)``; the CSR twins
        are built from the tiles (``b2sr_to_coo``) on first use."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        bwd = (Orientation(b2sr_mod.transpose(mat)) if with_transpose
               else None)
        return GraphMatrix(n_rows=mat.n_rows, n_cols=mat.n_cols,
                           nnz=mat.nnz, tile_dim=mat.tile_dim,
                           fwd=Orientation(mat), bwd=bwd, backend=backend)

    @staticmethod
    def from_dense(mat, tile_dim: int = 32, **kw) -> "GraphMatrix":
        rows, cols = torch.nonzero(torch.as_tensor(mat), as_tuple=True)
        return GraphMatrix.from_coo(rows, cols, mat.shape[0], mat.shape[1],
                                    tile_dim, **kw)

    def with_backend(self, backend: str) -> "GraphMatrix":
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if backend == "csr" and self.sharded:
            raise ValueError("the csr baseline has no sharded rows; call "
                             "unshard() before with_backend('csr')")
        return dataclasses.replace(self, backend=backend,
                                   transposed_cache=None)

    def with_buckets(self, use_buckets: bool) -> "GraphMatrix":
        """Toggle the bucketed (SELL-style) compute path on the b2sr backend."""
        return dataclasses.replace(self, use_buckets=use_buckets,
                                   transposed_cache=None)

    def transposed(self) -> "GraphMatrix":
        """Aᵀ as a view: swap the stored orientations.

        Memoized, and the view's back-reference makes ``transposed()`` an
        involution; the lazy views are shared through the orientations.
        """
        if self.transposed_cache is not None:
            return self.transposed_cache
        if self.bwd is None:
            raise ValueError("GraphMatrix built without transpose "
                             "(with_transpose=True)")
        gt = dataclasses.replace(self, fwd=self.bwd, bwd=self.fwd,
                                 n_rows=self.n_cols, n_cols=self.n_rows,
                                 degrees_cache=None, transposed_cache=self,
                                 fingerprint_cache=None, tri_cache=None,
                                 partitioned=self.partitioned_t,
                                 partitioned_t=self.partitioned,
                                 xplan=self.xplan_t, xplan_t=self.xplan)
        self.transposed_cache = gt
        return gt

    # -- stored representations ----------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.fwd.b2sr.device

    @property
    def b2sr(self) -> B2SR:
        return self.fwd.b2sr

    @property
    def csr(self) -> csr_mod.CSRMatrix:
        return self.fwd.csr

    @property
    def ell(self) -> B2SREll:
        """The padded ELL view of ``b2sr``, built lazily and cached."""
        return self.fwd.get_ell()

    def buckets(self) -> B2SRBucketedEll:
        """The bucketed view of ``b2sr``, built lazily and cached."""
        return self.fwd.get_buckets()

    def _bucketed(self, row_chunk: Optional[int] = None) -> bool:
        """Whether this op dispatches to the bucketed path."""
        return self.use_buckets and row_chunk is None

    # -- scale-out: row-partitioned execution over a mesh ---------------------
    @property
    def sharded(self) -> bool:
        return self.partitioned is not None

    def shard(self, mesh, axes: Optional[Sequence[str]] = None,
              max_buckets: int = 8, combine: str = "gather",
              balanced: bool = True) -> "GraphMatrix":
        """Row-partition this graph over ``mesh`` (a
        :class:`~repro_torch.core.mesh.ShardMesh`).

        Returns a new ``GraphMatrix`` whose every operation, and so every
        algorithm and engine query built on it, runs the sharded rows:
        shard ``p`` owns a contiguous block of tile rows, split
        nnz-balanced (``balanced=False``: equal blocks), on the ``p``-th
        slot along ``axes`` (default: every axis; the other axes' first
        slots). Results equal the unsharded graph's; no call site
        changes.

        ``combine`` picks the layout: ``"gather"`` copies the operand to
        every shard and concatenates the blocks; ``"exchange"`` moves only
        the column words each block touches and sends each output row to
        its equal-block owner (one shard axis only). Rows without an
        exchange layout (graph SpGEMM, ``tri_count``) gather. Both
        orientations are partitioned, so ``transposed()`` stays sharded.
        """
        if self.backend == "csr":
            raise ValueError("the csr baseline has no sharded rows; shard "
                             "the b2sr or b2sr_cuda backend")
        if combine not in ("gather", "exchange"):
            raise ValueError(f"combine must be 'gather' or 'exchange', "
                             f"got {combine!r}")
        axes = tuple(axes) if axes is not None else tuple(mesh.axis_names)
        if combine == "exchange" and len(axes) != 1:
            raise ValueError("combine='exchange' runs a single-axis ring; "
                             f"shard over exactly one mesh axis (got {axes})")
        n_shards = partition_mod.shard_count(mesh, axes)
        devices = partition_mod.shard_devices(mesh, axes)
        kw = dict(with_buckets=self.use_buckets, max_buckets=max_buckets,
                  balanced=balanced, devices=devices)
        part = partition_mod.partition_rows(self.b2sr, n_shards, **kw)
        part_t = (partition_mod.partition_rows(self.bwd.b2sr, n_shards, **kw)
                  if self.bwd is not None else None)
        xplan = xplan_t = None
        if combine == "exchange":
            xplan = partition_mod.build_exchange_plan(part)
            if part_t is not None:
                xplan_t = partition_mod.build_exchange_plan(part_t)
        self._publish_partition_quality(part, part_t, n_shards)
        return dataclasses.replace(
            self, mesh=mesh, shard_axes=axes, partitioned=part,
            partitioned_t=part_t, comm=combine, xplan=xplan,
            xplan_t=xplan_t, transposed_cache=None)

    @staticmethod
    def _publish_partition_quality(part, part_t, n_shards: int) -> None:
        """The partition-quality gauges: one point per ``shard()`` call,
        labelled by orientation and shard count."""
        from repro_torch.obs import metrics as obs_metrics
        if not obs_metrics.enabled():
            return
        reg = obs_metrics.get_registry()
        labels = ("orientation", "shards")
        bal = reg.gauge("partition_balance",
                        "max/mean per-shard tile load of the row partition",
                        labels)
        cut = reg.gauge("partition_edge_cut",
                        "fraction of tiles whose column block lives on "
                        "another shard", labels)
        for orient, p in (("forward", part), ("transpose", part_t)):
            if p is None:
                continue
            bal.set(p.balance(), orientation=orient, shards=n_shards)
            cut.set(p.edge_cut(), orientation=orient, shards=n_shards)

    def unshard(self) -> "GraphMatrix":
        """Back to single-device execution (the partitions dropped; the
        whole graph's arrays were never removed)."""
        return dataclasses.replace(
            self, mesh=None, shard_axes=None, partitioned=None,
            partitioned_t=None, comm="gather", xplan=None, xplan_t=None,
            transposed_cache=None)

    # -- packed-vector helpers ---------------------------------------------
    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """Binarize + bit-pack a column-space vector (raw int32 words)."""
        return pack_bitvector(x, self.tile_dim, self.n_cols)

    def pack_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Binarize + bit-pack a row-space vector (output/frontier side)."""
        return pack_bitvector(x, self.tile_dim, self.n_rows)

    # -- the generic operation ----------------------------------------------
    @dispatch.scoped
    def mxv(self, x, semiring: Optional[Semiring] = None,
            desc: Optional[Descriptor] = None, *, a_value: float = 1.0,
            out_dtype=None, out=None, mask=_UNSET, complement=_UNSET,
            row_chunk=_UNSET):
        """y = A ⊕.⊗ x — the generic matrix-vector product (paper Table II).

        The table row is resolved from the operand type and the semiring:

          dense ``x``           bin·full→full (any semiring: SSSP,
                                PageRank, CC); ``a_value`` is the uniform
                                edge value
          ``BitVector`` x,      bin·bin→bin, the BFS step; returns a
          boolean semiring      ``BitVector``
          ``BitVector`` x,      bin·bin→full, neighbour counts in
          other semiring        ``out_dtype`` (default float32)

        ``semiring`` defaults to boolean for packed operands and arithmetic
        for dense ones. ``desc`` carries mask / complement / transpose /
        replace / row_chunk / direction; with ``desc.replace=False`` the
        masked-out entries are taken from ``out``.
        """
        desc = descriptor_mod.merge_sugar(desc, mask, complement, row_chunk)
        if self.sharded:
            dispatch.reject_sharded_row_chunk("mxv", desc.row_chunk)
        if desc.transpose_a:
            return self.transposed().mxv(
                x, semiring, desc.replace_with(transpose_a=False),
                a_value=a_value, out_dtype=out_dtype, out=out)
        kind = operand_kind(x)
        if kind not in ("dense", "bitvec"):
            raise TypeError(f"mxv right-hand side must be a dense vector or "
                            f"BitVector, got {type(x).__name__}")
        if kind == "bitvec":
            check_operand(x, self.tile_dim, self.n_cols, "x")
        semiring = semiring if semiring is not None else (
            BOOLEAN if kind == "bitvec" else ARITHMETIC)
        dispatch.check_semiring("mxv", kind, semiring)
        out_kind = dispatch.out_kind_for(semiring, kind)
        call = OpCall(
            semiring=semiring,
            mask=self._norm_mask(desc.mask, kind, out_kind),
            complement=desc.complement, row_chunk=desc.row_chunk,
            a_value=a_value,
            out_dtype=out_dtype if out_dtype is not None else torch.float32)
        op = self._direction_op("mxv", desc, kind, "bitvec", out_kind,
                                call.mask is not None)
        impl = dispatch.resolve(op, kind, out_kind, self.backend,
                                self._bucketed(desc.row_chunk),
                                call.mask is not None, self.sharded)
        y = impl(self, x.words if kind == "bitvec" else x, call)
        if out_kind == "bin":
            y = BitVector.from_words(y, self.n_rows, self.tile_dim)
        return self._merge_unreplaced(y, desc, out, out_kind, call)

    def vxm(self, x, semiring: Optional[Semiring] = None,
            desc: Optional[Descriptor] = None, *, mask=_UNSET,
            complement=_UNSET, row_chunk=_UNSET, **kw):
        """xᵀ·A: ``mxv`` with the descriptor's input transpose."""
        desc = descriptor_mod.merge_sugar(desc, mask, complement, row_chunk)
        return self.mxv(x, semiring, desc.replace_with(transpose_a=True),
                        **kw)

    @dispatch.scoped
    def mxm(self, other=None, semiring: Optional[Semiring] = None,
            desc: Optional[Descriptor] = None, *, out=None,
            with_transpose: bool = True, out_dtype=None, mask=_UNSET,
            complement=_UNSET, row_chunk=_UNSET):
        """C⟨M⟩ = A ⊕.⊗ B — the generic matrix product (paper Table III).

          ``GraphMatrix`` B,    bin·bin→bin boolean SpGEMM: a new
          boolean semiring      ``GraphMatrix`` (``other`` defaults to
                                ``self``: A², 2-hop reachability)
          ``GraphMatrix`` B,    bin·bin→full count SpGEMM: the dense
          arithmetic            ``[n_rows, n_cols]`` common-neighbour
                                counts (int32 on the bit backends,
                                float32 on ``csr``, as in the reference)
          dense matrix X        bin·full→full widened: ``Y = A @ X``
                                ``[n_rows, d]`` (batched PageRank)
          ``FrontierBatch`` F   bin·bin→bin widened: one traversal for S
                                packed frontiers (the multi-source
                                engine); returns a ``FrontierBatch``
          ``BitMatrix`` B       bin·bin→full: popcount counts ``[n_rows,
                                d]`` over packed binarized activations
                                (the BitGNN layer), in ``out_dtype``
                                (default float32); arithmetic only

        ``semiring`` defaults to arithmetic for a dense or ``BitMatrix``
        operand and to boolean otherwise. Masks are structural and
        applied right before the store (paper §V): a ``GraphMatrix`` for
        SpGEMM, a ``FrontierBatch`` for frontiers, a dense (or
        ``BitVector``) mask for dense and count outputs, where a vector
        masks whole rows.
        ``desc.replace=False`` merges the masked-out entries from ``out``;
        ``with_transpose`` decides whether a boolean SpGEMM result stores
        its transpose.
        """
        desc = descriptor_mod.merge_sugar(desc, mask, complement, row_chunk)
        if self.sharded:
            dispatch.reject_sharded_row_chunk("mxm", desc.row_chunk)
        if desc.transpose_a:
            return self.transposed().mxm(
                other, semiring, desc.replace_with(transpose_a=False),
                out=out, with_transpose=with_transpose, out_dtype=out_dtype)
        other = self if other is None else other
        kind = operand_kind(other)
        if kind == "bitvec":
            raise TypeError("mxm right-hand side is a BitVector; use mxv "
                            "for packed vector operands")
        semiring = semiring if semiring is not None else (
            ARITHMETIC if kind in ("dense", "bitmat") else BOOLEAN)
        dispatch.check_semiring("mxm", kind, semiring)
        out_kind = dispatch.out_kind_for(semiring, kind)
        if kind == "graph":
            if self.n_cols != other.n_rows:
                raise ValueError(f"inner-dim mismatch: {self.n_cols} vs "
                                 f"{other.n_rows}")
            if self.backend != "csr" and self.tile_dim != other.tile_dim:
                raise ValueError(f"tile_dim mismatch: {self.tile_dim} vs "
                                 f"{other.tile_dim}")
        elif kind in ("frontier", "bitmat"):
            check_operand(other, self.tile_dim, self.n_cols, "B")
        elif other.dim() != 2 or other.shape[0] != self.n_cols:
            raise ValueError(f"dense operand shape {tuple(other.shape)} is "
                             f"not [{self.n_cols}, d]")
        norm_mask = (self._norm_graph_mask(desc.mask, out_kind, other)
                     if kind == "graph" else
                     self._norm_mask(desc.mask, kind, out_kind))
        if (kind in ("dense", "bitmat") and norm_mask is not None
                and norm_mask.dim() == 1):
            norm_mask = norm_mask[:, None]      # a vector mask masks rows
        call = OpCall(
            semiring=semiring, mask=norm_mask, complement=desc.complement,
            row_chunk=desc.row_chunk,
            out_dtype=out_dtype if out_dtype is not None else torch.float32)
        op = self._direction_op("mxm", desc, kind, "frontier", out_kind,
                                call.mask is not None)
        impl = dispatch.resolve(op, kind, out_kind, self.backend,
                                self._bucketed(desc.row_chunk),
                                call.mask is not None, self.sharded)
        y = impl(self, other.words if kind in ("frontier", "bitmat")
                 else other, call)
        if kind == "graph":
            if out_kind == "bin":
                return self._to_graph(y, desc, out, with_transpose)
            if desc.replace or desc.mask is None:
                return y
            if out is None:
                raise ValueError("desc.replace=False needs the previous "
                                 "output (out=) to merge masked-out entries "
                                 "from")
            dm = csr_mod.to_dense(desc.mask.csr) > 0
            return torch.where(~dm if desc.complement else dm, y, out)
        if kind == "frontier":
            y = FrontierBatch.from_words(y, self.n_rows, other.n_sources,
                                         self.tile_dim)
        return self._merge_unreplaced(y, desc, out, out_kind, call)

    @dispatch.scoped
    def tri_count(self, row_chunk: Optional[int] = None) -> torch.Tensor:
        """Σ (L·Lᵀ ⊙ L), L the strict lower triangle: the triangle count of
        the undirected graph, as an exact int64 scalar tensor.

        The fused masked reduction (paper §V, Listing 2), dispatched as
        the ``mxm_sum`` row; L is split once and memoized
        (:class:`LowerTriangle`). The reference returns float32, exact
        only up to 2**24.
        """
        if self.sharded:
            dispatch.reject_sharded_row_chunk("mxm_sum", row_chunk)
        if self.tri_cache is None:
            self.tri_cache = LowerTriangle(
                self.csr, self.tile_dim, self.n_rows,
                build_b2sr=self.backend == "b2sr_cuda")
        call = OpCall(semiring=ARITHMETIC, row_chunk=row_chunk)
        impl = dispatch.resolve("mxm_sum", "tri", "full", self.backend,
                                self._bucketed(row_chunk), True, self.sharded)
        return impl(self, self.tri_cache, call)

    # -- generic-layer helpers ---------------------------------------------
    @staticmethod
    def _direction_op(base: str, desc: Descriptor, kind: str,
                      pull_kind: str, out_kind: str, masked: bool) -> str:
        """Resolve ``desc.direction`` to the registry op name; pull exists
        only for the masked packed traversal and is rejected elsewhere."""
        if desc.direction is None:
            return base
        if desc.direction != "pull":
            raise ValueError(f"unknown descriptor direction "
                             f"{desc.direction!r}; expected None or 'pull'")
        if kind != pull_kind or out_kind != "bin" or not masked:
            raise ValueError(
                f"direction='pull' applies only to the masked packed "
                f"traversal row ({base} over a {pull_kind} operand on the "
                f"boolean semiring with a visited mask); got rhs={kind} "
                f"out={out_kind} masked={masked}")
        return base + "_pull"

    def _norm_mask(self, mask, rhs_kind: str, out_kind: str):
        """Validate the descriptor mask and strip it to the row's raw form:
        packed words for packed outputs (a ``BitVector`` over a packed
        vector, a ``FrontierBatch`` over frontiers); a dense mask for
        dense outputs (a ``BitVector`` is unpacked to bool)."""
        if mask is None:
            return None
        if out_kind == "bin":
            if rhs_kind == "bitvec" and not isinstance(mask, BitVector):
                raise TypeError("packed mxv takes a BitVector mask")
            if rhs_kind == "frontier" and not isinstance(mask, FrontierBatch):
                raise TypeError("frontier mxm takes a FrontierBatch mask")
            check_operand(mask, self.tile_dim, self.n_rows, "mask")
            return mask.words
        if isinstance(mask, BitVector):
            check_operand(mask, self.tile_dim, self.n_rows, "mask")
            return mask.unpack(torch.bool)
        return mask

    def _norm_graph_mask(self, mask, out_kind: str, other: "GraphMatrix"):
        """Validate a structural SpGEMM mask (a ``GraphMatrix`` shaped like
        the output)."""
        if mask is None:
            return None
        if operand_kind(mask) != "graph":
            raise TypeError("mxm over GraphMatrix operands takes a "
                            "structural GraphMatrix mask")
        if mask.n_rows != self.n_rows or mask.n_cols != other.n_cols:
            raise ValueError("mask shape must match the output")
        if (out_kind == "bin" and self.backend != "csr"
                and mask.tile_dim != self.tile_dim):
            raise ValueError(f"mask tile_dim mismatch: {mask.tile_dim} "
                             f"vs {self.tile_dim}")
        return mask

    def _to_graph(self, mat: B2SR, desc: Descriptor, out,
                  with_transpose: bool) -> "GraphMatrix":
        """Wrap a boolean SpGEMM result; ``desc.replace=False`` ORs in
        ``out``'s bits outside the (complemented) mask, a merge of the
        sparse tile lists."""
        if not desc.replace and desc.mask is not None:
            if out is None:
                raise ValueError("desc.replace=False needs the previous "
                                 "output (out=) to merge masked-out entries "
                                 "from")
            if desc.complement:
                kept = combine_tiles(out.b2sr, desc.mask.b2sr,
                                     lambda o, m: o & m)
            else:
                kept = combine_tiles(out.b2sr, desc.mask.b2sr,
                                     lambda o, m: o & ~m)
            mat = combine_tiles(mat, kept, torch.bitwise_or)
        return GraphMatrix.from_b2sr(mat, with_transpose=with_transpose,
                                     backend=self.backend)

    @staticmethod
    def _merge_unreplaced(y, desc: Descriptor, out, out_kind: str,
                          call: OpCall):
        """Apply ``desc.replace=False``: masked-out entries come from ``out``."""
        if desc.replace or desc.mask is None:
            return y
        if out is None:
            raise ValueError("desc.replace=False needs the previous output "
                             "(out=) to merge masked-out entries from")
        if out_kind == "bin":
            m = call.mask if not desc.complement else ~call.mask
            return y._like((y.words & m) | (out.words & ~m))
        keep = (call.mask == 0) if desc.complement else (call.mask != 0)
        return torch.where(keep, y, out)

    # -- batched query entry points (the multi-source engine) ---------------
    def msbfs(self, sources: Sequence[int], max_iters: Optional[int] = None,
              direction=None):
        """Multi-source BFS: per-source hop levels ``int32[n, S]``; column
        ``s`` equals ``algorithms.bfs(g, sources[s]).levels``."""
        from repro_torch.engine import queries
        return queries.msbfs(self, sources, max_iters=max_iters,
                             direction=direction)

    def ppr(self, seeds: Sequence[int], alpha: float = 0.85,
            max_iters: int = 10, eps: float = 1e-9):
        """Batched personalized PageRank: per-seed ranks ``f32[n, S]``."""
        from repro_torch.engine import queries
        return queries.batched_ppr(self, seeds, alpha=alpha,
                                   max_iters=max_iters, eps=eps)

    # -- storage -------------------------------------------------------------
    def degrees(self) -> torch.Tensor:
        """Out-degree vector from the CSR twin (row_ptr diff); memoized."""
        if self.degrees_cache is None:
            ptr = self.csr.row_ptr
            self.degrees_cache = (ptr[1:] - ptr[:-1]).to(torch.float32)
        return self.degrees_cache

    def fingerprint(self) -> str:
        """Content hash of the graph structure (a plan-cache key field).

        Position-weighted int64 checksums of the B2SR arrays, reduced on
        their device and hashed with the shape header on the host (one
        sync); memoized per instance, and kept across backend and bucket
        toggles, which are key fields of their own. Equal structure gives
        equal fingerprints within the port; it is not the reference's
        hash (that one reads the ELL view back to the host).
        """
        if self.fingerprint_cache is None:
            m = self.b2sr
            sums = torch.cat([_checksums(a) for a in
                              (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)])
            h = hashlib.blake2b(digest_size=16)
            h.update(f"{self.n_rows}:{self.n_cols}:{self.nnz}:"
                     f"{self.tile_dim}:{m.n_tiles}".encode())
            h.update(repr(sums.tolist()).encode())
            self.fingerprint_cache = h.hexdigest()
        return self.fingerprint_cache


#: elements per chunk of :func:`_checksums` (bounds its int64 temporaries)
_CHECKSUM_CHUNK = 1 << 26


def _checksums(a: torch.Tensor) -> torch.Tensor:
    """Two sums Σ_i u_i · w_i mod 2**64 over the unsigned 32-bit values u
    of ``a`` (flattened), with odd position weights w_i < 2**31 mixed from
    i by two salts: an int64 ``[2]`` on ``a``'s device. Integer sums wrap
    the same way in any order, so the value does not depend on the
    device."""
    flat = a.reshape(-1)
    total = torch.zeros(2, dtype=torch.int64, device=a.device)
    salts = torch.tensor([0x632BE5AB, 0x2545F491], dtype=torch.int64,
                         device=a.device)
    for s in range(0, flat.shape[0], _CHECKSUM_CHUNK):
        u = flat[s:s + _CHECKSUM_CHUNK].to(torch.int64) & 0xFFFFFFFF
        i = torch.arange(s, s + u.shape[0], dtype=torch.int64,
                         device=a.device)
        mix = i * 0x9E3779B1 ^ (i >> 15)
        for j in range(2):
            w = ((mix + salts[j]) & 0x7FFFFFFF) | 1
            total[j] += (u * w).sum()
    return total
