"""Batched multi-source graph queries over packed frontier matrices.

The single-source algorithms in ``repro_torch.algorithms`` pay one full
matrix sweep per query. Here a batch of S queries shares every sweep: the
frontiers live in one bit-packed :class:`FrontierBatch` (``int32[tiles,
t, W]``, 32 sources per word) and each iteration is one generic
``GraphMatrix.mxm``: the FrontierBatch operand selects the
multi-frontier row, so A's tiles are read once for the whole batch.
Each query loop is built once per (graph, kernel, batch width,
descriptor) and cached by ``engine.planner``.

The reference runs each loop as one ``lax.while_loop``; here it runs on
the host with one sync per iteration: the frontier and visited popcounts
(msbfs), whether the frontier is empty (mskhop), or the L1 change (PPR).

``gnn_infer`` serves class scores of a registered GNN model
(``register_gnn_model``) for a batch of nodes through one full-graph
forward, its hidden layers on the packed bit path.

Parity contracts (held by ``tests/test_torch_engine.py`` and
``tests/test_torch_gnn.py``):
  - ``msbfs`` / ``mskhop`` / ``ms_sssp`` column ``s`` equals the
    single-source run on ``sources[s]`` bit for bit, and the reference's
    batched result.
  - ``batched_ppr`` column ``s`` is allclose to ``algorithms.ppr`` (the
    batched SpMM sums in another order than the mxv).
  - ``gnn_infer`` column ``s`` is the model's logits of ``sources[s]``,
    allclose to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.algorithms import direction as direction_mod
from repro_torch.algorithms.bfs import _check_max_iters
from repro_torch.algorithms.direction import DirectionConfig
from repro_torch.core.b2sr import (SOURCE_WORD_BITS, ceil_div,
                                   unpack_frontier_matrix)
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.operands import FrontierBatch
from repro_torch.core.words import to_int32
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import planner as planner_mod
from repro_torch.engine.planner import PlanCache, descriptor_key, plan_key
from repro_torch.gnn_bit import binarize as binarize_mod

#: The descriptor every masked-traversal loop bakes in: the per-source
#: visited sets as a complement mask (built inside the loop).
_TRAVERSAL_DESC = descriptor_key(Descriptor(complement=True), masked=True)


def _traversal_desc(cfg: DirectionConfig) -> Tuple:
    """Plan-key descriptor of a direction-switching loop: its policy (mode
    and thresholds) is part of the loop, so two configs never share."""
    return _TRAVERSAL_DESC + (cfg.mode, cfg.alpha, cfg.beta)


@dataclasses.dataclass
class MSBFSResult:
    levels: torch.Tensor     # int32[n, S]; -1 = unreachable from sources[s]
    n_iterations: int        # max over the batch (columns finish together)
    directions: Tuple[str, ...] = ()   # direction of each iteration run


@dataclasses.dataclass
class MSSSSPResult:
    distances: torch.Tensor  # float32[n, S]; +inf = unreachable
    n_iterations: int


@dataclasses.dataclass
class BatchedPPRResult:
    ranks: torch.Tensor      # float32[n, S]; column s = PPR from seeds[s]
    n_iterations: int


@dataclasses.dataclass
class GNNInferResult:
    logits: torch.Tensor     # float32[n_classes, S]; column s = sources[s]
    n_layers: int


def _check_sources(sources, n: int) -> np.ndarray:
    if isinstance(sources, torch.Tensor):
        sources = sources.cpu().numpy()
    src = np.asarray(sources, dtype=np.int64).reshape(-1)
    if src.size == 0:
        raise ValueError("need at least one source")
    bad = src[(src < 0) | (src >= n)]
    if bad.size:
        shown = ", ".join(str(b) for b in bad[:5])
        more = ", ..." if bad.size > 5 else ""
        raise ValueError(
            f"source id(s) {shown}{more} out of range for a graph with "
            f"{n} nodes (valid ids are 0..{n - 1})")
    return src


def _padded_width(n_sources: int) -> int:
    return ceil_div(n_sources, SOURCE_WORD_BITS) * SOURCE_WORD_BITS


def _one_hot_frontier(g: GraphMatrix, src: np.ndarray,
                      s_pad: int) -> FrontierBatch:
    """Packed one-hot frontier matrix ``[tiles, t, W]`` for a batch, built
    in the packed layout: S word updates on the device, no dense
    ``[n, s_pad]`` matrix. Column ``i`` sets bit ``i % 32`` of word
    ``i // 32`` of node ``src[i]``; the bits are distinct, so adding
    them is OR-ing them."""
    t, w = g.tile_dim, s_pad // SOURCE_WORD_BITS
    n_tiles = ceil_div(g.n_rows, t)
    idx = torch.arange(src.size, dtype=torch.int64, device=g.device)
    s = torch.as_tensor(src, dtype=torch.int64, device=g.device)
    flat = torch.zeros(n_tiles * t * w, dtype=torch.int64, device=g.device)
    flat.index_add_(0, s * w + idx // SOURCE_WORD_BITS,
                    torch.ones_like(idx) << (idx % SOURCE_WORD_BITS))
    return FrontierBatch.from_words(to_int32(flat).view(n_tiles, t, w),
                                    g.n_rows, s_pad, t)


def _planner(planner: Optional[PlanCache]) -> PlanCache:
    return planner_mod.DEFAULT_PLANNER if planner is None else planner


# ---------------------------------------------------------------------------
# multi-source BFS: per-source depth via iteration-stamped updates
# ---------------------------------------------------------------------------

def _build_msbfs_plan(g: GraphMatrix, cfg: DirectionConfig):
    gt = g.transposed()
    n = g.n_rows
    avg_degree = g.nnz / max(n, 1)

    def loop(f0: FrontierBatch, levels: torch.Tensor, max_iters: int,
             n_active: int):
        frontier = visited = f0
        d = direction_mod.initial_direction(cfg)
        locked = False
        trace = []
        it = 0
        live = True                 # f0 holds at least one source
        while live and it < max_iters:
            # the FrontierBatch operand selects the multi-frontier row,
            # with the per-source visited sets as the §V mask
            nxt = gt.mxm(frontier, desc=Descriptor(
                mask=visited, complement=True,
                direction="pull" if d == direction_mod.PULL else None))
            new_bits = unpack_frontier_matrix(nxt.words, n, levels.shape[1],
                                              torch.bool)
            levels = torch.where(new_bits & (levels < 0), it + 1, levels)
            visited = visited | nxt
            trace.append(d)
            nnz_f, nnz_v = torch.stack([
                direction_mod.nnz_words(nxt.words),
                direction_mod.nnz_words(visited.words)]).tolist()
            # n_active (not the padded width) scales the summed counts to
            # per-query magnitudes: padded columns are all zero
            d, locked = direction_mod.next_direction(
                cfg, d, locked, nnz_f, nnz_v, n, avg_degree, batch=n_active)
            frontier = nxt
            it += 1
            live = nnz_f > 0
        return levels, it, trace

    return loop


def msbfs(g: GraphMatrix, sources: Sequence[int],
          max_iters: Optional[int] = None,
          planner: Optional[PlanCache] = None,
          direction=None) -> MSBFSResult:
    """Hop levels from every source in one batched traversal.

    Column ``s`` of ``levels`` equals ``algorithms.bfs(g,
    sources[s]).levels`` for every ``direction`` mode; the whole batch
    switches direction together, steered by the summed density scaled
    back to per-query magnitudes. ``direction=None`` means auto, as in
    ``bfs``.
    """
    cfg = (direction_mod.as_config(direction) if direction is not None
           else DirectionConfig(mode="auto"))
    n = g.n_rows
    src = _check_sources(sources, n)
    max_iters = _check_max_iters(max_iters, n)
    s_pad = _padded_width(src.size)
    plan = _planner(planner).get(plan_key(g, "msbfs", s_pad,
                                          desc=_traversal_desc(cfg)),
                                 lambda: _build_msbfs_plan(g, cfg))
    levels0 = torch.full((n, s_pad), -1, dtype=torch.int32, device=g.device)
    levels0[torch.as_tensor(src, device=g.device),
            torch.arange(src.size, device=g.device)] = 0
    levels, it, trace = plan(_one_hot_frontier(g, src, s_pad), levels0,
                             max_iters, src.size)
    dirs = direction_mod.trace_tuple(trace, it)
    direction_mod.observe_trace(dirs, kernel="msbfs")
    return MSBFSResult(levels=levels[:, : src.size], n_iterations=it,
                       directions=dirs)


# ---------------------------------------------------------------------------
# multi-source k-hop neighbourhoods
# ---------------------------------------------------------------------------

def _build_mskhop_plan(g: GraphMatrix):
    gt = g.transposed()

    def loop(f0: FrontierBatch, k: int) -> FrontierBatch:
        frontier = visited = f0
        for _ in range(k):
            nxt = gt.mxm(frontier, desc=Descriptor(mask=visited,
                                                   complement=True))
            visited = visited | nxt
            frontier = nxt
            if not bool(nxt.any()):     # later hops would add nothing
                break
        return visited & ~f0            # the sources themselves excluded

    return loop


def mskhop(g: GraphMatrix, sources: Sequence[int], k: int,
           planner: Optional[PlanCache] = None) -> torch.Tensor:
    """<= k-hop neighbourhoods of every source, as ``bool[n, S]``; column
    ``s`` equals ``algorithms.khop_frontier(g, sources[s], k)``."""
    if k < 1:
        raise ValueError("k must be >= 1")
    n = g.n_rows
    src = _check_sources(sources, n)
    s_pad = _padded_width(src.size)
    plan = _planner(planner).get(plan_key(g, "mskhop", s_pad,
                                          desc=_TRAVERSAL_DESC),
                                 lambda: _build_mskhop_plan(g))
    reached = plan(_one_hot_frontier(g, src, s_pad), int(k))
    return unpack_frontier_matrix(reached.words, n, src.size, torch.bool)


# ---------------------------------------------------------------------------
# multi-source SSSP (uniform edge weight: hop distances × weight)
# ---------------------------------------------------------------------------

def ms_sssp(g: GraphMatrix, sources: Sequence[int], edge_weight: float = 1.0,
            max_iters: Optional[int] = None,
            planner: Optional[PlanCache] = None,
            direction=None) -> MSSSSPResult:
    """Batched SSSP on the binary adjacency: ``levels × edge_weight``.

    B2SR edges carry no values, so min-plus distances are hop counts times
    the uniform weight and one msbfs serves the whole batch. Equal to the
    looped ``algorithms.sssp`` for dyadic weights (1.0, 0.5, 2.0, ...),
    where k repeated float adds equal ``k * w``.
    """
    res = msbfs(g, sources, max_iters=max_iters, planner=planner,
                direction=direction)
    dist = torch.where(res.levels >= 0,
                       res.levels.to(torch.float32) * edge_weight,
                       float("inf"))
    return MSSSSPResult(distances=dist, n_iterations=res.n_iterations)


# ---------------------------------------------------------------------------
# batched personalized PageRank (arithmetic semiring, per-column restarts)
# ---------------------------------------------------------------------------

def _build_ppr_plan(g: GraphMatrix):
    gt = g.transposed()
    out_deg = g.degrees()
    dangling = out_deg == 0
    safe_deg = torch.where(dangling, 1.0, out_deg)

    def loop(restart: torch.Tensor, alpha: float, eps: float,
             max_iters: int):
        # float32 scalars, as the reference's traced alpha and eps
        a = torch.tensor(alpha, dtype=torch.float32, device=restart.device)
        eps32 = np.float32(eps)
        pr, delta, it = restart, np.inf, 0
        while delta > eps32 and it < max_iters:
            scaled = pr / safe_deg[:, None]           # out-degree division
            contrib = gt.mxm(scaled)                  # [n, S] multi-vector
            dangle = torch.where(dangling[:, None], pr, 0.0).sum(0)
            new = a * contrib + (a * dangle[None, :] + (1.0 - a)) * restart
            delta = float(torch.abs(new - pr).sum(0).max())
            pr = new
            it += 1
        return pr, it

    return loop


def batched_ppr(g: GraphMatrix,
                seeds: Union[Sequence[int], torch.Tensor, np.ndarray],
                alpha: float = 0.85, max_iters: int = 10, eps: float = 1e-9,
                planner: Optional[PlanCache] = None) -> BatchedPPRResult:
    """Personalized PageRank for S seeds in one multi-vector iteration.

    ``seeds`` is an int array ``[S]`` (one-hot restarts) or a dense
    restart matrix ``[n, S]`` (per-column restart distributions). Dangling
    mass restarts into each column's own distribution, the update of
    ``algorithms.ppr``. Stops when the worst column's L1 change is
    <= ``eps`` (a batch runs until its slowest member converges).
    """
    n = g.n_rows
    seeds_arr = (seeds.cpu().numpy() if isinstance(seeds, torch.Tensor)
                 else np.asarray(seeds))
    if seeds_arr.ndim == 2:
        if seeds_arr.shape[0] != n:
            raise ValueError(f"restart matrix must be [n={n}, S]")
        s = seeds_arr.shape[1]
        restart = torch.zeros((n, _padded_width(s)), dtype=torch.float32,
                              device=g.device)
        restart[:, :s] = torch.as_tensor(seeds_arr, dtype=torch.float32,
                                         device=g.device)
    else:
        src = _check_sources(seeds_arr, n)
        s = src.size
        restart = torch.zeros((n, _padded_width(s)), dtype=torch.float32,
                              device=g.device)
        restart[torch.as_tensor(src, device=g.device),
                torch.arange(s, device=g.device)] = 1.0
    plan = _planner(planner).get(plan_key(g, "ppr", restart.shape[1]),
                                 lambda: _build_ppr_plan(g))
    ranks, it = plan(restart, alpha, eps, int(max_iters))
    return BatchedPPRResult(ranks=ranks[:, :s], n_iterations=it)


# ---------------------------------------------------------------------------
# batched GNN inference (the BitGNN forward on the bit path)
# ---------------------------------------------------------------------------

#: Served models by name: weights, input features and the bit-path flag.
#: Names (not tensors) travel in the query parameters, so the batcher's
#: groups coalesce by model.
_GNN_MODELS: dict = {}


@dataclasses.dataclass
class GNNModel:
    """A registered inference model: per-layer (W, b) and node features.

    ``binarize=True`` sends every hidden layer's aggregation through the
    packed bin·bin→full row: the activations are packed as ``x > 0`` to
    ``BitMatrix`` words and aggregated as α·(2·popcount − rowsum)
    (``repro_torch.gnn_bit``); the input layer always aggregates dense
    (float features). ``version`` is part of the plan key, so a name
    registered again never serves a stale forward.
    """

    name: str
    params: tuple            # ((w [d_in, d_out], b [d_out]), ...) per layer
    features: torch.Tensor   # float32[n, d_in]
    binarize: bool = True
    version: int = 0


def register_gnn_model(name: str, params, features, binarize: bool = True,
                       device: DeviceLike = None) -> GNNModel:
    """Register (or replace) a model for ``gnn_infer`` on ``device``
    (``None`` = CUDA). ``params`` is ``((w, b), ...)`` with ``w`` as
    ``[d_in, d_out]`` (the reference's layout), numpy or torch; tensors
    already float32 on ``device`` are kept, not copied."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    prev = _GNN_MODELS.get(name)
    model = GNNModel(name=name,
                     params=tuple((f32(w), f32(b)) for w, b in params),
                     features=f32(features), binarize=binarize,
                     version=prev.version + 1 if prev is not None else 0)
    _GNN_MODELS[name] = model
    return model


def _gnn_model(name: str) -> GNNModel:
    m = _GNN_MODELS.get(name)
    if m is None:
        raise ValueError(
            f"no GNN model registered under {name!r}; call "
            f"engine.queries.register_gnn_model first "
            f"(registered: {sorted(_GNN_MODELS) or 'none'})")
    return m


def _build_gnn_plan(g: GraphMatrix, model: GNNModel):
    rowsum = g.degrees().to(torch.float32)          # A's row sums
    params = model.params
    n_last = len(params) - 1

    @torch.no_grad()
    def fwd(idx: torch.Tensor) -> torch.Tensor:
        h = model.features
        for li, (w, b) in enumerate(params):
            if model.binarize and li > 0:
                # hidden layers on the packed path: pack h > 0, one
                # bin·bin→full mxm, the α·popcount reconstruction
                alpha = binarize_mod.alpha_scale(h)
                bm = binarize_mod.pack_activations(h, g.tile_dim)
                counts = g.mxm(bm)
                agg = alpha[None, :] * (2.0 * counts - rowsum[:, None]) + h
            else:
                agg = g.mxm(h)
                agg += h          # the self loop, in place (A·X is fresh)
            h = agg @ w + b
            del agg
            if li < n_last:
                h = torch.relu(h)
        return h[idx].T                             # [n_classes, s_pad]

    return fwd


def gnn_infer(g: GraphMatrix, sources: Sequence[int], model: str,
              planner: Optional[PlanCache] = None) -> GNNInferResult:
    """Class scores for a batch of nodes through one full-graph forward.

    One plan per (graph, model version, padded width) serves every batch:
    the forward computes the logits of all nodes (the aggregations are
    shared, which is the batching win) and gathers the requested rows.
    Column ``s`` of ``logits`` belongs to ``sources[s]``.
    """
    m = _gnn_model(model)
    n = g.n_rows
    if int(m.features.shape[0]) != n:
        raise ValueError(
            f"model {model!r} features cover {int(m.features.shape[0])} "
            f"nodes but the graph has {n}")
    if m.features.device != g.device:
        raise ValueError(f"model {model!r} is on {m.features.device}, the "
                         f"graph on {g.device}")
    src = _check_sources(sources, n)
    s_pad = _padded_width(src.size)
    padded = np.concatenate(
        [src, np.full(s_pad - src.size, src[0], np.int64)])
    plan = _planner(planner).get(
        plan_key(g, "gnn_infer", s_pad,
                 desc=("gnn", m.name, m.version, m.binarize)),
        lambda: _build_gnn_plan(g, m))
    logits = plan(torch.as_tensor(padded, device=g.device))
    return GNNInferResult(logits=logits[:, : src.size],
                          n_layers=len(m.params))
