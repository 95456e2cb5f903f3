"""PyTorch port vs the JAX reference: the sharded rows (multi-GPU slice).

The same seeded R-MAT COO (``repro.data.graphs``) goes through ``repro``
and ``repro_torch`` on the CPU; the port's meshes are 1, 2, 3, 4 and 8
CPU slots in this process (``make_mesh(..., devices=["cpu"] * P)``), and
``b2sr_cuda`` on a CPU graph runs the kernels' plain versions.

  - partitions and exchange plans equal the reference's field for field
    (bucket slabs and plan index arrays included), at tile dims 8 and 32;
  - every sharded key, under its bucketed and masked flags, with the
    gather and exchange combines, on ``b2sr`` and ``b2sr_cuda``, equals
    the reference's **unsharded** row on the same COO: bit for bit for
    boolean, count and min-plus/max-times rows, ``rtol 1e-5`` for
    arithmetic sums; whole algorithms likewise;
  - the comm counters equal the reference's sharded run on 4 forced host
    devices, and plan keys isolate mesh and comm layout as the
    reference's do;

The reference's slow parts (its unsharded rows and algorithms, and its
sharded run on forced host devices) run in five processes started with
the module's first test, beside the port's tests.
  - a GCN with ``shardmap_agg_axes=("data",)`` on 4 slots: loss and
    gradients within ``atol 1e-5, rtol 1e-4`` of the reference's
    unsharded ``jax.value_and_grad(gcn.loss_fn)``, and one train step's
    loss, and its update against the optimizer's from those gradients;
  - the errors, and the server's sharded views and warmup.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro.algorithms.bfs import bfs as r_bfs
    from repro.algorithms.cc import connected_components as r_cc
    from repro.algorithms.khop import khop_reachability as r_khop
    from repro.algorithms.pagerank import pagerank as r_pagerank
    from repro.algorithms.sssp import sssp as r_sssp
    from repro.algorithms.tc import triangle_count as r_tc
    from repro.configs.base import GNNConfig as RGNNConfig
    from repro.core import partition as rpart
    from repro.core.descriptor import Descriptor as RDescriptor
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import (BitMatrix as RBitMatrix,
                                     BitVector as RBitVector,
                                     FrontierBatch as RFrontierBatch)
    from repro.core.semiring import SEMIRINGS as R_SEMIRINGS
    from repro.data import graphs as RG
    from repro.data.synthetic import full_graph_batch as r_full_graph_batch
    from repro.engine import queries as r_queries
    from repro.models.gnn import gcn as rgcn
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.algorithms import (bfs, connected_components,  # noqa: E402
                                    khop_reachability, pagerank, sssp,
                                    triangle_count)
from repro_torch.configs.gnn import GNNConfig  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import partition as ppart  # noqa: E402
from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.core.operands import (BitMatrix, BitVector,  # noqa: E402
                                      FrontierBatch)
from repro_torch.core.semiring import SEMIRINGS  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.data.synthetic import full_graph_batch  # noqa: E402
from repro_torch.engine import GraphQueryServer, PlanCache  # noqa: E402
from repro_torch.engine import msbfs, plan_key  # noqa: E402
from repro_torch.engine import warmup as warmup_mod  # noqa: E402
from repro_torch.engine.server import ServerConfig  # noqa: E402
from repro_torch.gnn_bit import layers  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_steps  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 100                                  # not a multiple of 8 or 32
TILE_DIMS = (8, 32)
SHARDS = (1, 2, 3, 4, 8)                 # 8 > the 4 tile rows at t = 32
BACKENDS = ("b2sr", "b2sr_cuda")
COMBINES = ("gather", "exchange")
SUM_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4                  # the GCN step's, as training's


@functools.lru_cache(maxsize=None)
def coo():
    """A skewed graph: R-MAT plus one hub row, so the split is ragged."""
    rows, cols = PG.rmat_graph(N, avg_degree=8, seed=3)
    rng = np.random.default_rng(5)
    hub = rng.integers(0, N, 40)
    key = np.unique(np.concatenate([rows * N + cols, 7 * N + hub]))
    return key // N, key % N


@functools.lru_cache(maxsize=None)
def ref_coo():
    """The same COO, drawn through the reference's generator."""
    rows, cols = RG.rmat_graph(N, avg_degree=8, seed=3)
    rng = np.random.default_rng(5)
    hub = rng.integers(0, N, 40)
    key = np.unique(np.concatenate([rows * N + cols, 7 * N + hub]))
    return key // N, key % N


@functools.lru_cache(maxsize=None)
def port_graph(t: int, backend: str = "b2sr"):
    r, c = coo()
    return GraphMatrix.from_coo(r, c, N, N, t, backend=backend, device="cpu")


@functools.lru_cache(maxsize=None)
def ref_graph(t: int):
    r, c = ref_coo()
    return RGraph.from_coo(r, c, N, N, t)


def cpu_mesh(p: int, axes=("data",), slots: str = "same"):
    """P slots on the host: one device repeated, or ``cpu:0 .. cpu:P-1``,
    which the sharded rows treat as distinct devices (the copies between
    slots and the owners' own blocks of the exchange run)."""
    devs = (["cpu"] * p if slots == "same"
            else [f"cpu:{i}" for i in range(p)])
    return make_mesh((p,) + (1,) * (len(axes) - 1), axes, devs)


@functools.lru_cache(maxsize=None)
def sharded(t: int, backend: str, p: int, combine: str,
            slots: str = "same"):
    return port_graph(t, backend).shard(cpu_mesh(p, slots=slots),
                                        combine=combine)


@functools.lru_cache(maxsize=None)
def inputs(t: int) -> dict:
    rng = np.random.default_rng(100 + t)
    return {"x": rng.random(N).astype(np.float32),
            "v": rng.random(N) > 0.5, "m": rng.random(N) > 0.5,
            "f": rng.random((N, 5)) > 0.5, "fm": rng.random((N, 5)) > 0.5,
            "a": rng.random((N, 6)) > 0.5,
            "X": rng.random((N, 6)).astype(np.float32)}


# -- the rows, called the same way through either package ---------------------

#: name -> (call, exact); every sharded key appears under both mask flags
ROWS = {
    "mxv_bin": (lambda g, o, S, D: g.mxv(o["bv"]), True),
    "mxv_bin_masked": (lambda g, o, S, D: g.mxv(
        o["bv"], mask=o["mk"], complement=True), True),
    "mxv_pull": (lambda g, o, S, D: g.mxv(o["bv"], desc=D(
        mask=o["mk"], complement=True, direction="pull")), True),
    "vxm": (lambda g, o, S, D: g.vxm(o["bv"]), True),
    "mxv_count": (lambda g, o, S, D: g.mxv(
        o["bv"], S["arithmetic"], out_dtype=o["i32"]), True),
    "mxv_count_masked": (lambda g, o, S, D: g.mxv(
        o["bv"], S["arithmetic"], out_dtype=o["i32"], mask=o["mk"]), True),
    "mxv_sum": (lambda g, o, S, D: g.mxv(o["x"]), False),
    "mxv_min_plus": (lambda g, o, S, D: g.mxv(o["x"], S["min_plus"]), True),
    "mxv_max_times_masked": (lambda g, o, S, D: g.mxv(
        o["x"], S["max_times"], mask=o["mk"]), True),
    "mxm_dense": (lambda g, o, S, D: g.mxm(o["X"]), False),
    "mxm_dense_masked": (lambda g, o, S, D: g.mxm(o["X"], mask=o["mk"]),
                         False),
    "mxm_bitmat": (lambda g, o, S, D: g.mxm(o["bm"]), True),
    "mxm_bitmat_masked": (lambda g, o, S, D: g.mxm(o["bm"], mask=o["mk"]),
                          True),
    "mxm_frontier": (lambda g, o, S, D: g.mxm(o["fb"]), True),
    "mxm_frontier_masked": (lambda g, o, S, D: g.mxm(
        o["fb"], mask=o["fm"], complement=True), True),
    "mxm_pull": (lambda g, o, S, D: g.mxm(o["fb"], desc=D(
        mask=o["fm"], complement=True, direction="pull")), True),
    "mxm_graph": (lambda g, o, S, D: g.mxm(g), True),
    "mxm_graph_masked": (lambda g, o, S, D: g.mxm(g, mask=g,
                                                  complement=True), True),
    "mxm_graph_count": (lambda g, o, S, D: g.mxm(g, S["arithmetic"]), True),
    "mxm_graph_count_masked": (lambda g, o, S, D: g.mxm(
        g, S["arithmetic"], mask=g), True),
    "tri": (lambda g, o, S, D: g.tri_count(), True),
}


def ref_operands(t: int) -> dict:
    i = inputs(t)
    return {"x": jnp.asarray(i["x"]), "X": jnp.asarray(i["X"]),
            "bv": RBitVector.pack(jnp.asarray(i["v"]), t),
            "mk": RBitVector.pack(jnp.asarray(i["m"]), t),
            "fb": RFrontierBatch.pack(jnp.asarray(i["f"]), t),
            "fm": RFrontierBatch.pack(jnp.asarray(i["fm"]), t),
            "bm": RBitMatrix.pack(jnp.asarray(i["a"]), t), "i32": jnp.int32}


def port_operands(t: int) -> dict:
    i = inputs(t)
    return {"x": torch.from_numpy(i["x"]), "X": torch.from_numpy(i["X"]),
            "bv": BitVector.pack(torch.from_numpy(i["v"]), t),
            "mk": BitVector.pack(torch.from_numpy(i["m"]), t),
            "fb": FrontierBatch.pack(torch.from_numpy(i["f"]), t),
            "fm": FrontierBatch.pack(torch.from_numpy(i["fm"]), t),
            "bm": BitMatrix.pack(torch.from_numpy(i["a"]), t),
            "i32": torch.int32}


def ref_value(y):
    """A reference result as numpy: packed words as uint32, a graph as its
    CSR-over-tiles arrays."""
    if isinstance(y, RGraph):
        ell = y.ell
        col = np.asarray(ell.tile_col_idx)
        valid = col >= 0
        ptr = np.concatenate([[0], np.cumsum(np.asarray(ell.row_n_tiles))])
        return (ptr.astype(np.int32), col[valid],
                np.asarray(ell.bit_tiles)[valid])
    if isinstance(y, (RBitVector, RFrontierBatch)):
        return np.asarray(y.words).astype(np.uint32)
    return np.asarray(y)


def port_value(y):
    if isinstance(y, GraphMatrix):
        m = y.b2sr
        return (m.tile_row_ptr.numpy(), m.tile_col_idx.numpy(),
                to_numpy_u32(m.bit_tiles))
    if isinstance(y, (BitVector, FrontierBatch)):
        return to_numpy_u32(y.words)
    return y.detach().numpy()


#: processes the reference's unsharded rows are split over, by tile dim
#: (its first calls at t = 8 pay the primitives' compiles)
ROW_PARTS = {8: 2, 32: 1}


#: reference rows that build host-side arrays, so they run eagerly; the
#: others run as one compiled program each (eager dispatch compiles each
#: primitive apart, about twice as slow here)
EAGER_ROWS = ("mxm_graph", "mxm_graph_masked", "tri")


def _ref_rows(t: int, part: int) -> dict:
    g, o = ref_graph(t), ref_operands(t)
    out = {}
    for name in list(ROWS)[part::ROW_PARTS[t]]:
        def row(name=name):
            return ROWS[name][0](g, o, R_SEMIRINGS, RDescriptor)
        out[name] = ref_value(row() if name in EAGER_ROWS
                              else jax.jit(row)())
    return out


def ref_rows(t: int) -> dict:
    out = {}
    for part in range(ROW_PARTS[t]):
        out.update(_background(f"rows{t}:{part}"))
    return out


def assert_row(name, got, want, exact):
    if isinstance(want, tuple):
        for w, g_ in zip(want, got):
            assert np.array_equal(w, g_), name
    elif exact:
        assert np.array_equal(np.asarray(got), want), name
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=1e-6,
                                   err_msg=name)


# -- partitions and exchange plans --------------------------------------------

def assert_partition_equal(mine, ref):
    for f in ("row_starts", "shard_tiles", "cut_tiles", "n_tile_rows",
              "rows_per_shard", "slab_width", "n_shards"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.balance() == ref.balance()
    assert mine.edge_cut() == ref.edge_cut()
    assert np.array_equal(mine.gather_idx, np.asarray(ref.gather_idx))
    assert np.array_equal(mine.tile_col_idx, np.asarray(ref.tile_col_idx))
    assert np.array_equal(mine.bit_tiles.view(np.uint32),
                          np.asarray(ref.bit_tiles))
    assert np.array_equal(mine.row_n_tiles, np.asarray(ref.row_n_tiles))
    assert mine.n_buckets == ref.n_buckets
    for a, b in zip(mine.bucket_col_idx + mine.bucket_rows,
                    ref.bucket_col_idx + ref.bucket_rows):
        assert np.array_equal(a, np.asarray(b))
    for a, b in zip(mine.bucket_bit_tiles, ref.bucket_bit_tiles):
        assert np.array_equal(a.view(np.uint32), np.asarray(b))


def assert_plan_equal(mine, ref):
    if ref is None:
        assert mine is None
        return
    for f in ("n_shards", "c_eq", "r_eq", "n_tc_pad", "rhs_offsets",
              "out_offsets", "rhs_lanes", "out_lanes", "gather_lanes"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.exchanged_lanes() == ref.exchanged_lanes()
    for f in ("rhs_send_idx", "rhs_recv_pos", "out_send_idx",
              "out_recv_pos"):
        assert len(getattr(mine, f)) == len(getattr(ref, f)), f
        for a, b in zip(getattr(mine, f), getattr(ref, f)):
            assert np.array_equal(a, np.asarray(b)), f
    for f in ("self_src", "self_dst"):
        assert np.array_equal(getattr(mine, f), np.asarray(getattr(ref, f)))


@needs_reference
@pytest.mark.parametrize("balanced", (True, False))
@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("t", TILE_DIMS)
def test_partition_and_plan_match_reference(t, p, balanced):
    assert np.array_equal(np.stack(coo()), np.stack(ref_coo()))
    mine = ppart.partition_rows(port_graph(t).b2sr, p, balanced=balanced)
    ref = rpart.partition_rows(ref_graph(t).ell, p, balanced=balanced)
    assert_partition_equal(mine, ref)
    assert_plan_equal(ppart.build_exchange_plan(mine),
                      rpart.build_exchange_plan(ref))
    # the blocks are the graph's rows, and put back together exactly
    src = port_graph(t).b2sr
    back = ppart.unpartition(mine)
    for f in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
        assert torch.equal(getattr(back, f), getattr(src, f)), f
    assert back.nnz == src.nnz
    # the ELL view partitions to the same blocks
    via_ell = ppart.partition_rows(port_graph(t).ell, p, balanced=balanced)
    assert via_ell.row_starts == mine.row_starts
    assert np.array_equal(via_ell.tile_col_idx, mine.tile_col_idx)


@needs_reference
@pytest.mark.parametrize("case", ("empty", "tiny"))
def test_partition_of_empty_and_tiny_graphs(case):
    from repro.core.b2sr import coo_to_b2sr as r_coo_to_b2sr
    from repro_torch.core.b2sr import coo_to_b2sr
    n, t, p, r, c = ((16, 8, 4, [], []) if case == "empty"
                     else (4, 4, 8, [0], [1]))
    mine = ppart.partition_rows(coo_to_b2sr(
        np.array(r, np.int64), np.array(c, np.int64), n, n, t, "cpu"), p)
    ref = rpart.partition_rows(r_coo_to_b2sr(np.array(r), np.array(c), n,
                                             n, t), p)
    assert_partition_equal(mine, ref)
    assert_plan_equal(ppart.build_exchange_plan(mine),
                      rpart.build_exchange_plan(ref))
    assert mine.balance() == 1.0 if case == "empty" else \
        mine.rows_per_shard == 1
    assert ppart.unpartition(mine).nnz == len(r)


# -- every sharded row against the reference's unsharded row -------------------

@needs_reference
def test_registry_has_the_reference_sharded_keys():
    from repro.core import dispatch as r_dispatch
    backend = {"b2sr": "b2sr", "b2sr_pallas": "b2sr_cuda"}
    want = {k[:3] + (backend[k[3]],) + k[4:]
            for k in r_dispatch.registered_keys(load_all=True) if k[6]}
    got = {k for k in dispatch.registered_keys(load_all=True) if k[6]}
    assert got == want and len({k[:3] for k in got}) == 11
    assert not any(k[3] == "csr" for k in got)


# -- whole algorithms ----------------------------------------------------------

SOURCES = (0, 7, 42)


def _ref_algorithms() -> dict:
    g = ref_graph(8)
    out = {f"bfs/{d}": np.asarray(r_bfs(g, 7, direction=d).levels)
           for d in ("push", "pull", "auto")}
    out["sssp"] = np.asarray(r_sssp(g, 7).distances)
    out["pagerank"] = np.asarray(r_pagerank(g).ranks)
    out["cc"] = np.asarray(r_cc(g, direction="auto").labels)
    out["tc"] = int(r_tc(g))
    out["khop"] = ref_value(r_khop(g, 2).reach)
    out["msbfs"] = np.asarray(r_queries.msbfs(g, SOURCES).levels)
    return out


# -- comm counters and plan keys against the reference on 4 host devices ------

def _ref_comm() -> dict:
    """The reference's comm counters, one call per combine mode, on a ring
    of 4 forced host devices (buckets off: the counts do not depend on
    them, and the bucketed programs compile slower)."""
    from jax.sharding import Mesh
    from repro.engine.planner import plan_key as r_plan_key
    from repro.obs import metrics as r_metrics
    assert len(jax.devices()) == 4
    g = ref_graph(8).with_buckets(False)
    ring = Mesh(np.asarray(jax.devices()), ("data",))
    gg = g.shard(ring, combine="gather")
    gx = g.shard(ring, combine="exchange")
    X = jnp.asarray(np.random.default_rng(1).random((N, 6)).astype(
        np.float32))
    out = {}
    for name, fn in (("gather", lambda: gg.mxv(ref_operands(8)["bv"])),
                     ("psum", lambda: gg.tri_count()),
                     ("exchange", lambda: gx.mxm(X))):
        r_metrics.set_registry(r_metrics.MetricsRegistry())
        fn()
        out[name] = _series(r_metrics.get_registry(), "b2sr")
    out["plan_keys"] = _mesh_keys([r_plan_key(h, "bfs", 1) for h in
                                   (g, gg, gx)])
    return out


def _series(reg, backend: str) -> dict:
    return {c: {",".join(k).replace(backend, "b2sr"): v
                for k, v in reg.get(c)._series.items()}
            for c in ("gather_words_total", "exchange_words_total")
            if reg.get(c) is not None}


def _mesh_keys(keys) -> list:
    """Axis names, shape, shard axes and comm mode of plan keys' meshes."""
    return [None if k.mesh is None else
            [list(k.mesh[0]), list(k.mesh[1]), list(k.mesh[2]), k.mesh[-1]]
            for k in keys]


# -- the reference's slow parts run in processes beside the tests -------------

def _encode(v):
    if isinstance(v, tuple):
        return {"tuple": [_encode(x) for x in v]}
    if isinstance(v, np.ndarray):
        return {"dtype": str(v.dtype), "shape": list(v.shape),
                "data": v.ravel().tolist()}
    if isinstance(v, dict):
        return {k: _encode(x) for k, x in v.items()}
    return v


def _decode(v):
    if isinstance(v, dict) and "tuple" in v:
        return tuple(_decode(x) for x in v["tuple"])
    if isinstance(v, dict) and "dtype" in v:
        return np.array(v["data"], dtype=v["dtype"]).reshape(v["shape"])
    if isinstance(v, dict):
        return {k: _decode(x) for k, x in v.items()}
    return v


def _dump(kind: str) -> None:
    """Entry point of a background process: print ``kind``'s results
    (``rows<t>:<part>``: a part of the unsharded rows at tile dim t;
    ``algorithms``; ``comm``: the sharded run)."""
    if kind == "comm":
        out = _ref_comm()
    elif kind == "algorithms":
        out = _ref_algorithms()
    else:
        t, part = kind[len("rows"):].split(":")
        out = _ref_rows(int(t), int(part))
    print("RESULT=" + json.dumps(_encode(out)))


_PROCS: dict = {}
_RESULTS: dict = {}


def _start_background() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([os.path.join(here, "..", "src"),
                                          here])}
    kinds = ["comm", "algorithms"] + [f"rows{t}:{i}" for t in TILE_DIMS
                                      for i in range(ROW_PARTS[t])]
    for kind in kinds:
        # one thread each: the processes share the host with the tests
        e = dict(env, OMP_NUM_THREADS="1")
        flags = " --xla_cpu_multi_thread_eigen=false"
        if kind == "comm":
            flags += " --xla_force_host_platform_device_count=4"
        e["XLA_FLAGS"] = (e.get("XLA_FLAGS", "") + flags).strip()
        _PROCS[kind] = subprocess.Popen(
            [sys.executable, "-c", "import test_torch_sharding as T; "
             f"T._dump({kind!r})"], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)


def _background(kind: str) -> dict:
    if kind not in _RESULTS:
        out, err = _PROCS[kind].communicate(timeout=300)
        assert _PROCS[kind].returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT=")]
        _RESULTS[kind] = _decode(json.loads(line[-1][len("RESULT="):]))
    return _RESULTS[kind]


@pytest.fixture(scope="module", autouse=True)
def _reference_processes():
    """Start the reference's processes when the module's first test runs
    (the unsharded rows, split by tile dim; the algorithms; the comm
    counters on 4 forced host devices), and stop them when it ends."""
    if jnp is not None:
        _start_background()
    yield
    for proc in _PROCS.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    _PROCS.clear()


def port_comm(backend: str) -> dict:
    g = port_graph(8, backend)
    gg = sharded(8, backend, 4, "gather")
    gx = sharded(8, backend, 4, "exchange")
    X = torch.from_numpy(np.random.default_rng(1).random((N, 6)).astype(
        np.float32))
    out = {}
    prev = obs_metrics.get_registry()
    try:
        for name, fn in (("gather", lambda: gg.mxv(port_operands(8)["bv"])),
                         ("psum", lambda: gg.tri_count()),
                         ("exchange", lambda: gx.mxm(X))):
            obs_metrics.set_registry(obs_metrics.MetricsRegistry())
            fn()
            out[name] = _series(obs_metrics.get_registry(), backend)
    finally:
        obs_metrics.set_registry(prev)
    out["plan_keys"] = _mesh_keys([plan_key(h, "bfs", 1)
                                   for h in (g, gg, gx)])
    return out


def test_partition_quality_gauges_published():
    if not obs_metrics.enabled():
        pytest.skip("metrics disabled")
    gs = port_graph(8).shard(cpu_mesh(3))
    reg = obs_metrics.get_registry()
    for name, want in (("partition_balance", gs.partitioned.balance()),
                       ("partition_edge_cut", gs.partitioned.edge_cut())):
        assert reg.get(name).value(orientation="forward", shards=3) == want


# -- the GCN with shardmap_agg_axes on 4 slots ---------------------------------

GCN_N = 128
GCN_CFG = GNNConfig(name="t", n_layers=2, d_hidden=8, norm="sym", d_in=16,
                    n_classes=4, use_b2sr=True,
                    shardmap_agg_axes=("data",))


@functools.lru_cache(maxsize=None)
def ref_gcn():
    rcfg = RGNNConfig(name="t", family="gcn", n_layers=2, d_hidden=8,
                      norm="sym", d_in=16, n_classes=4, use_b2sr=True)
    rbatch = r_full_graph_batch(rcfg, GCN_N, pattern="block", seed=0)
    params = rgcn.init_params(rcfg, jax.random.PRNGKey(0))
    (loss, _), grads = jax.value_and_grad(
        lambda p: rgcn.loss_fn(p, rbatch, rcfg), has_aux=True)(params)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return as_np(params), float(loss), as_np(grads)


def assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@needs_reference
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_gcn_step_on_four_slots_matches_reference(backend, combine):
    params, rloss, rgrads = ref_gcn()
    batch = full_graph_batch(GCN_CFG, GCN_N, pattern="block", seed=0,
                             device="cpu")
    graph = batch.graph.with_backend(backend)
    if combine == "gather":                # through the prepared cache
        layers.prepare_sharded(graph, ("data",), mesh=cpu_mesh(4))
    else:                                  # a graph sharded by the caller
        graph = graph.shard(cpu_mesh(4), combine=combine)
    batch = dataclasses.replace(batch, graph=graph)
    p0 = convert.gcn_state_from_reference(params, device="cpu")
    before = dispatch.stats["resolves"]
    (loss, _), grads = train_steps.value_and_grad(
        train_steps.gnn_loss_fn(GCN_CFG), p0, batch)
    assert dispatch.stats["resolves"] > before and dispatch.last_key[6]
    np.testing.assert_allclose(float(loss), rloss, rtol=RTOL, atol=ATOL)
    assert_close(grads, convert.gcn_state_from_reference(rgrads,
                                                         device="cpu"))
    # one train step: its loss, and its update equal to the optimizer's
    # update from the reference's gradients
    ocfg = opt.OptimizerConfig(name="adamw", lr=1e-2)
    state = opt.init(ocfg, p0)
    new, _, metrics = train_steps.gnn_train_step(GCN_CFG, ocfg)(
        p0, state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), rloss, rtol=RTOL,
                               atol=ATOL)
    want, _, _ = opt.update(ocfg, convert.gcn_state_from_reference(
        rgrads, device="cpu"), state, p0)
    assert_close(new, want)


# -- errors ---------------------------------------------------------------------

def _row_chunk_calls(gs):
    x = torch.ones(N)
    return (lambda: gs.mxv(x, row_chunk=4),
            lambda: gs.vxm(BitVector.pack(x, 8), row_chunk=4),
            lambda: gs.mxm(torch.ones(N, 3), row_chunk=4),
            lambda: gs.tri_count(row_chunk=4))


@pytest.mark.parametrize("case", ("csr_shard", "csr_view", "exchange_axes",
                                  "row_chunk", "debug_mesh", "no_cuda",
                                  "missing_row", "bad_combine"))
def test_errors(case):
    g = port_graph(8)
    gs = g.shard(cpu_mesh(2))
    if case == "csr_shard":
        with pytest.raises(ValueError, match="csr"):
            g.with_backend("csr").shard(cpu_mesh(2))
    elif case == "csr_view":
        with pytest.raises(ValueError, match="unshard"):
            gs.with_backend("csr")
        assert gs.unshard().with_backend("csr").backend == "csr"
    elif case == "exchange_axes":
        two = make_mesh((2, 2), ("a", "b"), ["cpu"] * 4)
        with pytest.raises(ValueError, match="one mesh axis"):
            g.shard(two, ("a", "b"), combine="exchange")
        assert g.shard(two, ("a", "b")).partitioned.n_shards == 4
    elif case == "row_chunk":
        before = dispatch.stats["resolves"]
        for op, call in zip(("mxv", "mxv", "mxm", "mxm_sum"),
                            _row_chunk_calls(gs)):
            with pytest.raises(ValueError, match=f"{op}: row_chunk"):
                call()
        assert dispatch.stats["resolves"] == before    # nothing staged
        assert g.mxv(torch.ones(N), row_chunk=1) is not None
    elif case == "debug_mesh":
        with pytest.raises(ValueError, match="not divisible"):
            make_debug_mesh(6, model=4, devices=["cpu"] * 8)
        assert make_debug_mesh(8, model=4,
                               devices=["cpu"] * 8).devices.shape == (2, 4)
    elif case == "no_cuda":
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default mesh is valid")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((-1,), ("data",))
    elif case == "missing_row":
        with pytest.raises(NotImplementedError, match="unshard"):
            dispatch.resolve("mxv", "bitvec", "bin", "csr", True, False,
                             True)
    else:
        with pytest.raises(ValueError, match="combine"):
            g.shard(cpu_mesh(2), combine="broadcast")


# -- the server's sharded views and warmup ---------------------------------------

def make_server():
    return GraphQueryServer(planner=PlanCache(),
                            config=ServerConfig(backoff_base_s=0.0),
                            clock=lambda: 100.0, sleep=lambda s: None)


def test_server_csr_view_unshards():
    gs = sharded(8, "b2sr_cuda", 4, "exchange")
    view = make_server()._backend_view(gs, "csr")
    assert view.backend == "csr" and not view.sharded
    levels = bfs(view, 7).levels
    assert torch.equal(levels, bfs(gs, 7).levels)


def test_sharded_recipe_replays_on_sharded_graph_only(tmp_path):
    path = str(tmp_path / "warm.json")
    gs = sharded(8, "b2sr_cuda", 4, "gather")
    srv = make_server()
    for s in (1, 9):
        srv.bfs(gs, s)
    srv.flush()
    assert srv.save_warmup(path) == 1
    assert all(r["sharded"] is True for r in warmup_mod.load(path))
    fresh = make_server()
    fresh.register(gs)
    assert fresh.warmup(path) == 1 and fresh.planner.misses == 1
    assert fresh.planner.keys()[0].mesh is not None
    plain = make_server()
    plain.register(port_graph(8, "b2sr_cuda"))
    assert plain.warmup(path) == 0 and plain.stats["warmup_skipped"] == 1


# -- the tests that wait for the reference's processes ------------------------------

#: (tile dim, shards, slots, combine): at t = 8 (13 tile rows) every
#: shard count on one repeated slot with gather, and where a plan exists
#: (more than one shard) with exchange, and 3 and 4 distinct host slots
#: (``cpu:i``); at t = 32 (4 tile rows) 1, 3 and 8 shards (8: empty
#: blocks)
ROW_CASES = ([(8, p, "same", "gather") for p in SHARDS]
             + [(8, p, "same", "exchange") for p in SHARDS if p > 1]
             + [(8, p, "distinct", c) for p in (3, 4) for c in COMBINES]
             + [(32, p, "same", c) for p in (1, 3, 8) for c in COMBINES
                if p > 1 or c == "gather"])


@needs_reference
@pytest.mark.parametrize("t,p,slots,combine", ROW_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_rows_match_unsharded_reference(backend, t, p, slots,
                                                combine):
    want = ref_rows(t)
    o = port_operands(t)
    # b2sr_cuda registers one function for both bucket flags
    for buckets in (True, False) if backend == "b2sr" else (True,):
        g = sharded(t, backend, p, combine, slots).with_buckets(buckets)
        for name, (call, exact) in ROWS.items():
            got = port_value(call(g, o, SEMIRINGS, Descriptor))
            assert_row(name, got, want[name], exact)
        # every row resolved to a sharded key
        assert dispatch.last_key[6] and dispatch.last_key[4] == buckets
    if p == 1:                    # one shard: exchange has no plan
        assert sharded(t, backend, 1, "exchange").xplan is None


@needs_reference
@pytest.mark.parametrize("p,combine", ((4, "gather"), (3, "exchange")))
@pytest.mark.parametrize("backend", BACKENDS)
def test_algorithms_match_unsharded_reference(backend, p, combine):
    want = _background("algorithms")
    g = sharded(8, backend, p, combine)
    for d in ("push", "pull", "auto"):
        assert np.array_equal(bfs(g, 7, direction=d).levels.numpy(),
                              want[f"bfs/{d}"]), d
    assert np.array_equal(sssp(g, 7).distances.numpy(), want["sssp"])
    np.testing.assert_allclose(pagerank(g).ranks.numpy(), want["pagerank"],
                               rtol=SUM_RTOL, atol=1e-7)
    assert np.array_equal(connected_components(
        g, direction="auto").labels.numpy(), want["cc"])
    assert triangle_count(g) == want["tc"]
    for w, got in zip(want["khop"],
                      port_value(khop_reachability(g, 2).reach)):
        assert np.array_equal(w, got)
    assert np.array_equal(msbfs(g, SOURCES).levels.numpy(), want["msbfs"])


@needs_reference
@pytest.mark.skipif(not obs_metrics.enabled(), reason="metrics disabled")
@pytest.mark.parametrize("backend", BACKENDS)
def test_comm_counters_and_plan_keys_match_reference(backend):
    want = _background("comm")
    got = port_comm(backend)
    assert got == want
    # the plan keys: unsharded None; gather and exchange apart
    assert got["plan_keys"][0] is None
    assert got["plan_keys"][1][-1] == "gather"
    assert got["plan_keys"][2][-1] == "exchange"
    g = port_graph(8, backend)
    k3 = plan_key(g.shard(cpu_mesh(3)), "bfs", 1).mesh
    k4 = plan_key(sharded(8, backend, 4, "gather"), "bfs", 1).mesh
    two = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    k22 = plan_key(g.shard(two, ("data",)), "bfs", 1).mesh
    assert len({k3, k4, k22}) == 3
