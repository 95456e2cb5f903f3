"""PyTorch port vs the JAX reference: the dry run's cells, its op counter
and one dry-run cell end to end.

  - cells: every ``all_cells()`` pair (LM, GNN and DIN) on the 16 × 16
    and 2 × 16 × 16 meshes, built by the port's ``launch.specs`` and by
    the reference's (the reference reads only ``axis_names`` and the
    shape of ``devices``, so a stand-in mesh serves): ``kind``,
    ``donate``, ``meta``, the parameter count, and every non-parameter
    argument's shape, dtype and spec equal (the reference's ``uint32``
    bit tiles are the port's ``int32`` words);
  - op counter: on ``tests/test_hlo_cost.py``'s cases (a 128×512×256
    matmul, a batched einsum, a loop of 7 matmuls) the port's flops equal
    ``analyze_hlo``'s within 1% (5% for the loop: the reference counts
    the loop counter's arithmetic too); and, under a fake world of 8
    ranks, the wire bytes of an all-reduce, an all-gather and a
    reduce-scatter equal the ring-factor formula;
  - ``dryrun.run_cell`` on reduced phi4-mini cells (train_4k and
    decode_32k at 2 layers, d 64) in a fake (4, 2) world, in a
    subprocess: every field of the record exists and the argument bytes
    equal the sum of the local shards that ``rules.local_shape`` gives.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs import all_cells as ref_all_cells
    from repro.launch import specs as rspecs
    from repro.launch.hlo_cost import analyze_hlo
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import configs  # noqa: E402
from repro_torch.launch import op_cost, specs  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

pytestmark = pytest.mark.skipif(jnp is None,
                                reason="the JAX reference package needs jax")

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
               d_ff=128, vocab_size=256)
_DTYPES = {"int32": torch.int32, "uint32": torch.int32,
           "float32": torch.float32, "bfloat16": torch.bfloat16,
           "bool": torch.bool}


def norm(spec):
    """Each entry of a spec as a tuple of axis names (``None`` → ``()``)."""
    if spec is None:
        return None
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in tuple(spec))


def same_arg(got, want, what):
    """A reference ShapeDtypeStruct / None against a port meta tensor."""
    if want is None:
        assert got is None, what
        return
    assert tuple(got.shape) == tuple(want.shape), what
    assert got.dtype == _DTYPES[str(want.dtype)], what


def same_tree(got, want, got_spec, want_spec, what):
    """Field by field: a GraphBatch / DINBatch / MeshSpec / B2SREll of the
    reference against the port's dict, named tuple or dataclass."""
    if hasattr(want, "shape") or want is None:
        same_arg(got, want, what)
        if want is not None:
            assert norm(got_spec) == norm(want_spec), what
        return
    fields = ([f for f in want.__dataclass_fields__] if hasattr(
        want, "__dataclass_fields__") else list(want._fields))
    for f in fields:
        w = getattr(want, f)
        g = got[f] if isinstance(got, dict) else getattr(got, f)
        gs = (got_spec[f] if isinstance(got_spec, dict)
              else getattr(got_spec, f))
        if isinstance(w, (int, np.integer)):
            assert g == w, (what, f)
            continue
        same_tree(g, w, gs, getattr(want_spec, f), f"{what}.{f}")


def n_leaves(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cells_match_reference(mesh):
    names, shape = MESHES[mesh]
    rmesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    pmesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    cells = list(configs.all_cells())
    assert cells == list(ref_all_cells())
    assert len(list(configs.all_cells(include_skipped=True))) == \
        len(cells) + len(configs.SKIPPED_CELLS)
    for arch, shape_id in cells:
        want = rspecs.build_cell(arch, shape_id, rmesh)
        got = specs.build_cell(arch, shape_id, pmesh)
        what = f"{arch} × {shape_id}"
        assert (got.kind, got.donate, got.meta) == (want.kind, want.donate,
                                                    want.meta), what
        assert sum(v.numel() for v in got.args[0].values()) == \
            n_leaves(want.args[0]), what
        if got.kind == "train" and isinstance(got.args[1], tuple):
            assert norm(got.in_specs[1].step) == norm(want.in_specs[1].step)
            assert (got.args[1].v is None) == (want.args[1].v is None)
            rest = 2
        else:
            rest = 1
        for i, (g, w) in enumerate(zip(got.args[rest:], want.args[rest:])):
            same_tree(g, w, got.in_specs[rest + i], want.in_specs[rest + i],
                      f"{what} arg {rest + i}")
        if want.out_specs is None:
            assert got.out_specs is None, what
        elif got.kind in ("prefill", "decode"):
            flat = jax.tree_util.tree_leaves(
                want.out_specs[1:], is_leaf=lambda x: isinstance(x, P))
            got_flat = [s for s in (got.out_specs[1:] if got.kind == "decode"
                                    else got.out_specs[1])]
            assert [norm(s) for s in got_flat] == [norm(s) for s in flat], \
                what


def test_input_specs_are_the_args():
    pmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(16, 16))
    args = specs.input_specs("phi4-mini-3.8b", "decode_32k", pmesh)
    assert all(a.device.type == "meta" for a in args[1:])
    assert tuple(args[2].shape) == (32, 128, 32768, 8, 128)


# -- the op counter ------------------------------------------------------------------

def _hlo_flops(fn, *shapes):
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text()).flops


def _port_flops(fn, *shapes):
    xs = [torch.randn(s) for s in shapes]
    with op_cost.counting(live=xs) as rep:
        fn(*xs)
    return rep


def test_matmul_flops_match_reference():
    rep = _port_flops(lambda a, b: a @ b, (128, 512), (512, 256))
    assert rep.flops == 2 * 128 * 256 * 512
    assert rep.flops == pytest.approx(
        _hlo_flops(lambda a, b: a @ b, (128, 512), (512, 256)), rel=0.01)
    assert rep.wire_bytes == 0 and rep.hbm_bytes >= 4 * (
        128 * 512 + 512 * 256 + 128 * 256)
    assert rep.peak_bytes >= 4 * (128 * 512 + 512 * 256 + 128 * 256)


def test_batched_einsum_flops_match_reference():
    def f(a, b):
        return (torch.einsum("bij,bjk->bik", a, b) if isinstance(a, torch.Tensor)
                else jnp.einsum("bij,bjk->bik", a, b))
    rep = _port_flops(f, (4, 32, 64), (4, 64, 16))
    assert rep.flops == pytest.approx(_hlo_flops(f, (4, 32, 64),
                                                 (4, 64, 16)), rel=0.01)
    assert rep.flops == 2 * 4 * 32 * 16 * 64


def test_loop_of_matmuls_flops_match_reference():
    L, D = 7, 128

    def ref(x, ws):
        def body(h, w):
            return h @ w, ()
        return jax.lax.scan(body, x, ws)[0]

    def port(x, ws):
        for i in range(L):
            x = x @ ws[i]
        return x

    rep = _port_flops(port, (D, D), (L, D, D))
    assert rep.flops == L * 2 * D ** 3
    assert rep.flops == pytest.approx(_hlo_flops(ref, (D, D), (L, D, D)),
                                      rel=0.05)


def test_elementwise_counts_one_flop_per_element():
    rep = _port_flops(lambda a: torch.exp(a) * 2.0 + 1.0, (64, 32))
    assert rep.flops == 3 * 64 * 32


# -- fake worlds, in a subprocess ----------------------------------------------------

_SCRIPT = textwrap.dedent('''
    import json, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.mesh import fake_world

    out = {}
    with fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        local = torch.empty(64, 32, device="meta")
        cases = {"all-reduce": ((Replicate(), Partial()),
                                (Replicate(), Replicate())),
                 "all-gather": ((Replicate(), Shard(0)),
                                (Replicate(), Replicate())),
                 "reduce-scatter": ((Replicate(), Partial()),
                                    (Replicate(), Shard(0)))}
        for name, (src, dst) in cases.items():
            x = DTensor.from_local(local if src[1] != Shard(0) else
                                   torch.empty(32, 32, device="meta"),
                                   mesh, src, run_check=False,
                                   shape=(64, 32), stride=(32, 1))
            with op_cost.counting() as rep:
                x.redistribute(mesh, dst)
            out[name] = rep.wire_by_op
    for shape in ("train_4k", "decode_32k"):
        dryrun.run_cell("phi4-mini-3.8b", shape, False, sys.argv[1],
                        overrides=json.loads(sys.argv[2]), mesh_shape=(4, 2))
    print("WIRE " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def fake_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(d),
                        json.dumps(REDUCED)], capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": "src"})
    return r, d


def test_collective_wire_bytes_follow_ring_factors(fake_run):
    r, _ = fake_run
    assert r.returncode == 0, r.stderr[-3000:]
    wire = json.loads(r.stdout.split("WIRE ", 1)[1].splitlines()[0])
    full = 64 * 32 * 4
    assert wire["all-reduce"] == {"all-reduce": 2 * full}
    assert wire["all-gather"] == {"all-gather": full}
    # reduce-scatter: the result (half of the full tensor) × the group (2)
    assert wire["reduce-scatter"] == {"reduce-scatter": (full // 2) * 2}


@pytest.mark.parametrize("shape_id", ("train_4k", "decode_32k"))
def test_run_cell_record(fake_run, shape_id):
    r, d = fake_run
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((d / f"phi4-mini-3.8b__{shape_id}__4x2.json")
                     .read_text())
    for key in ("arch", "shape", "kind", "mesh", "n_chips", "seconds",
                "layers_counted", "memory", "flops_per_device",
                "bytes_per_device", "ops_per_device", "collectives", "meta",
                "status"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["n_chips"] == 8
    assert rec["layers_counted"] == 2
    assert rec["flops_per_device"] > 0 and rec["ops_per_device"] > 0
    assert rec["collectives"]["per_device_wire_bytes"] > 0
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(4, 2))
    cell = specs.build_cell("phi4-mini-3.8b", shape_id, mesh,
                            overrides=REDUCED)
    want = 0

    def walk(tree, spec):
        nonlocal want
        if tree is None:
            return
        if isinstance(tree, torch.Tensor):
            want += math.prod(rules.local_shape(tree.shape, mesh, spec)) \
                * tree.element_size()
            return
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k])
            return
        for t, s in zip(tree, spec):
            walk(t, s)

    walk(cell.args, cell.in_specs)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_bytes"] >= want
    assert rec["meta"] == json.loads(json.dumps(cell.meta))


def test_gnn_and_din_cells_are_not_ported():
    from repro_torch.launch import dryrun
    with pytest.raises(NotImplementedError, match="10.4"):
        dryrun.run_cell("gcn-cora", "full_graph_sm", False, "")
    with pytest.raises(NotImplementedError, match="10.4"):
        dryrun.run_cell("din", "train_batch", False, "")
