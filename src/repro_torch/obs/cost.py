"""Kernel cost accounting: estimated FLOPs/bytes attached to cached plans.

Bit-GraphBLAS §VI attributes its wins kernel by kernel; to do that online
the serving stack needs to know, per cached plan, how much arithmetic and
memory traffic one launch represents — then the launch-latency histograms
in the metrics registry turn into achieved FLOP/s and bytes/s per (op,
backend, tile_dim), comparable against the roofline.

The reference reads these numbers off XLA's optimized HLO. PyTorch has no
compiled program to read, so here a plan's first call, with cost
accounting on, is run once more under counting (:func:`analyze_plan`)
and the count is of what ran. The rule is HLO's "bytes accessed": every
operation adds the bytes of its operands and of its outputs.

  - **aten operations** are counted through a ``TorchDispatchMode``: the
    bytes of every tensor among an operation's arguments and results.
    Operations that only make a view (``view``, ``slice``, ``expand``,
    ...) move nothing and count nothing. FLOPs come from
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products).
  - **hand kernels** launch through ``ctypes``, which neither mode sees,
    so each wrapper that a plan reaches (``spmm_bbb``, ``spmm_dense``,
    ``spmm_bbf``, ``pack_rows``) counts itself (:func:`counted`): the
    bytes of the operands it is handed (the B2SR's three arrays, the
    dense or packed right-hand side, the mask) and of the output it
    returns, and its operations by a rule stated beside the wrapper. A
    kernel gets its rule when it first enters a plan. The wrapper's own
    torch calls
    and, on a CPU tensor, its plain version run with both modes
    suspended, so a plain version counts exactly what the kernel counts.
    Work items and scratch are the kernel's business and do not count.
  - ``wire_bytes`` are the bytes of the comm counts the sharded rows
    record (``core.ops_sharded``: the reference's static element counts
    of its collectives, :func:`add_wire_bytes`); 0 on an unsharded
    graph.

The report lands on ``Plan.cost`` and as ``plan_flops`` /
``plan_hbm_bytes`` / ``plan_wire_bytes`` gauges in the registry; its
``kernels`` entry lists each hand kernel's launches, bytes and operations
(a ``b2sr_cuda`` plan whose kernels count nothing is a fault).

Cost accounting is **off by default** (``set_cost_accounting(True)`` to
enable): the counted run is a second run of the plan's first call, fine
for benchmarks and analysis, not something serving should pay
implicitly. With it off, a plan's first call costs what it did before
this module existed; ``counted`` wrappers pay one list lookup a call.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs import metrics as _metrics

__all__ = ["set_cost_accounting", "cost_accounting_enabled", "analyze_plan",
           "record_plan_cost", "roofline_table", "counted", "nbytes",
           "add_wire_bytes", "op_counter", "COST_LABELS"]

_COST_ENABLED: List[bool] = [False]

#: Labels shared by the plan cost gauges and the launch latency histogram —
#: the join key of :func:`roofline_table`.
COST_LABELS = ("op", "backend", "tile_dim")

#: The count in progress (one :class:`_Count` while a plan is analysed).
_ACTIVE: List[Optional["_Count"]] = [None]


def set_cost_accounting(flag: bool) -> bool:
    """Enable/disable per-plan cost counting; returns the previous value."""
    prev = _COST_ENABLED[0]
    _COST_ENABLED[0] = bool(flag)
    return prev


def cost_accounting_enabled() -> bool:
    return _COST_ENABLED[0] and _metrics.enabled()


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (``None`` entries skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


class _Count:
    """What one counted run moved: aten bytes and FLOPs, and per hand
    kernel its launches, bytes and operations."""

    def __init__(self):
        self.aten_bytes = 0
        self.wire_bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}

    def kernel(self, name: str, n_bytes: int, ops: int) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0,
                                           "ops": 0})
        k["launches"] += 1
        k["bytes"] += int(n_bytes)
        k["ops"] += int(ops)


def _byte_mode(count: _Count, on_op: Optional[Callable] = None):
    """A ``TorchDispatchMode`` adding each aten operation's operand and
    result bytes to ``count`` and, with ``on_op``, calling ``on_op(func,
    args, kwargs, out)`` after every operation (made here, so importing
    this module does not touch torch's private dispatch API).

    An operation on DTensors is left to DTensor (``NotImplemented``),
    which runs it as operations on each rank's local tensors and
    collectives: those come back through this mode, so a count over
    DTensors is one rank's. The meta kernels a ``FakeTensorMode`` runs
    inside its own dispatch (DTensor's shape propagation over global
    shapes) are not counted."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                  # a build without distributed
        DTensor = None

    def tensor_bytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor))

    def in_fake_mode() -> bool:
        # under the fake mode (as an infra mode below this one) or inside
        # its kernel call (older releases stack it above)
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils._python_dispatch import (
            _get_current_dispatch_mode_stack)
        return (torch._C._meta_in_tls_dispatch_include()
                or any(isinstance(m, FakeTensorMode)
                       for m in _get_current_dispatch_mode_stack()))

    class _ByteMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor is not None and any(issubclass(t, DTensor)
                                           for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if in_fake_mode():
                # DTensor's propagation of global shapes through a
                # FakeTensorMode: not the program's work
                return out
            if not func.is_view:
                count.aten_bytes += tensor_bytes((args, kwargs))
                count.aten_bytes += tensor_bytes(out)
            if on_op is not None:
                on_op(func, args, kwargs, out)
            return out

    return _ByteMode()


def op_counter(on_op: Optional[Callable] = None):
    """``(count, mode)``: a dispatch mode counting, while it is entered,
    every aten operation's operand and result bytes into
    ``count.aten_bytes`` (the rule of :func:`analyze_plan`), calling
    ``on_op(func, args, kwargs, out)`` after each (``launch.op_cost``
    counts FLOPs, collectives and live memory there)."""
    count = _Count()
    return count, _byte_mode(count, on_op)


def add_wire_bytes(n_bytes: int) -> None:
    """Add a sharded call's comm bytes to the count in progress, if any."""
    count = _ACTIVE[0]
    if count is not None:
        count.wire_bytes += int(n_bytes)


def counted(io: Callable) -> Callable:
    """Decorator of a hand-kernel wrapper: while a plan is analysed, the
    call adds ``io(out, *args, **kw) -> (bytes, ops)`` under the wrapper's
    name, and runs with the dispatch modes suspended (its torch calls and
    its plain version are the kernel's, counted by ``io``). Otherwise the
    wrapper runs as it is."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            count = _ACTIVE[0]
            if count is None:
                return fn(*args, **kw)
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():
                out = fn(*args, **kw)
                n_bytes, ops = io(out, *args, **kw)
            count.kernel(fn.__name__, n_bytes, ops)
            return out

        return wrapper

    return deco


def analyze_plan(fn, args, kwargs) -> dict:
    """Count one run of ``fn(*args, **kwargs)`` (a plan's loop).

    Returns ``{"flops", "hbm_bytes", "wire_bytes", "compile_s", "aten_bytes",
    "kernels"}``: ``hbm_bytes`` is the aten bytes plus every hand kernel's;
    ``flops`` FlopCounterMode's count plus the kernels' operations;
    ``compile_s`` the counted run's wall time (the reference's AOT compile
    time stands in that slot). An error of the run is the call's error and
    propagates.
    """
    from torch.utils.flop_counter import FlopCounterMode

    count = _Count()
    flop_mode = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    _ACTIVE[0] = count
    try:
        with flop_mode, _byte_mode(count):
            fn(*args, **kwargs)
    finally:
        _ACTIVE[0] = None
    elapsed = time.perf_counter() - t0
    kernel_bytes = sum(k["bytes"] for k in count.kernels.values())
    kernel_ops = sum(k["ops"] for k in count.kernels.values())
    return {"flops": float(flop_mode.get_total_flops() + kernel_ops),
            "hbm_bytes": float(count.aten_bytes + kernel_bytes),
            "wire_bytes": float(count.wire_bytes), "compile_s": elapsed,
            "aten_bytes": float(count.aten_bytes),
            "kernels": count.kernels}


def record_plan_cost(cost: dict, op: str, backend: str,
                     tile_dim: int,
                     registry: Optional[_metrics.MetricsRegistry] = None
                     ) -> None:
    """Publish one plan's cost estimate into the registry gauges."""
    if not _metrics.enabled():
        return
    reg = registry or _metrics.get_registry()
    labels = {"op": op, "backend": backend, "tile_dim": tile_dim}
    reg.gauge("plan_flops", "estimated FLOPs per launch (counted run)",
              COST_LABELS).set(cost["flops"], **labels)
    reg.gauge("plan_hbm_bytes", "estimated HBM bytes per launch",
              COST_LABELS).set(cost["hbm_bytes"], **labels)
    reg.gauge("plan_wire_bytes", "estimated collective bytes per launch",
              COST_LABELS).set(cost["wire_bytes"], **labels)
    reg.histogram("plan_compile_s", "counted-run time of cached plans",
                  COST_LABELS).observe(cost.get("compile_s", 0.0), **labels)


def roofline_table(registry: Optional[_metrics.MetricsRegistry] = None
                   ) -> List[dict]:
    """Join plan cost gauges with launch latency histograms: achieved rates.

    One row per (op, backend, tile_dim) that has both a cost estimate and
    observed launches: mean launch latency, estimated flops/bytes, and the
    achieved FLOP/s and HBM bytes/s those imply — the online version of
    the dry-run roofline fraction.
    """
    reg = registry or _metrics.get_registry()
    flops_g = reg.get("plan_flops")
    bytes_g = reg.get("plan_hbm_bytes")
    lat_h = reg.get("launch_latency_s")
    if flops_g is None or lat_h is None:
        return []
    # aggregate latency over the extra labels (bucketed/sharded) down to
    # the cost join key
    lat_by_key: Dict[tuple, List[float]] = {}
    for key, s in lat_h._series.items():
        labels = dict(zip(lat_h.labelnames, key))
        jk = tuple(labels.get(k, "") for k in COST_LABELS)
        lat_by_key.setdefault(jk, [0.0, 0])
        lat_by_key[jk][0] += s.sum
        lat_by_key[jk][1] += s.count
    # comm-volume counters from the sharded rows carry (op, backend,
    # shards): aggregate over shard counts down to (op, backend), so the
    # gather and exchange word totals land on every matching row
    comm_by_key: Dict[tuple, Dict[str, float]] = {}
    for cname, col in (("gather_words_total", "gathered_words"),
                       ("exchange_words_total", "exchanged_words")):
        c = reg.get(cname)
        if c is None:
            continue
        for key, v in c._series.items():
            labels = dict(zip(c.labelnames, key))
            jk = (labels.get("op", ""), labels.get("backend", ""))
            comm_by_key.setdefault(jk, {})
            comm_by_key[jk][col] = comm_by_key[jk].get(col, 0.0) + float(v)
    rows: List[dict] = []
    for key in sorted(flops_g._series):
        labels = dict(zip(COST_LABELS, key))
        total_s, n = lat_by_key.get(key, (0.0, 0))
        if not n:
            continue
        mean_s = total_s / n
        flops = float(flops_g._series[key])
        hbm = float(bytes_g._series.get(key, 0.0)) if bytes_g else 0.0
        row = {
            **labels,
            "n_launches": n,
            "mean_latency_s": mean_s,
            "est_flops": flops,
            "est_hbm_bytes": hbm,
            "achieved_flops_s": flops / mean_s if mean_s else None,
            "achieved_hbm_bytes_s": hbm / mean_s if mean_s else None,
        }
        comm = comm_by_key.get((labels.get("op", ""),
                                labels.get("backend", "")))
        if comm:
            row.update(comm)
        rows.append(row)
    return rows
