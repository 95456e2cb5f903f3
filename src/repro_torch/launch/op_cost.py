"""Per-device cost of one run of a step, counted from the aten operations
it dispatches: the port's counterpart of ``repro.launch.hlo_cost``.

There is no compiled program to parse, so the three roofline inputs are
counted while the step runs (over meta tensors in the dry run, so
nothing is allocated), through ``obs.cost``'s dispatch mode. Over
DTensors that mode sees each operation as it runs on one rank's local
tensors, and the collectives DTensor issues, so every count is one
rank's:

  flops       2·M·N·K for every ``mm``/``addmm``/``bmm``/``baddbmm``
              (the matmul family: ``linear``, ``matmul`` and ``einsum``
              reach these) and 1 per result element of the elementwise
              operations of the reference's ``_ARITH`` set.
  bytes       operands plus results of every operation that is not a
              view (``obs.cost``'s rule). Eager PyTorch does not fuse,
              so this is larger than the reference's count at XLA's
              fusion boundaries: each elementwise step reads and writes
              its tensors through memory.
  wire_bytes  for every ``c10d_functional`` collective, its result bytes
              times the reference's ring factor: all-reduce 2×,
              reduce-scatter × the group, the others 1×.
  peak_bytes  the most bytes of tensor storage alive at once: the
              arguments' storages, and every storage an operation made
              from its first appearance until it is freed (a weak
              reference's finalizer). The caching allocator's rounding
              and fragmentation are not modelled.

Each layer is its own module, so no loop needs a trip-count multiplier.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Iterator

import torch

from repro_torch.obs.cost import op_counter

#: aten elementwise operations counted at 1 flop per result element (the
#: reference's ``_ARITH`` HLO opcodes; ``_to_copy`` is its ``convert``)
ARITH = frozenset({
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum",
    "exp", "exp2", "expm1", "log", "log1p", "tanh", "rsqrt", "sqrt",
    "reciprocal", "neg", "abs", "sign", "floor", "ceil", "round",
    "sigmoid", "sin", "cos", "atan2", "remainder", "fmod", "eq", "ne",
    "lt", "le", "gt", "ge", "where", "clamp", "clamp_min", "clamp_max",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_not", "_to_copy", "isfinite",
    "erf", "silu", "gelu",
})

#: the matmul family: the operand whose last dim is contracted
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}

#: c10d functional collectives under the reference's names
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    wire_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    n_ops: int = 0


def _tensors(tree) -> Iterator[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def _collective(func):
    """The reference's name of a functional collective, or None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional"):
        return None
    base = func._overloadpacket.__name__.rstrip("_")
    for name, ref in _COLLECTIVES.items():
        if base == name or base.startswith(name + "_"):
            return ref
    return None


class _Live:
    """Bytes of tensor storage alive, and their peak."""

    def __init__(self):
        from torch.utils.weak import WeakIdKeyDictionary
        self.seen = WeakIdKeyDictionary()
        self.now = self.peak = 0

    def add(self, tensors: Iterable[torch.Tensor]) -> None:
        import weakref
        for t in tensors:
            st = t.untyped_storage()
            if st in self.seen:
                continue
            n = st.nbytes()
            self.seen[st] = n
            self.now += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.now)

    def _free(self, n: int) -> None:
        self.now -= n


@contextlib.contextmanager
def counting(live: Iterable[torch.Tensor] = ()):
    """Count every operation run inside into the yielded
    :class:`CostReport` (filled in on exit). ``live``: the tensors alive
    at the start (the arguments; DTensors count their local shard)."""
    from repro_torch.sharding import spmd
    report = CostReport()
    mem = _Live()
    mem.add(x.to_local() if spmd.is_dtensor(x) else x for x in live)

    def on_op(func, args, kwargs, out):
        report.n_ops += 1
        name = func._overloadpacket.__name__
        coll = _collective(func)
        if coll is not None:
            rb = sum(t.numel() * t.element_size() for t in _tensors(out))
            if coll == "all-reduce":
                wire = 2 * rb
            elif coll == "reduce-scatter":
                wire = rb * int(args[2])          # (input, op, group_size, …)
            else:
                wire = rb
            report.wire_by_op[coll] = report.wire_by_op.get(coll, 0) + wire
            report.wire_bytes += wire
        elif name in _DOTS:
            a = args[_DOTS[name]]
            report.flops += 2.0 * out.numel() * a.shape[-1]
        elif name.rstrip("_") in ARITH:
            report.flops += sum(t.numel() for t in _tensors(out))
        mem.add(_tensors(out))

    count, mode = op_counter(on_op)
    with mode:
        yield report
    report.hbm_bytes = float(count.aten_bytes)
    report.peak_bytes = mem.peak
