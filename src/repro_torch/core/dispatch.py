"""Central kernel-dispatch registry for the generic GraphBLAS API.

Every compute path registers its implementations here at import time,
keyed by the full Table II/III coordinate (the reference's key):

    (op, rhs, out, backend, bucketed, masked, sharded)

  op        "mxv" | "mxm" | "mxm_sum" (the fused masked Σ mask ⊙ (A·B)
            reduction of ``tri_count``, masked-only) | "mxv_pull" /
            "mxm_pull" (the pull traversal rows over a ``BitVector`` /
            ``FrontierBatch``, masked-only, selected by
            ``Descriptor(direction="pull")``)
  rhs       operand kind of the right-hand side: "dense" | "bitvec" |
            "frontier" (a FrontierBatch) | "bitmat" (a BitMatrix) |
            "graph" (a GraphMatrix) | "tri" (the memoized lower-triangle
            operand of ``tri_count``)
  out       "bin" (packed words; a B2SR for SpGEMM) | "full" (dense
            values)
  backend   "b2sr" (torch word schemes, ``repro_torch.core.ops``)
            | "b2sr_cuda" (hand-written CUDA kernels,
            ``repro_torch.kernels.*.ops``) | "csr" (float CSR baseline)
  bucketed  whether the SELL-style row-bucketed path is active
  masked    whether a §V output mask is applied
  sharded   whether the graph is row-partitioned over a mesh
            (``GraphMatrix.shard``): the rows of
            ``repro_torch.core.ops_sharded``, for the b2sr backends only

Implementations have the signature ``fn(g, rhs, call)`` and return the
raw result: packed words, dense values, a B2SR (boolean SpGEMM) or an
int64 scalar (``mxm_sum``). Backend modules are imported
on the first lookup for that backend.

Two hooks watch resolutions, as in the reference: the resolve hook
(``set_resolve_hook``, the fault injector's) may abort one, the observe
hook (``set_observe_hook``, ``repro_torch.obs``'s counter) sees each one,
aborted or not. The reference resolves while it traces: once per key per
algorithm call, once per key when a plan is built, never on a warm plan.
The port resolves on every ``GraphMatrix`` call, so every loop iteration;
a **resolution scope** (:func:`scoped`, a ``contextvars`` variable) makes
the hooks fire where the reference's would. A public algorithm call, a
bare ``GraphMatrix`` call and a plan's first call each open one; within
it the hooks fire on the first resolution of each key only, and a warm
plan's calls (:func:`muted`) fire none. ``stats`` still counts every
resolution.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import importlib
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from repro_torch.core.semiring import Semiring

Key = Tuple[str, str, str, str, bool, bool, bool]

OPS = ("mxv", "mxm", "mxm_sum", "mxv_pull", "mxm_pull")

#: Ops whose rows exist only with a mask: the fused TC reduction is
#: masked by construction, and pull without the visited mask has nothing
#: to exit on.
MASKED_ONLY_OPS = ("mxm_sum", "mxv_pull", "mxm_pull")
RHS_KINDS = ("dense", "bitvec", "frontier", "bitmat", "graph", "tri")
OUT_KINDS = ("bin", "full")

_REGISTRY: Dict[Key, Callable] = {}

_BACKEND_MODULES: Dict[str, Tuple[str, ...]] = {
    "b2sr": ("repro_torch.core.ops",),
    "b2sr_cuda": ("repro_torch.kernels.bmv.ops",
                  "repro_torch.kernels.bmm.ops",
                  "repro_torch.kernels.spgemm.ops",
                  "repro_torch.kernels.spmm.ops"),
    "csr": ("repro_torch.core.csr_backend",),
}
#: the sharded rows of the b2sr backends, loaded with them
_SHARDED_MODULE = "repro_torch.core.ops_sharded"

BACKENDS = tuple(_BACKEND_MODULES)
_LOADED: set = set()

#: Dispatch counters, as the reference's: callers check that an op
#: resolved through here, and which row it resolved last.
stats = {"resolves": 0}
last_key: Optional[Key] = None


class InjectedFault(RuntimeError):
    """A deterministic fault raised through the resolve hook.

    Stands in for a real kernel or backend failure (a build error, a
    launch error, device loss), so that the serving layer's fallback and
    circuit breakers can be tested without one. Raised by the engine's
    :class:`~repro_torch.engine.faults.FaultInjector` once it is installed
    with :func:`set_resolve_hook`.
    """


_RESOLVE_HOOK: Optional[Callable[[Key], None]] = None


def set_resolve_hook(hook: Optional[Callable[[Key], None]]
                     ) -> Optional[Callable[[Key], None]]:
    """Install (or clear, with ``None``) the resolve hook; returns the
    previous one.

    The hook is called with the full key on a successful :func:`resolve`
    (once per key per resolution scope) and may raise, typically
    :class:`InjectedFault`, to make that resolution fail where a broken
    kernel would.
    """
    global _RESOLVE_HOOK
    prev = _RESOLVE_HOOK
    _RESOLVE_HOOK = hook
    return prev


_OBSERVE_HOOK: Optional[Callable[[Key, float, Optional[BaseException]],
                                 None]] = None


def set_observe_hook(hook: Optional[Callable[[Key, float,
                                              Optional[BaseException]],
                                             None]]
                     ) -> Optional[Callable]:
    """Install (or clear) the read-only observe hook; returns the previous
    one.

    Called as ``hook(key, duration_s, err)`` wherever the resolve hook
    would be, and also when that hook aborted the resolution (``err`` is
    what it raised) or the row is missing (``err`` is the
    :class:`NotImplementedError`). ``duration_s`` is the resolve time, the
    backend's lazy import included. Anything it raises is swallowed:
    observation cannot change what runs. ``repro_torch.obs`` installs a
    registry counter on import.
    """
    global _OBSERVE_HOOK
    prev = _OBSERVE_HOOK
    _OBSERVE_HOOK = hook
    return prev


def _observe(key: Key, t0: float, err: Optional[BaseException]) -> None:
    if _OBSERVE_HOOK is None:
        return
    try:
        _OBSERVE_HOOK(key, time.perf_counter() - t0, err)
    except Exception:                        # noqa: BLE001 — read-only hook
        pass


class _Scope:
    """The keys whose hooks fired in one resolution scope; a muted scope
    fires none."""

    __slots__ = ("seen", "muted")

    def __init__(self, muted: bool = False):
        self.seen: set = set()
        self.muted = muted


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_resolution_scope", default=None)


@contextlib.contextmanager
def _scope(muted: bool = False):
    token = _SCOPE.set(_Scope(muted))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def scoped(fn: Callable) -> Callable:
    """Decorator: ``fn`` runs in a resolution scope, its own unless one is
    open already (a public algorithm call, a bare ``GraphMatrix`` call)."""

    @functools.wraps(fn)
    def inner(*args, **kw):
        if _SCOPE.get() is not None:
            return fn(*args, **kw)
        with _scope():
            return fn(*args, **kw)

    return inner


def fresh_scope():
    """A new resolution scope, even inside another (a plan's first call:
    the reference traces each plan on its own)."""
    return _scope()


def muted():
    """A scope in which no resolution fires a hook (a warm plan's call:
    the reference's compiled plan resolves nothing)."""
    return _scope(muted=True)


@dataclasses.dataclass
class OpCall:
    """The normalized per-call context handed to registered impls.

    ``mask`` is already in the row's raw form (packed words for packed
    outputs, a dense tensor for dense outputs).
    """

    semiring: Semiring
    mask: Any = None
    complement: bool = False
    row_chunk: Optional[int] = None
    a_value: float = 1.0
    out_dtype: torch.dtype = torch.float32


BOTH = (False, True)


def _iter_flags(v: Union[bool, Iterable[bool]]) -> Tuple[bool, ...]:
    return (v,) if isinstance(v, bool) else tuple(v)


def register(op: str, rhs: str, out: str, backend: str,
             bucketed: Union[bool, Iterable[bool]] = BOTH,
             masked: Union[bool, Iterable[bool]] = BOTH,
             sharded: Union[bool, Iterable[bool]] = False):
    """Decorator: register ``fn`` for every (bucketed, masked, sharded)
    combination. ``sharded`` defaults to False: single-device rows never
    see the flag; the sharded twins in ``repro_torch.core.ops_sharded``
    register with ``sharded=True``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if rhs not in RHS_KINDS:
        raise ValueError(f"unknown rhs kind {rhs!r}")
    if out not in OUT_KINDS:
        raise ValueError(f"unknown out kind {out!r}")

    def deco(fn: Callable) -> Callable:
        for b in _iter_flags(bucketed):
            for m in _iter_flags(masked):
                for s in _iter_flags(sharded):
                    key: Key = (op, rhs, out, backend, b, m, s)
                    if key in _REGISTRY:
                        raise ValueError(
                            f"duplicate registration for {key}")
                    _REGISTRY[key] = fn
        return fn

    return deco


def _ensure_backend(backend: str) -> None:
    if backend in _LOADED:
        return
    for mod in _BACKEND_MODULES.get(backend, ()):
        importlib.import_module(mod)
    if backend != "csr":
        importlib.import_module(_SHARDED_MODULE)
    _LOADED.add(backend)


def resolve(op: str, rhs: str, out: str, backend: str, bucketed: bool,
            masked: bool, sharded: bool = False) -> Callable:
    """Look up the implementation for one fully-specified Table row."""
    global last_key
    t0 = time.perf_counter()
    key: Key = (op, rhs, out, backend, bucketed, masked, sharded)
    _ensure_backend(backend)
    fn = _REGISTRY.get(key)
    scope = _SCOPE.get()
    hooked = (_RESOLVE_HOOK is not None or _OBSERVE_HOOK is not None) and (
        scope is None or not (scope.muted or key in scope.seen))
    if hooked and scope is not None:
        scope.seen.add(key)
    if fn is None:
        hint = (" (sharded rows exist only for the b2sr backends — "
                "call GraphMatrix.unshard() for this op)" if sharded else "")
        err = NotImplementedError(
            f"no kernel registered for op={op} rhs={rhs} out={out} "
            f"backend={backend} bucketed={bucketed} masked={masked} "
            f"sharded={sharded}{hint}; registered rows: "
            f"{sorted(k for k in _REGISTRY if k[0] == op)}")
        if hooked:
            _observe(key, t0, err)
        raise err
    if hooked:
        if _RESOLVE_HOOK is not None:
            try:
                _RESOLVE_HOOK(key)
            except BaseException as e:
                # the observe hook still sees the aborted resolution:
                # injected faults land in the telemetry as real ones would
                _observe(key, t0, e)
                raise
        _observe(key, t0, None)
    stats["resolves"] += 1
    last_key = key
    return fn


def registered_keys(load_all: bool = False) -> Tuple[Key, ...]:
    """All registered keys (optionally forcing every backend module in)."""
    if load_all:
        for backend in _BACKEND_MODULES:
            _ensure_backend(backend)
    return tuple(sorted(_REGISTRY))


def out_kind_for(semiring: Semiring, rhs: str) -> str:
    """Boolean ⊕.⊗ over a packed operand stays packed; else full values."""
    if semiring.name == "boolean" and rhs in ("bitvec", "frontier", "graph"):
        return "bin"
    return "full"


#: Semirings each (op, rhs) pair can honor (dense-rhs mxv accepts all);
#: the reference's table, the rows of later slices included.
SEMIRING_ROWS = {
    ("mxv", "bitvec"): ("boolean", "arithmetic"),
    ("mxm", "dense"): ("arithmetic",),
    ("mxm", "frontier"): ("boolean",),
    ("mxm", "bitmat"): ("arithmetic",),
    ("mxm", "graph"): ("boolean", "arithmetic"),
    ("mxv_pull", "bitvec"): ("boolean",),
    ("mxm_pull", "frontier"): ("boolean",),
}


def check_semiring(op: str, rhs: str, semiring: Semiring) -> None:
    """Reject semirings the resolved Table row cannot honor."""
    allowed = SEMIRING_ROWS.get((op, rhs))
    if allowed is not None and semiring.name not in allowed:
        raise NotImplementedError(
            f"{op} over a {rhs} operand supports only the {allowed} "
            f"semiring(s), got {semiring.name!r}")


def reject_sharded_row_chunk(op: str, row_chunk) -> None:
    """Raise on ``row_chunk`` with a sharded graph *before* any operand
    staging: the row partition already bounds each shard's memory, so the
    sharded rows do not chunk. ``GraphMatrix.mxv``/``mxm``/``tri_count``
    call this first, so the error is immediate and names the op."""
    if row_chunk is not None:
        raise ValueError(
            f"{op}: row_chunk is not supported on the sharded path — the "
            "row partition already bounds per-device memory (unshard() "
            "first if chunked evaluation is required)")


def apply_output_mask(y: torch.Tensor, mask: torch.Tensor, complement: bool,
                      identity) -> torch.Tensor:
    """§V mask-at-store for dense outputs: masked-out entries → identity."""
    keep = (mask == 0) if complement else (mask != 0)
    return torch.where(keep, y, torch.as_tensor(identity, device=y.device))
