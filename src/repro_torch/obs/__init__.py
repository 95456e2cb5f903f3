"""End-to-end telemetry for the port's serving stack (DESIGN.md §14).

Three legs, one import:

  - **metrics** — a process-local pull-based registry of labeled
    ``Counter`` / ``Gauge`` / ``Histogram`` series plus a bounded event
    log; snapshot-able to a dict, exportable as JSON or Prometheus text.
  - **trace** — per-query ``Trace``/``Span`` objects threaded through
    submit → queue-wait → plan-resolve → launch → scatter-back and
    surfaced on ``QueryHandle.trace``.
  - **cost** — per-plan FLOPs/bytes counted over a plan's first call
    (:mod:`repro_torch.obs.cost`), so launch-latency histograms read out
    as achieved-vs-roofline rates.

Importing :mod:`repro_torch.obs` installs the **dispatch observer** — the
read-only sibling of :func:`repro_torch.core.dispatch.set_resolve_hook` —
which counts and times kernel resolutions (once per key per resolution
scope, where the reference's trace-time resolutions fall; see
``repro_torch.core.dispatch``) and records injected or real resolution
faults into the default registry. ``set_enabled(False)`` turns
every recording path into an early return and every span into a shared
no-op; the disabled fast path is what the serving stack pays when nobody
is looking.
"""

from __future__ import annotations

from repro_torch.core import dispatch as _dispatch
from repro_torch.obs import cost, export, trace  # noqa: F401
from repro_torch.obs.cost import (cost_accounting_enabled,  # noqa: F401
                            roofline_table, set_cost_accounting)
from repro_torch.obs.export import parse_prometheus, write_metrics  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                               MetricsRegistry, enabled, get_registry,
                               set_enabled, set_registry)
from repro_torch.obs.trace import (NOOP_SPAN, Span, Trace,  # noqa: F401
                             current_span, new_trace, write_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Trace",
    "NOOP_SPAN", "enabled", "set_enabled", "disabled", "get_registry",
    "set_registry", "current_span", "new_trace", "write_jsonl",
    "write_metrics", "parse_prometheus", "set_cost_accounting",
    "cost_accounting_enabled", "roofline_table",
    "install_dispatch_observer", "uninstall_dispatch_observer",
]


class disabled:
    """``with obs.disabled():`` — scoped observability off-switch."""

    def __enter__(self):
        self._prev = set_enabled(False)
        return self

    def __exit__(self, *exc):
        set_enabled(self._prev)
        return None


# ---------------------------------------------------------------------------
# Dispatch observer: counts + times every kernel resolution
# ---------------------------------------------------------------------------

def _dispatch_observer(key, duration_s: float, err) -> None:
    """The default observe hook (see ``dispatch.set_observe_hook``).

    Fires wherever :func:`repro_torch.core.dispatch.resolve` calls its
    hooks — including resolutions the resolve hook (fault injector)
    aborts, so injected faults are visible in the registry exactly like
    real resolution failures would be.
    """
    if not enabled():
        return
    reg = get_registry()
    op, _rhs, _out, backend, bucketed, _masked, sharded = key
    reg.counter("dispatch_resolves_total",
                "kernel registry resolutions (once per key per scope)",
                ("op", "backend", "bucketed", "sharded")).inc(
        op=op, backend=backend, bucketed=bucketed, sharded=sharded)
    reg.histogram("dispatch_resolve_s",
                  "resolve() wall time incl. lazy backend import",
                  ("op", "backend")).observe(duration_s, op=op,
                                             backend=backend)
    if err is not None:
        reg.counter("dispatch_faults_total",
                    "resolutions aborted by the resolve hook",
                    ("op", "backend", "error")).inc(
            op=op, backend=backend, error=type(err).__name__)
        reg.event("dispatch_fault", op=op, backend=backend,
                  error=repr(err))


def install_dispatch_observer():
    """(Re-)install the default dispatch observer; returns the previous
    observe hook. Importing :mod:`repro_torch.obs` does this once."""
    return _dispatch.set_observe_hook(_dispatch_observer)


def uninstall_dispatch_observer() -> None:
    if _dispatch._OBSERVE_HOOK is _dispatch_observer:
        _dispatch.set_observe_hook(None)


install_dispatch_observer()
