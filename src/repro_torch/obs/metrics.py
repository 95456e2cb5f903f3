"""Process-local metrics registry: labeled counters, gauges, histograms.

The single place every operational signal in the serving stack lands
(DESIGN.md §14). Instruments are *plain Python state* updated on the
host, never inside a kernel — an ``inc()`` is a dict lookup and a float
add — so the registry costs nothing measurable when nobody exports it,
and a module-level disable switch (:func:`set_enabled`) turns every record call
into an early return for the truly paranoid.

Model (pull-based, Prometheus-shaped):

  - a **metric** is (name, help, labelnames); a **series** is one concrete
    label-value assignment of it.  ``plan_cache_hits_total`` with
    ``labelnames=("kind", "backend")`` holds one float per observed
    (kind, backend) pair.
  - recording APIs take the labels as keyword arguments and *must* supply
    exactly the declared labelnames — a typo'd or missing label is a
    ``ValueError`` at the call site, never a silently separate series.
  - ``Histogram`` keeps cumulative buckets (Prometheus ``le`` semantics),
    count/sum, and a bounded sample window for exact quantiles.
  - the registry additionally carries a bounded **event log** (state
    transitions, direction switches, injected faults) — things that are
    moments, not rates.

Snapshots are plain dicts (:meth:`MetricsRegistry.snapshot`), exportable
as JSON (:meth:`to_json`) and Prometheus text format
(:meth:`to_prometheus`, round-trippable via
:func:`repro_torch.obs.export.parse_prometheus`).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "enabled", "set_enabled", "get_registry",
           "set_registry", "label_str"]

# ---------------------------------------------------------------------------
# Global enable switch + default registry
# ---------------------------------------------------------------------------

# REPRO_OBS_DISABLED=1 starts the process with observability off (the
# whole test suite passes either way — that property is itself a gate)
_ENABLED: List[bool] = [os.environ.get("REPRO_OBS_DISABLED", "")
                        not in ("1", "true")]


def enabled() -> bool:
    """Whether observability recording is globally on (default: yes)."""
    return _ENABLED[0]


def set_enabled(flag: bool) -> bool:
    """Flip the global switch; returns the previous value.

    Disabled means: counters/gauges/histograms ignore record calls, the
    event log ignores events, traces are not created, and spans are the
    shared no-op (``repro_torch.obs.trace.NOOP_SPAN``).
    """
    prev = _ENABLED[0]
    _ENABLED[0] = bool(flag)
    return prev


#: Latency-oriented default histogram buckets (seconds), 1µs … 60s.
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                   0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

#: Exact-quantile sample window per histogram series.
SAMPLE_WINDOW = 2048


def label_str(labelnames: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    """Prometheus-style label block: ``{k="v",k2="v2"}`` ('' if no labels)."""
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in zip(labelnames, values))
    return "{" + inner + "}"


class _Metric:
    """Shared series bookkeeping: label validation and get-or-create."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.kind} {self.name!r} takes labels "
                f"{self.labelnames}, got {tuple(sorted(labels))}")
        # values coerced to str: label identity is textual (Prometheus
        # semantics), so True and "True" are the same series
        return tuple(str(labels[k]) for k in self.labelnames)

    def series(self) -> Dict[str, object]:
        """Snapshot: label block string -> value (subclass-shaped)."""
        return {label_str(self.labelnames, k): self._value(v)
                for k, v in sorted(self._series.items())}

    def _value(self, raw):
        return raw


class Counter(_Metric):
    """Monotonic labeled counter."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _ENABLED[0]:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(amount={amount})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Labeled point-in-time value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _ENABLED[0]:
            return
        self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _ENABLED[0]:
            return
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class _HistSeries:
    __slots__ = ("bucket_counts", "count", "sum", "samples")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets   # per-bucket (not cumulative)
        self.count = 0
        self.sum = 0.0
        self.samples: deque = deque(maxlen=SAMPLE_WINDOW)


class Histogram(_Metric):
    """Labeled histogram: Prometheus buckets + exact windowed quantiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _get(self, labels: Dict[str, object]) -> _HistSeries:
        key = self._key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets) + 1)
        return s

    def observe(self, value: float, **labels) -> None:
        if not _ENABLED[0]:
            return
        s = self._get(labels)
        v = float(value)
        idx = len(self.buckets)              # +Inf bucket
        for i, le in enumerate(self.buckets):
            if v <= le:
                idx = i
                break
        s.bucket_counts[idx] += 1
        s.count += 1
        s.sum += v
        s.samples.append(v)

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return s.count if s is not None else 0

    def total(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return s.sum if s is not None else 0.0

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Exact quantile over the bounded sample window (None if empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        s = self._series.get(self._key(labels))
        if s is None or not s.samples:
            return None
        xs = sorted(s.samples)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def _value(self, raw: _HistSeries) -> dict:
        xs = sorted(raw.samples)

        def pct(q: float) -> Optional[float]:
            return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else None

        cum, cum_counts = 0, []
        for c in raw.bucket_counts:
            cum += c
            cum_counts.append(cum)
        return {
            "count": raw.count, "sum": raw.sum,
            "mean": raw.sum / raw.count if raw.count else None,
            "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            "buckets": {("+Inf" if i == len(self.buckets)
                         else repr(self.buckets[i])): cum_counts[i]
                        for i in range(len(cum_counts))},
        }


class MetricsRegistry:
    """Name -> metric store with get-or-create, snapshots, and events."""

    def __init__(self, max_events: int = 1024,
                 clock=time.time):
        self._metrics: Dict[str, _Metric] = {}
        self._events: deque = deque(maxlen=max_events)
        self._clock = clock

    # -- instrument factories (get-or-create, schema-checked) ---------------
    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Iterable[str], **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, labelnames, **kw)
            return m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {cls.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{m.labelnames}, not {tuple(labelnames)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- events --------------------------------------------------------------
    def event(self, name: str, **attrs) -> None:
        """Record one moment-in-time occurrence (bounded ring buffer)."""
        if not _ENABLED[0]:
            return
        self._events.append({"ts": self._clock(), "event": name, **attrs})

    def events(self, name: Optional[str] = None) -> List[dict]:
        evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e["event"] == name]

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """The whole registry as one plain (JSON-serialisable) dict."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "events": list(self._events)}
        for name, m in sorted(self._metrics.items()):
            out[m.kind + "s"][name] = m.series()
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                          default=str)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (events are not exported —
        they are moments, not scrapeable series)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, raw in sorted(m._series.items()):
                    cum = 0
                    for i, le in enumerate(list(m.buckets) + ["+Inf"]):
                        cum += raw.bucket_counts[i]
                        lb = label_str(m.labelnames + ("le",),
                                       key + (str(le),))
                        lines.append(f"{name}_bucket{lb} {cum}")
                    lb = label_str(m.labelnames, key)
                    lines.append(f"{name}_sum{lb} {_fmt(raw.sum)}")
                    lines.append(f"{name}_count{lb} {raw.count}")
            else:
                for key, val in sorted(m._series.items()):
                    lines.append(
                        f"{name}{label_str(m.labelnames, key)} {_fmt(val)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        self._metrics.clear()
        self._events.clear()


def _fmt(v: float) -> str:
    """Float formatting that round-trips and prints ints as ints."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# ---------------------------------------------------------------------------
# The process-default registry
# ---------------------------------------------------------------------------

_DEFAULT: List[MetricsRegistry] = [MetricsRegistry()]


def get_registry() -> MetricsRegistry:
    """The process-default registry (what instrumented components use when
    not handed an explicit one)."""
    return _DEFAULT[0]


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-default registry; returns the previous one (tests
    isolate themselves by swapping in a fresh registry and restoring)."""
    prev = _DEFAULT[0]
    _DEFAULT[0] = registry
    return prev
