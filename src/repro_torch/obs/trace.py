"""Per-query trace spans for the serving stack (DESIGN.md §14).

A :class:`Trace` is an append-only list of :class:`Span` intervals — named,
attributed, possibly nested — covering one query's life through the
serving pipeline: ``submit`` → ``queue_wait`` → ``plan_resolve`` →
``launch`` → ``scatter_back``. The trace rides on the query's handle
(``QueryHandle.trace``), so a slow query can be opened up after the fact
to see which stage ate the budget (plan compile vs kernel vs queue wait).

Group amortisation: the batching engine runs many queries as one launch,
so the group-level spans (plan_resolve / launch / scatter_back) are
*shared* Span objects adopted into every member handle's trace — N handles
reference one measurement, which is the truthful accounting (they really
did share that launch).

Timing discipline:

  - all span timestamps come from ``time.monotonic`` — the same clock the
    server stamps ``completed_at`` with by default — so span durations are
    directly comparable with observed handle latency. (The server's
    *injectable* clock governs deadlines and breaker cooldowns only; trace
    time is always real time.)
  - nested spans track their children; :attr:`Span.exclusive_s` is the
    self-time (duration minus direct children), so summing exclusive time
    over a whole trace never double-counts no matter how spans nest.

The ambient **current trace** (:func:`use` / :func:`current_span`) lets
deep layers (the plan cache, three frames below the server) attach spans
to whatever query group is in flight without threading a trace argument
through every signature. With observability disabled
(:func:`repro_torch.obs.metrics.set_enabled`) ``span``/``current_span`` return
the shared :data:`NOOP_SPAN` and allocate nothing.
"""

from __future__ import annotations

import contextvars
import json
import time
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs import metrics as _metrics

__all__ = ["Span", "Trace", "NOOP_SPAN", "use", "current", "current_span",
           "annotate", "new_trace", "write_jsonl"]


class Span:
    """One named, attributed wall-time interval (monotonic seconds)."""

    __slots__ = ("name", "start_s", "end_s", "attrs", "children")

    def __init__(self, name: str, start_s: Optional[float] = None,
                 end_s: Optional[float] = None, **attrs):
        self.name = name
        self.start_s = time.monotonic() if start_s is None else start_s
        self.end_s = end_s
        self.attrs: Dict[str, Any] = dict(attrs)
        self.children: List["Span"] = []

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def finish(self) -> "Span":
        if self.end_s is None:
            self.end_s = time.monotonic()
        return self

    @property
    def duration_s(self) -> float:
        end = time.monotonic() if self.end_s is None else self.end_s
        return max(end - self.start_s, 0.0)

    @property
    def exclusive_s(self) -> float:
        """Self-time: duration minus direct children (never double-counts
        when summed over a nested trace)."""
        return max(self.duration_s
                   - sum(c.duration_s for c in self.children), 0.0)

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "start_s": self.start_s,
                   "duration_s": self.duration_s}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"{self.attrs})")


class _NoOpSpan:
    """The disabled-mode span: every operation is a no-op on a singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NoOpSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> "_NoOpSpan":
        return self

    def finish(self) -> "_NoOpSpan":
        return self


NOOP_SPAN = _NoOpSpan()


class _SpanCtx:
    """Context manager that opens a span on enter, finishes on exit, and
    stamps an ``error`` attr when the body raises."""

    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "Trace", span: Span):
        self._trace = trace
        self._span = span

    def __enter__(self) -> Span:
        self._trace._push(self._span)
        return self._span

    def __exit__(self, etype, evalue, tb) -> None:
        if evalue is not None:
            self._span.attrs["error"] = repr(evalue)
        self._span.finish()
        self._trace._pop(self._span)
        return None


class Trace:
    """One query's (or query group's) span collection."""

    def __init__(self, name: str = "query", **attrs):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs)
        self.spans: List[Span] = []          # top-level spans, in order
        self._stack: List[Span] = []         # currently-open spans

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a span as a context manager; nests under any open span."""
        if not _metrics.enabled():
            return NOOP_SPAN
        return _SpanCtx(self, Span(name, **attrs))

    def add_span(self, name: str, start_s: float, end_s: float,
                 **attrs) -> Optional[Span]:
        """Record an already-measured interval (e.g. queue wait) top-level."""
        if not _metrics.enabled():
            return None
        s = Span(name, start_s=start_s, end_s=end_s, **attrs)
        self.spans.append(s)
        return s

    def adopt(self, spans: Iterable[Span]) -> None:
        """Reference shared spans (one group measurement, many handles)."""
        self.spans.extend(spans)

    def _push(self, span: Span) -> None:
        if self._stack:
            self._stack[-1].children.append(span)
        else:
            self.spans.append(span)
        self._stack.append(span)

    def _pop(self, span: Span) -> None:
        if self._stack and self._stack[-1] is span:
            self._stack.pop()

    # -- inspection ----------------------------------------------------------
    def find(self, name: str) -> List[Span]:
        """All spans named ``name``, depth-first."""
        out: List[Span] = []

        def walk(spans: List[Span]) -> None:
            for s in spans:
                if s.name == name:
                    out.append(s)
                walk(s.children)

        walk(self.spans)
        return out

    def span_names(self) -> List[str]:
        out: List[str] = []

        def walk(spans: List[Span]) -> None:
            for s in spans:
                out.append(s.name)
                walk(s.children)

        walk(self.spans)
        return out

    def total_exclusive_s(self) -> float:
        """Summed self-time over every span (nesting never double-counts)."""
        total = 0.0

        def walk(spans: List[Span]) -> None:
            nonlocal total
            for s in spans:
                total += s.exclusive_s
                walk(s.children)

        walk(self.spans)
        return total

    def to_dict(self) -> dict:
        return {"name": self.name, "attrs": dict(self.attrs),
                "spans": [s.to_dict() for s in self.spans]}

    def __repr__(self) -> str:
        return f"Trace({self.name!r}, spans={self.span_names()})"


def new_trace(name: str = "query", **attrs) -> Optional[Trace]:
    """A fresh Trace, or None when observability is disabled (callers store
    the result on a handle and guard on None)."""
    return Trace(name, **attrs) if _metrics.enabled() else None


# ---------------------------------------------------------------------------
# Ambient current trace (contextvar: safe under nested groups)
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_current_trace", default=None)


class _UseCtx:
    __slots__ = ("_trace", "_token")

    def __init__(self, trace: Optional[Trace]):
        self._trace = trace
        self._token = None

    def __enter__(self) -> Optional[Trace]:
        self._token = _CURRENT.set(self._trace)
        return self._trace

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)
        return None


def use(trace: Optional[Trace]) -> _UseCtx:
    """Make ``trace`` the ambient current trace within the ``with`` body."""
    return _UseCtx(trace)


def current() -> Optional[Trace]:
    return _CURRENT.get()


def annotate(**attrs) -> None:
    """Set attrs on the innermost open span of the ambient trace (no-op
    when nothing is open) — lets deep layers tag the stage they run in."""
    tr = _CURRENT.get()
    if tr is not None and tr._stack and _metrics.enabled():
        tr._stack[-1].attrs.update(attrs)


def current_span(name: str, **attrs):
    """Open a span on the ambient trace (no-op span when there isn't one —
    the instrumented layer doesn't care whether anyone is watching)."""
    tr = _CURRENT.get()
    if tr is None or not _metrics.enabled():
        return NOOP_SPAN
    return tr.span(name, **attrs)


def write_jsonl(path: str, traces: Iterable[Trace],
                append: bool = False) -> int:
    """Dump traces one-JSON-object-per-line; returns how many were written."""
    n = 0
    with open(path, "a" if append else "w") as f:
        for tr in traces:
            f.write(json.dumps(tr.to_dict(), default=str) + "\n")
            n += 1
    return n
