"""Deterministic fault injection for the serving stack (DESIGN.md §13).

Real kernel failures (device OOM, a kernel that fails to build or to
launch, device loss) are impossible to reproduce on demand, so every
robustness behavior in ``engine/server.py`` — retry, backend fallback,
circuit-breaker transitions — is driven in tests and benchmarks by this
injector instead:

  - **rules** are keyed by ``(op, backend)`` with ``"*"`` wildcards; the
    most specific rule wins (exact, then ``(op, "*")``, then
    ``("*", backend)``, then ``("*", "*")``),
  - a rule is either a **script** (an explicit fail/pass sequence, for
    pinning breaker state machines) or a seeded **rate** (for statistical
    load tests); both are deterministic — each rule owns its own RNG
    seeded from (injector seed, op, backend), so outcomes never depend on
    the global order of unrelated checks,
  - ``install()`` threads the injector through the dispatch layer
    (:func:`repro_torch.core.dispatch.set_resolve_hook`): every kernel
    resolution can fault exactly where a broken kernel would — once per
    key per resolution scope, where the reference's plan traces resolve.
    The server additionally calls :meth:`check` per group launch, so warm
    plans (which never fire the hook) stay faultable too.

The per-rule streams are the reference's
(``np.random.default_rng((seed, crc32("op/backend")))``), so the same
seed fires the same faults in both packages. Faults surface as
:class:`repro_torch.core.dispatch.InjectedFault`, which the server treats
like any other backend failure.
"""

from __future__ import annotations

import zlib
from collections import deque
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core import dispatch
from repro_torch.core.dispatch import InjectedFault

__all__ = ["FaultInjector", "InjectedFault"]

WILDCARD = "*"


class _Rule:
    def __init__(self, seed: int, op: str, backend: str,
                 rate: float = 0.0,
                 script: Optional[Iterable[bool]] = None):
        if script is None and not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.script = None if script is None else deque(bool(x)
                                                        for x in script)
        # stable per-rule stream: independent of other rules and of the
        # order unrelated (op, backend) pairs are checked in
        self.rng = np.random.default_rng(
            (seed, zlib.crc32(f"{op}/{backend}".encode())))
        self.n_checks = 0
        self.n_faults = 0

    def fires(self) -> bool:
        self.n_checks += 1
        if self.script is not None:
            fault = self.script.popleft() if self.script else False
        else:
            fault = self.rate > 0 and float(self.rng.random()) < self.rate
        if fault:
            self.n_faults += 1
        return fault


class FaultInjector:
    """Seeded per-(op, backend) fault source for serving tests/benchmarks."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: Dict[Tuple[str, str], _Rule] = {}
        self._prev_hook = None
        self._installed = False
        self.n_checks = 0
        self.n_faults = 0

    # -- configuration ------------------------------------------------------
    def fail(self, op: str = WILDCARD, backend: str = WILDCARD,
             rate: float = 1.0,
             script: Optional[Iterable[bool]] = None) -> "FaultInjector":
        """Add/replace one rule. ``script`` (a fail/pass sequence, consumed
        left to right, then inert) beats ``rate``; returns self for
        chaining."""
        self._rules[(op, backend)] = _Rule(self.seed, op, backend,
                                           rate=rate, script=script)
        return self

    def clear(self, op: str = WILDCARD, backend: str = WILDCARD) -> None:
        self._rules.pop((op, backend), None)

    def clear_all(self) -> None:
        self._rules.clear()

    def script_remaining(self, op: str = WILDCARD,
                         backend: str = WILDCARD) -> int:
        """Unconsumed script length of one rule (0 for rate rules)."""
        rule = self._rules.get((op, backend))
        return len(rule.script) if rule is not None and rule.script else 0

    # -- the check ----------------------------------------------------------
    def _match(self, op: str, backend: str) -> Optional[_Rule]:
        for key in ((op, backend), (op, WILDCARD),
                    (WILDCARD, backend), (WILDCARD, WILDCARD)):
            rule = self._rules.get(key)
            if rule is not None:
                return rule
        return None

    def check(self, op: str, backend: str) -> None:
        """Raise :class:`InjectedFault` if the matching rule fires."""
        self.n_checks += 1
        rule = self._match(op, backend)
        if rule is not None and rule.fires():
            self.n_faults += 1
            raise InjectedFault(
                f"injected fault: {op!r} on backend {backend!r}")

    # -- dispatch-layer threading ------------------------------------------
    def _on_resolve(self, key) -> None:
        op, backend = key[0], key[3]
        self.check(op, backend)

    def install(self) -> "FaultInjector":
        """Hook the dispatch layer so kernel *resolution* can fault too."""
        if not self._installed:
            self._prev_hook = dispatch.set_resolve_hook(self._on_resolve)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            dispatch.set_resolve_hook(self._prev_hook)
            self._prev_hook = None
            self._installed = False

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
