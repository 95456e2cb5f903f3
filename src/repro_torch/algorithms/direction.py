"""Direction-optimizing traversal policy (Beamer-style push/pull switching).

Push expands the frontier's out-edges (the masked bin·bin→bin mxv); pull
is the ``mxv_pull`` row, whose kernel stops scanning an unvisited
vertex's in-edges at its first frontier parent. This module holds the
decision: a popcount density estimate over the packed words and a
hysteresis switch.

  push → pull   when  m_f > α · m_u      (frontier edges vs unexplored)
  pull → push   when  nnz_f < n / β      (frontier shrank back down)

with m_f ≈ nnz(frontier) · d̄ and m_u ≈ (n − nnz(visited)) · d̄. After the
first pull→push switch the direction locks to push: a BFS frontier has
one hump, so the pull iterations form one contiguous regime.

The reference runs this inside ``lax.while_loop`` on traced float32
values; the port's BFS loop is on the host, so :func:`next_direction`
takes the two counts as Python ints and repeats the reference's float32
arithmetic with numpy, giving the same schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.words import popcount

#: Direction encoding in traces.
PUSH = 0
PULL = 1

#: User-facing mode strings accepted by bfs(direction=...).
MODES = ("push", "pull", "auto")

_NONE = -1
_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class DirectionConfig:
    """Switching policy knobs.

    alpha: push→pull when the frontier-edge estimate exceeds ``alpha`` ×
           the unexplored-edge estimate.
    beta:  pull→push when frontier nnz drops below n / ``beta``.
    """

    mode: str = "auto"
    alpha: float = 0.07
    beta: float = 24.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"direction mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if not (self.alpha > 0 and self.beta > 0):
            raise ValueError("alpha and beta must be positive")


def as_config(direction: Union[str, DirectionConfig, None]) -> DirectionConfig:
    """Normalize a ``direction=`` argument (None means push only)."""
    if direction is None:
        return DirectionConfig(mode="push")
    if isinstance(direction, DirectionConfig):
        return direction
    return DirectionConfig(mode=direction)


def nnz_words(words: torch.Tensor) -> torch.Tensor:
    """Popcount density estimator: set bits across packed words (int64)."""
    return popcount(words).sum()


def initial_direction(cfg: DirectionConfig) -> int:
    """Forced modes start forced; auto starts push."""
    return PULL if cfg.mode == "pull" else PUSH


def next_direction(cfg: DirectionConfig, cur: int, locked: bool, nnz_f: int,
                   nnz_visited: int, n: int, avg_degree: float,
                   batch: Optional[int] = None) -> Tuple[int, bool]:
    """One hysteresis step: ``(direction, locked)`` for the next iteration.

    float32 throughout, with the reference's weak-typed Python constants
    rounded to float32 where they meet a float32 operand. ``batch`` is
    the number of live sources of a multi-source traversal, whose counts
    are summed over the batch: it scales them back to per-query
    magnitudes, and the reference holds it as a float32 array, so
    ``avg_degree / batch`` and the count quotients round in float32 too.
    ``None`` is the single-source step, where the reference divides by
    a Python ``1`` and nothing extra is rounded.
    """
    if cfg.mode != "auto":
        return (PULL if cfg.mode == "pull" else PUSH), locked
    f = _F32(nnz_f)
    v = _F32(nnz_visited)
    deg = _F32(avg_degree)
    if batch is not None:
        b = _F32(batch)
        f_q, v_q, m_f = f / b, v / b, f * (deg / b)
    else:
        f_q, v_q, m_f = f, v, f * deg
    unvisited = np.maximum(_F32(n) - v_q, _F32(0))
    m_u = unvisited * deg
    go_pull = cur == PUSH and not locked and bool(m_f > _F32(cfg.alpha) * m_u)
    go_push = cur == PULL and bool(f_q < _F32(n / cfg.beta))
    new = PULL if go_pull else (PUSH if go_push else cur)
    return new, locked or go_push


def trace_tuple(trace: Sequence[int], n_iterations: Optional[int] = None
                ) -> Tuple[str, ...]:
    """A direction trace as ``("push", "pull", ...)`` strings; entries of
    -1 (iterations not run) are dropped."""
    arr = np.asarray(trace, dtype=np.int64)
    if n_iterations is not None:
        arr = arr[: int(n_iterations)]
    return tuple("pull" if v == PULL else "push" for v in arr if v != _NONE)


def observe_trace(directions: Tuple[str, ...], kernel: str = "bfs",
                  registry=None) -> None:
    """Mirror one traversal's direction trace into the metrics registry.

    Emits ``traversal_iterations_total{direction,kernel}`` (one per
    iteration), ``direction_switches_total{transition}`` for each change
    of regime, and one ``direction_switch`` event per switch carrying the
    iteration index, so a serving fleet sees when its traversals flip to
    pull without keeping raw traces.
    """
    from repro_torch.obs import metrics as obs_metrics
    if not obs_metrics.enabled() or not directions:
        return
    reg = registry if registry is not None else obs_metrics.get_registry()
    iters = reg.counter("traversal_iterations_total",
                        "traversal iterations by direction run",
                        ("direction", "kernel"))
    for d in directions:
        iters.inc(direction=d, kernel=kernel)
    switches = reg.counter("direction_switches_total",
                           "push/pull regime changes", ("transition",))
    for i in range(1, len(directions)):
        if directions[i] != directions[i - 1]:
            t = f"{directions[i - 1]}->{directions[i]}"
            switches.inc(transition=t)
            reg.event("direction_switch", kernel=kernel, iteration=i,
                      transition=t)


def check_monotone(directions: Tuple[str, ...]) -> bool:
    """The hysteresis invariant: the pull iterations form one contiguous
    regime (push* pull* push*) — no flapping."""
    pulls = [i for i, d in enumerate(directions) if d == "pull"]
    return not pulls or pulls == list(range(pulls[0], pulls[-1] + 1))
