"""Fault-tolerant training loop, the port of ``repro.training.trainer``.

  - restart from the latest: on (re)start the loop restores the newest
    intact checkpoint (atomic manifests make torn writes invisible), so
    a failure costs at most ``ckpt_every`` steps;
  - step deadline (straggler signal): a step over its wall-clock budget
    is logged and counted; what to do about it is the launcher's call;
  - a non-finite loss stops the run;
  - ``fail_at_step`` injects a failure, so tests drive the recovery path
    deterministically.

A checkpoint is restored onto the device the state's parameters are on
or, with ``shardings`` (``rules.tree_shardings`` of the state's specs),
placed as DTensors on that mesh, which may differ from the one it was
saved from (the reference's elastic restore). A stream with
``state()`` / ``restore()`` (``data.synthetic.TokenStream``) has its
position saved with each checkpoint and restored with it, so a resumed
run reads the batches the uninterrupted one would have.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.sharding import spmd
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training.optimizer import OptState, Tensors

log = logging.getLogger("repro_torch.trainer")


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    step_deadline_s: Optional[float] = None   # straggler budget
    log_every: int = 10
    fail_at_step: Optional[int] = None        # failure injection (tests)


@dataclasses.dataclass
class TrainState:
    params: Tensors
    opt_state: OptState
    step: int = 0


def run(tcfg: TrainerConfig, step_fn: Callable, state: TrainState,
        data: Iterator, shardings: Any = None) -> Dict[str, Any]:
    """Run the loop to ``tcfg.total_steps``; ``step_fn(params, opt_state,
    *batch) -> (params, opt_state, metrics)``, one batch of ``data`` a
    step. ``shardings``: the tree ``{"params": …, "opt": …}`` that a
    restored checkpoint is placed by (see ``checkpoint.restore``).
    Returns ``final_step``, ``losses``, ``stragglers`` and the final
    ``state``."""
    history = []
    stragglers = 0

    if tcfg.ckpt_dir:
        latest = ckpt_mod.latest_step(tcfg.ckpt_dir)
        if latest is not None and latest > state.step:
            dev = next(iter(state.params.values())).device
            tree = {"params": state.params, "opt": state.opt_state}
            restored, extra = ckpt_mod.restore(tcfg.ckpt_dir, latest, tree,
                                               device=dev,
                                               shardings=shardings)
            state = TrainState(params=restored["params"],
                               opt_state=restored["opt"], step=latest)
            if hasattr(data, "restore") and "data" in extra:
                data.restore(extra["data"])
            log.info("restored checkpoint at step %d", latest)

    while state.step < tcfg.total_steps:
        batch = next(data)
        if not isinstance(batch, tuple):
            batch = (batch,)
        t0 = time.monotonic()
        if tcfg.fail_at_step is not None and state.step == tcfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {state.step}")
        params, opt_state, metrics = step_fn(state.params, state.opt_state,
                                             *batch)
        loss = float(spmd.full(metrics["loss"]))
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {state.step}")
        dt = time.monotonic() - t0
        if tcfg.step_deadline_s and dt > tcfg.step_deadline_s:
            stragglers += 1
            log.warning("straggler: step %d took %.2fs (budget %.2fs)",
                        state.step, dt, tcfg.step_deadline_s)
        state = TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1)
        history.append(loss)
        if tcfg.log_every and state.step % tcfg.log_every == 0:
            log.info("step %d loss %.4f (%.0f ms)", state.step, loss, dt * 1e3)
        if tcfg.ckpt_dir and state.step % tcfg.ckpt_every == 0:
            extra = {"data": data.state()} if hasattr(data, "state") else {}
            ckpt_mod.save(tcfg.ckpt_dir, state.step,
                          {"params": state.params, "opt": state.opt_state},
                          extra=extra, keep=tcfg.keep_ckpts)

    return {"final_step": state.step, "losses": history,
            "stragglers": stragglers, "state": state}
