"""Training launcher: ``--arch <id>`` on the card (or ``--device cpu``),
the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gatedgcn \
      --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --device cpu --steps 3 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch din \
      --full-config --batch 4096 --steps 2

The reduced config unless ``--full-config``. The model's weights come
from the port's own initialisation (``nn.reset_parameters``, a seeded
``torch.Generator``). An LM trains on ``data.synthetic.TokenStream``
(``--batch`` rows of ``--seq`` tokens, seed 0) through
``train_steps.lm_train_step``; a GNN (``d_in`` capped at 64, as the
reference's launcher caps it) on ``data.synthetic.full_graph_batch``
(``--nodes``, block pattern, seed 1; coordinates for egnn) through
``train_steps.gnn_train_step``; DIN on ``data.synthetic.din_batch``
(``--batch`` samples, step ``i`` on seed ``i``) through
``train_steps.din_train_step``; all under the port's trainer, AdamW at
lr 1e-3.

Fault tolerance: ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps
(with the token stream's position) and restarts from the latest on
relaunch; ``--deadline-s`` counts straggler steps. ``graphcast`` exits as
the reference's launcher does (it needs a mesh spec:
``train_steps.graphcast_train_step``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import logging
from typing import List, Optional

import torch

from repro_torch import nn as rnn
from repro_torch.configs import (DINConfig, TransformerConfig, get_config,
                                 get_reduced_config)
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_steps
from repro_torch.training.trainer import TrainerConfig, TrainState, run


def _init(model: torch.nn.Module, dev: torch.device):
    """``model``'s parameters on ``dev``, drawn with seed 0."""
    model = model.to_empty(device=dev)
    rnn.reset_parameters(model,
                         torch.Generator(device=dev).manual_seed(0))
    return {k: v.detach() for k, v in model.named_parameters()}


def build(arch: str, reduced: bool, nodes: int, device=None,
          batch: int = 8, seq: int = 128):
    """``(cfg, params, opt_cfg, step, data)`` for ``arch`` on ``device``."""
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    dev = resolve_device(device)
    opt_cfg = opt_mod.OptimizerConfig(name="adamw", lr=1e-3)
    if isinstance(cfg, TransformerConfig):
        with torch.device("meta"):
            model = Transformer(cfg)
        params = _init(model, dev)
        step = train_steps.lm_train_step(cfg, opt_cfg)
        data = synthetic.TokenStream(cfg, batch, seq, seed=0, device=dev)
        return cfg, params, opt_cfg, step, data
    if isinstance(cfg, DINConfig):
        params = _init(train_steps._din_model(cfg), dev)
        step = train_steps.din_train_step(cfg, opt_cfg)
        data = ((synthetic.din_batch(cfg, batch, seed=i, device=dev),)
                for i in itertools.count())
        return cfg, params, opt_cfg, step, data
    if cfg.family == "graphcast":
        raise SystemExit("use examples/ for graphcast (needs mesh spec)")
    cfg = dataclasses.replace(cfg, d_in=min(cfg.d_in, 64))
    model, _ = train_steps._family(cfg)
    params = _init(model, dev)
    step = train_steps.gnn_train_step(cfg, opt_cfg)
    b = synthetic.full_graph_batch(cfg, nodes, pattern="block", seed=1,
                                   coords=cfg.family == "egnn", device=dev)
    return cfg, params, opt_cfg, step, itertools.repeat((b,))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (published) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the model and batch (cuda raises "
                         "without a card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg, params, opt_cfg, step, data = build(
        args.arch, not args.full_config, args.nodes, args.device,
        args.batch, args.seq)
    opt_state = opt_mod.init(opt_cfg, params)
    n_params = rnn.param_count(params)
    print(f"arch={args.arch} params={n_params/1e6:.2f}M "
          f"device={next(iter(params.values())).device}")

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=10,
                         step_deadline_s=args.deadline_s)
    out = run(tcfg, step, TrainState(params, opt_state), data)
    print(f"done: step {out['final_step']} "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
