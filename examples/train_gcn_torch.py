"""End to end: train a GCN whose aggregation runs over B2SR, with the
PyTorch port (``repro_torch``), the twin of ``examples/train_gcn.py``.

  - a synthetic citation-style graph (block pattern: communities);
  - a GCN whose neighbourhood aggregation is the registry's dense ``mxm``
    row over B2SR (``spmm_dense`` on ``b2sr_cuda``, forward and Aᵀ
    backward);
  - AdamW with checkpoints and restart from the latest;
  - a failure injected at half the steps, to drive the recovery.

Run (the card by default; ``--device cpu`` runs the kernels' plain
versions on the host):

    PYTHONPATH=src python examples/train_gcn_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_gcn_torch.py --device cpu
"""

import argparse
import dataclasses
import itertools
import tempfile

import torch

from repro_torch.configs import gcn_cora
from repro_torch.core import dispatch
from repro_torch.data.synthetic import full_graph_batch
from repro_torch.device import resolve_device
from repro_torch.models.gnn.gcn import GCN
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_steps
from repro_torch.training.trainer import (SimulatedFailure, TrainerConfig,
                                          TrainState, run)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--backend", default="b2sr_cuda",
                    choices=dispatch.BACKENDS)
    ap.add_argument("--no-b2sr", action="store_true",
                    help="use the float segment-sum aggregation instead")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(gcn_cora.CONFIG, d_in=64, n_classes=7,
                              d_hidden=32, use_b2sr=not args.no_b2sr)
    batch = full_graph_batch(cfg, args.nodes, pattern="block", seed=3,
                             device=dev)
    if batch.graph is not None:
        batch = dataclasses.replace(
            batch, graph=batch.graph.with_backend(args.backend))
    print(f"graph: {args.nodes} nodes, {int(batch.senders.shape[0])} edges, "
          f"aggregation="
          f"{args.backend + ' B2SR SpMM' if cfg.use_b2sr else 'segment_sum'}"
          f", device {dev}")

    opt_cfg = opt_mod.OptimizerConfig(name="adamw", lr=5e-3)
    torch.manual_seed(0)
    params = {k: v.detach().to(dev)
              for k, v in GCN(cfg).named_parameters()}
    opt_state = opt_mod.init(opt_cfg, params)
    step = train_steps.gnn_train_step(cfg, opt_cfg)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=50,
                             ckpt_dir=ckpt_dir, log_every=50,
                             fail_at_step=args.steps // 2)
        state = TrainState(params=params, opt_state=opt_state)
        try:
            run(tcfg, step, state, itertools.repeat((batch,)))
            raise AssertionError("injected failure did not fire")
        except SimulatedFailure as e:
            print(f"node failure simulated: {e}; restarting from checkpoint")
        # restart: fresh state, same checkpoint directory -> latest restored
        tcfg2 = dataclasses.replace(tcfg, fail_at_step=None)
        state2 = TrainState(params=params, opt_state=opt_state)  # step 0
        out = run(tcfg2, step, state2, itertools.repeat((batch,)))

    losses = out["losses"]
    print(f"resumed and finished at step {out['final_step']}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not decrease"

    # accuracy on the train mask, and proof that each layer's aggregation
    # resolved the registry's dense mxm row, not a bespoke call path
    r0 = dispatch.stats["resolves"]
    logits = train_steps.gnn_infer_step(cfg)(out["state"].params, batch)
    if cfg.use_b2sr:
        assert dispatch.stats["resolves"] - r0 == cfg.n_layers, \
            "expected one registry resolve per GCN layer"
        assert dispatch.last_key[:4] == ("mxm", "dense", "full",
                                         args.backend), \
            f"aggregation did not dispatch the {args.backend} row: " \
            f"{dispatch.last_key}"
        print(f"dispatch: {dispatch.stats['resolves'] - r0} registry "
              f"resolves, last row {dispatch.last_key}")
    mask = batch.train_mask
    acc = (logits.argmax(-1)[mask] == batch.labels[mask]).float().mean()
    print(f"train-mask accuracy: {float(acc):.3f}")
    print("OK")


if __name__ == "__main__":
    main()
