"""Batched LM serving launcher: prefill, then a decode loop with latency
accounting; the port of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --full-config \
      --batch 1 --prompt-len 4096 --gen 32          # on the card

The reduced config unless ``--full-config``. The weights come from the
port's own seeded initialisation (``nn.reset_parameters``) and are held
in the config's compute dtype (bfloat16 for the published configs), as
the reference's serving cells hold them. The prompts are
``default_rng(0)`` tokens. Prefill is ``train_steps.lm_prefill_step``
(the last position's logits and the prompt's keys and values), copied
into a cache of ``prompt_len + gen`` (``transformer.prefill_into_cache``); each decode step is
``train_steps.lm_decode_step`` and a greedy ``argmax``. One prefill and
one decode step run first as a warmup; the timed steps end in a device
synchronisation. ``main(argv)`` returns the figures as a dict.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import nn as rnn
from repro_torch.configs import (TransformerConfig, get_config,
                                 get_reduced_config)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.training import train_steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (published) config")
    ap.add_argument("--device", default="cuda",
                    help="device of the model and cache (cuda raises "
                         "without a card)")
    args = ap.parse_args(argv)

    cfg = (get_config(args.arch) if args.full_config
           else get_reduced_config(args.arch))
    if not isinstance(cfg, TransformerConfig):
        raise SystemExit(f"{args.arch} is not an LM arch")
    dev = resolve_device(args.device)
    with torch.device("meta"):
        model = T.Transformer(cfg)
    model = model.to_empty(device=dev)
    rnn.reset_parameters(model, torch.Generator(device=dev).manual_seed(0))
    params = rnn.tree_cast({k: v.detach()
                            for k, v in model.named_parameters()},
                           T.compute_dtype(cfg))
    del model

    B, S, G = args.batch, args.prompt_len, args.gen
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    prefill = train_steps.lm_prefill_step(cfg)
    decode = train_steps.lm_decode_step(cfg)

    def run_prefill():
        logits, ck, cv = T.prefill_into_cache(
            cfg, lambda t: prefill(params, t), prompts, S + G)
        return logits[:, -1].argmax(-1).reshape(B, 1), ck, cv

    tok, ck, cv = run_prefill()                       # warmup
    decode(params, tok, ck, cv, S)
    del ck, cv
    _sync(dev)

    t0 = time.perf_counter()
    tok, ck, cv = run_prefill()
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out_tokens, lat = [tok], []
    for i in range(G - 1):
        t0 = time.perf_counter()
        logits, ck, cv = decode(params, tok, ck, cv, S + i)
        tok = logits[:, -1].argmax(-1).reshape(B, 1)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
        out_tokens.append(tok)

    lat_ms = np.asarray(lat) * 1e3
    gen = torch.cat(out_tokens, dim=1).cpu()
    out = {"arch": cfg.name, "device": str(dev), "batch": B, "prompt": S,
           "gen": G, "prefill_s": t_prefill,
           "prefill_tok_s": B * S / t_prefill,
           "decode_p50_ms": float(np.percentile(lat_ms, 50)) if lat else None,
           "decode_p99_ms": float(np.percentile(lat_ms, 99)) if lat else None,
           "decode_tok_s": B / float(np.mean(lat)) if lat else None,
           "cache_bytes": 2 * ck.numel() * ck.element_size(),
           "tokens": gen.tolist()}
    print(f"arch={cfg.name} device={dev} batch={B} prompt={S} gen={G}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({out['prefill_tok_s']:.0f} tok/s)")
    if lat:
        print(f"decode:  p50 {out['decode_p50_ms']:.1f} ms  "
              f"p99 {out['decode_p99_ms']:.1f} ms  "
              f"({out['decode_tok_s']:.0f} tok/s)")
    print("sample continuation:", gen[0, :10].tolist())
    return out


if __name__ == "__main__":
    main()
