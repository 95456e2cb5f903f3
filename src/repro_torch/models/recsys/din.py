"""DIN [Zhou et al. arXiv:1706.06978], the port of
``repro.models.recsys.din``: target attention over the user's behaviour.

Per sample: the user's history of (item, category) ids, padded to
``seq_len``; a target (item, category); and categorical user features.
The attention MLP (80-40) scores each history position against the
target; the pooled interest vector, the user features and the target
feed the final MLP (200-80), which gives the click logit.

The parameters carry the reference's names: ``item_table``,
``cate_table`` and ``user_table`` (``[vocab, d]``), ``attn_mlp`` and
``mlp`` (``layer_i`` of an :class:`~repro_torch.nn.MLP`), so a reference
tree maps onto the ``state_dict`` through
``convert.din_state_from_reference``. ``nn.reset_parameters`` draws the
tables with ``embed_init`` (``reset_own``) and then the MLPs, from one
generator. The tables' gradients are dense, as the reference's are: its
AdamW decays every row at every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.recsys import DINConfig
from repro_torch.models.recsys.embedding import embedding_lookup
from repro_torch.nn import MLP, embed_init


class DINBatch(NamedTuple):
    hist_items: torch.Tensor      # [B, L] int32
    hist_cates: torch.Tensor      # [B, L] int32
    hist_mask: torch.Tensor       # [B, L] bool
    target_item: torch.Tensor     # [B] int32
    target_cate: torch.Tensor     # [B] int32
    user_feats: torch.Tensor      # [B, F] int32
    labels: torch.Tensor          # [B] float32 (click 0/1)


class DIN(nn.Module):
    def __init__(self, cfg: DINConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.item_table = nn.Parameter(torch.empty(cfg.n_items, d))
        self.cate_table = nn.Parameter(torch.empty(cfg.n_cates, d))
        self.user_table = nn.Parameter(torch.empty(cfg.user_feat_vocab, d))
        # attention input: [hist, target, hist - target, hist * target],
        # 2d each; final MLP: user features, interest and target
        self.attn_mlp = MLP([8 * d, *cfg.attn_mlp, 1], act=torch.sigmoid)
        self.mlp = MLP([cfg.n_user_feats * d + 4 * d, *cfg.mlp, 1],
                       act=F.relu)

    @torch.no_grad()
    def reset_own(self, generator: torch.Generator) -> None:
        for name in ("item_table", "cate_table", "user_table"):
            t = getattr(self, name)
            t.copy_(embed_init(t.shape[0], t.shape[1], generator,
                               device=t.device, dtype=t.dtype))

    def hist_embed(self, batch: DINBatch) -> torch.Tensor:
        """``[B, L, 2d]``: the history's item and category rows."""
        return torch.cat([embedding_lookup(self.item_table, batch.hist_items),
                          embedding_lookup(self.cate_table, batch.hist_cates)],
                         -1)

    def target_embed(self, item: torch.Tensor,
                     cate: torch.Tensor) -> torch.Tensor:
        """``[..., 2d]``: the target's item and category rows."""
        return torch.cat([embedding_lookup(self.item_table, item),
                          embedding_lookup(self.cate_table, cate)], -1)

    def user_embed(self, batch: DINBatch) -> torch.Tensor:
        """``[B, F·d]``: the user features' rows, flattened."""
        uf = embedding_lookup(self.user_table, batch.user_feats)
        return uf.reshape(uf.shape[0], -1)

    def attention_pool(self, hist: torch.Tensor, mask: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
        """DIN's local activation unit, ``[B, 2d]``: the history weighted
        by its relevance to the target. No softmax (the paper's §4):
        masked positions' scores are set to 0 with a ``where``."""
        tgt = target[:, None, :].expand_as(hist)
        feats = torch.cat([hist, tgt, hist - tgt, hist * tgt], -1)
        scores = self.attn_mlp(feats)[..., 0]
        scores = torch.where(mask, scores, 0.0)
        return torch.sum(scores[..., None] * hist, 1)

    def forward(self, batch: DINBatch) -> torch.Tensor:
        """The click logits, ``[B]``."""
        hist = self.hist_embed(batch)
        target = self.target_embed(batch.target_item, batch.target_cate)
        interest = self.attention_pool(hist, batch.hist_mask, target)
        x = torch.cat([self.user_embed(batch), interest, target], -1)
        return self.mlp(x)[..., 0]

    def loss_fn(self, batch: DINBatch):
        """``(loss, {"bce": loss})``: the numerically stable binary
        cross-entropy of the logits, averaged over the batch."""
        logits = self(batch)
        loss = torch.mean(torch.clamp(logits, min=0) - logits * batch.labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        return loss, {"bce": loss}

    def score_candidates(self, batch: DINBatch, cand_items: torch.Tensor,
                         cand_cates: torch.Tensor,
                         chunk: int = 4096) -> torch.Tensor:
        """Logits of ``N`` candidates for each of the batch's users,
        ``[B, N]``.

        The interest vector depends on the target, so attention runs per
        (user, candidate). The candidates go in blocks of ``chunk`` (at
        most ``N``), padded with id 0 to a whole number of blocks and the
        padded columns dropped, so one block holds ``[B, chunk, L, 8d]``
        attention features, never ``[B, N, L, 8d]``.
        """
        B = batch.hist_items.shape[0]
        N = cand_items.shape[0]
        chunk = min(chunk, N)
        hist = self.hist_embed(batch)                     # [B, L, 2d]
        L, d2 = hist.shape[1:]
        uf = self.user_embed(batch)
        n_pad = -(-N // chunk) * chunk - N
        ci = torch.cat([cand_items, cand_items.new_zeros(n_pad)])
        cc = torch.cat([cand_cates, cand_cates.new_zeros(n_pad)])
        h = hist[:, None]                                 # [B, 1, L, 2d]
        mask = batch.hist_mask[:, None, :]
        out = []
        for items, cates in zip(ci.split(chunk), cc.split(chunk)):
            cands = self.target_embed(items, cates)       # [chunk, 2d]
            t = cands[None, :, None, :]                   # [1, chunk, 1, 2d]
            shape = (B, chunk, L, d2)
            feats = torch.cat([h.expand(shape), t.expand(shape), h - t,
                               h * t], -1)
            scores = self.attn_mlp(feats)[..., 0]
            scores = torch.where(mask, scores, 0.0)
            interest = torch.einsum("bnl,bld->bnd", scores, hist)
            x = torch.cat([uf[:, None, :].expand(B, chunk, uf.shape[-1]),
                           interest, cands[None].expand(B, chunk, d2)], -1)
            out.append(self.mlp(x)[..., 0])               # [B, chunk]
        return torch.cat(out, 1)[:, :N]
