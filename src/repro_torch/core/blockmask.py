"""B2SR beyond graphs: bit-tile block masks for block-sparse attention,
the port of ``repro.core.blockmask``.

An attention *block mask* (which ``[block_size × block_size]`` score
blocks a sparse-attention pattern touches) is a binary matrix over the
block grid, so it is stored as B2SR (``core.b2sr.coo_to_b2sr``):

  - :func:`local_strided_pattern` builds the causal-local plus
    strided-global pattern (COO over blocks, numpy);
  - :func:`pattern_to_b2sr` stores it as B2SR and its ELL view;
  - :func:`block_lists_from_ell` unpacks the ELL words into each query
    block's key-block ids, as the BMV kernels unpack them;
  - :func:`block_sparse_attention` gathers and scores only those key
    blocks: O(S·w) instead of O(S²).

Words are the port's int32 bit patterns: at ``tile_dim`` 32 bit 31 is
the sign bit, and ``(w >> j) & 1`` reads bit ``j`` whatever the shift
fills in. These are PyTorch operations, as the reference's are ``jnp``
(no Pallas kernel). The attention takes its query blocks in groups of
``Q_BLOCKS_PER_STEP`` instead of scanning them one at a time; the
arithmetic of each block is the reference's, in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.b2sr import B2SR, B2SREll, coo_to_b2sr, to_ell
from repro_torch.device import DeviceLike


def local_strided_pattern(n_blocks: int, window: int = 4,
                          stride: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Causal local window + strided-global block pattern (COO over blocks)."""
    rows, cols = [], []
    for i in range(n_blocks):
        for j in range(max(0, i - window + 1), i + 1):
            rows.append(i)
            cols.append(j)
        for j in range(0, i, stride):       # strided global (causal)
            rows.append(i)
            cols.append(j)
    return np.asarray(rows), np.asarray(cols)


def pattern_to_b2sr(rows: np.ndarray, cols: np.ndarray, n_blocks: int,
                    tile_dim: int = 8, device: DeviceLike = None
                    ) -> Tuple[B2SR, B2SREll]:
    mat = coo_to_b2sr(rows, cols, n_blocks, n_blocks, tile_dim,
                      device=device)
    return mat, to_ell(mat)


def block_lists_from_ell(ell: B2SREll, max_blocks: int) -> torch.Tensor:
    """Per query-block active key-block ids, from the ELL bit rows.

    Returns int32[n_blocks, max_blocks], padded with -1 (each row's ids in
    the ELL's tile order, then bit order). Bit ``j`` of word ``r`` in tile
    ``(I, J)`` means block ``I·t + r`` attends to block ``J·t + j``.
    """
    t = ell.tile_dim
    R, K = ell.tile_col_idx.shape
    dev = ell.tile_col_idx.device
    shifts = torch.arange(t, dtype=ell.bit_tiles.dtype, device=dev)
    bits = (ell.bit_tiles[..., :, None] >> shifts) & 1      # [R, K, t, t]
    col = ell.tile_col_idx.long()[:, :, None]
    cand = col * t + torch.arange(t, device=dev)            # [R, K, t]
    cand = torch.where(col >= 0, cand, -1)
    cand_rows = cand[:, None].expand(R, t, K, t)
    bits_rows = bits.permute(0, 2, 1, 3)                    # [R, t, K, t]
    flat = torch.where(bits_rows > 0, cand_rows, -1).reshape(R * t, K * t)
    # compact the -1s to the right (stable sort by invalidity)
    order = torch.argsort((flat < 0).to(torch.int8), dim=1, stable=True)
    compacted = torch.gather(flat, 1, order)
    return compacted[:ell.n_rows, :max_blocks].to(torch.int32)


#: query blocks gathered and scored together (bounds the gathered keys,
#: values and scores: 16 · W blocks of ``block_size`` rows)
Q_BLOCKS_PER_STEP = 16


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_ids: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """Attention restricted to the B2SR-indexed key blocks.

    q/k/v: [B, S, H, hd]; block_ids: int32[nq, W] (-1 padded, from
    :func:`block_lists_from_ell`). Causality inside the diagonal block is
    enforced; listed off-diagonal blocks are attended in full (the
    pattern is causal at block granularity); padding scores are -1e30.
    Scores, softmax and the weighted sum are float32; the output has
    ``q``'s dtype.
    """
    B, S, H, hd = q.shape
    bs = block_size
    nq = S // bs
    W = block_ids.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qb = q.float().reshape(B, nq, bs, H, hd)
    kb = k.float().reshape(B, nq, bs, H, hd)
    vb = v.float().reshape(B, nq, bs, H, hd)
    ids_all = block_ids.to(device=dev, dtype=torch.int64)
    offs = torch.arange(bs, device=dev)
    outs = []
    for lo in range(0, nq, Q_BLOCKS_PER_STEP):
        hi = min(lo + Q_BLOCKS_PER_STEP, nq)
        n = hi - lo
        ids = ids_all[lo:hi]                                 # [n, W]
        valid = ids >= 0
        safe = ids.clamp(0, nq - 1).reshape(-1)
        kg = kb[:, safe].reshape(B, n, W, bs, H, hd)
        vg = vb[:, safe].reshape(B, n, W * bs, H, hd)
        s = torch.einsum("bnqhd,bnwthd->bnhqwt", qb[:, lo:hi], kg) * scale
        q_pos = (torch.arange(lo, hi, device=dev)[:, None] * bs
                 + offs)                                      # [n, bs]
        k_pos = ids[:, :, None] * bs + offs                   # [n, W, bs]
        mask = (valid[:, None, :, None]
                & (k_pos[:, None] <= q_pos[:, :, None, None]))  # [n,q,W,t]
        s = torch.where(mask[None, :, None], s, -1e30)
        p = torch.softmax(s.reshape(B, n, H, bs, W * bs), dim=-1)
        outs.append(torch.einsum("bnhqm,bnmhd->bnqhd", p, vg))
    return torch.cat(outs, 1).reshape(B, S, H, hd).to(q.dtype)
