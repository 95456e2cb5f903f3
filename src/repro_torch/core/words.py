"""Packed-word helpers: uint32 bit patterns held in ``torch.int32``.

torch has ``&``/``|``/``^`` on ``torch.uint32`` but not ``~``, ``>>`` or
``<<``, and no popcount, so the port keeps every packed word as an int32
*bit pattern*: the same 32 bits the reference holds as ``np.uint32``.
The CUDA kernels reinterpret the same buffers as ``uint32_t``. Two
things differ from unsigned arithmetic and live here:

  * ``>>`` on int32 is arithmetic (it copies the sign bit), so a logical
    shift masks the copied bits off (:func:`lshr`);
  * popcount is a SWAR reduction (:func:`popcount`) over the two 16-bit
    halves of each word, so no intermediate value leaves int32's
    non-negative range.

Words of a ``t < 32`` tile keep only their low ``t`` bits; ``~mask``
sets the high bits, exactly as the reference's ``~mask_packed`` does.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = torch.int32


def lane_mask(t: int) -> int:
    """The low-``t``-bits mask as an int32 bit pattern (``t == 32`` → -1)."""
    return -1 if t == 32 else (1 << t) - 1


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a constant ``s``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the int32 tensor of the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(WORD)


def to_uint(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _popcount16(h: torch.Tensor) -> torch.Tensor:
    """SWAR bit count of values in ``[0, 2**16)``."""
    h = h - ((h >> 1) & 0x5555)
    h = (h & 0x3333) + ((h >> 2) & 0x3333)
    h = (h + (h >> 4)) & 0x0F0F
    return (h * 0x0101) >> 8 & 0x1F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 bit patterns (int32 result)."""
    return _popcount16(x & 0xFFFF) + _popcount16(lshr(x, 16))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 ``[..., t]`` -> words ``int32[...]``: bit ``j`` is entry ``j``."""
    t = bits.shape[-1]
    shifts = torch.arange(t, dtype=torch.int64, device=bits.device)
    return to_int32(((bits != 0).to(torch.int64) << shifts).sum(-1))


def unpack_bits(words: torch.Tensor, t: int) -> torch.Tensor:
    """Words ``int32[...]`` -> bool ``[..., t]`` (LSB first)."""
    shifts = torch.arange(t, dtype=WORD, device=words.device)
    # arithmetic >> is exact here: bit j lands at position 0 either way
    return ((words.unsqueeze(-1) >> shifts) & 1) != 0


def from_numpy_u32(a, device) -> torch.Tensor:
    """``np.uint32`` words -> int32 bit-pattern tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> ``np.uint32`` (the reference's view)."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)
