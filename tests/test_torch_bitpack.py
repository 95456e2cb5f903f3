"""PyTorch port vs the JAX reference: the bit-packing kernels.

``pack_columns``, ``pack_activations``, ``BitMatrix.pack``, ``pack_dense``
(row- and column-major) and ``bit_transpose`` take the same numpy-seeded
inputs in both packages on the CPU, where the port's wrappers run their
plain versions and the reference its Pallas kernels in interpret mode.
The words must be equal as ``np.uint32``. The shapes are ragged (n, m and
D not multiples of t; D = 1, 5, 130), so the port's unpadded kernels are
held against the reference's padded wrappers. The tests marked ``cuda``
hold the kernels against their plain versions on the card and skip here.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core.operands import BitMatrix as RBitMatrix
    from repro.gnn_bit import binarize as rbin
    from repro.kernels.bitpack import ops as rops
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core.operands import BitMatrix  # noqa: E402
from repro_torch.core.words import from_numpy_u32, to_numpy_u32  # noqa: E402
from repro_torch.gnn_bit import binarize  # noqa: E402
from repro_torch.kernels.bitpack import bitpack, ops, ref  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

TILE_DIMS = (4, 8, 16, 32)


def feats(seed: int, n: int, d: int) -> np.ndarray:
    """Signed features, a third of them exactly 0."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    x[np.abs(x) < 0.43] = 0.0
    return x


@needs_reference
@pytest.mark.parametrize("t", TILE_DIMS)
def test_activation_packing_matches_reference(t):
    for n, d in ((37, 1), (70, 5), (45, 130)):
        x = feats(t + d, n, d)
        want = np.asarray(rops.pack_columns(jnp.asarray(x), t))
        got = ops.pack_columns(torch.from_numpy(x), t)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        assert np.array_equal(to_numpy_u32(got), want), (n, d)
        assert np.array_equal(
            to_numpy_u32(BitMatrix.pack(torch.from_numpy(x), t).words),
            np.asarray(RBitMatrix.pack(jnp.asarray(x), t).words))
        # pack_activations packs x > 0 (strict), the others x != 0
        pa = binarize.pack_activations(torch.from_numpy(x), t)
        ra = rbin.pack_activations(jnp.asarray(x), t)
        assert (pa.n, pa.tile_dim) == (ra.n, ra.tile_dim) == (n, t)
        assert np.array_equal(to_numpy_u32(pa.words), np.asarray(ra.words))
        assert torch.equal(pa.unpack(torch.bool), torch.from_numpy(x > 0))


@needs_reference
@pytest.mark.parametrize("t", TILE_DIMS)
def test_pack_dense_and_bit_transpose_match_reference(t):
    rng = np.random.default_rng(t)
    x = rng.random((45, 70)) < 0.3
    for col_major in (False, True):
        want = np.asarray(rops.pack_dense(jnp.asarray(x), t, col_major))
        got = ops.pack_dense(torch.from_numpy(x), t, col_major)
        assert tuple(got.shape) == want.shape == (-(-45 // t), -(-70 // t), t)
        assert np.array_equal(to_numpy_u32(got), want), col_major
    # float input binarizes with != 0, as the reference does
    xf = feats(t, 45, 70)
    assert np.array_equal(
        to_numpy_u32(ops.pack_dense(torch.from_numpy(xf), t)),
        np.asarray(rops.pack_dense(jnp.asarray(xf), t)))
    lo = np.uint64(1 << t) - np.uint64(1)
    words = (rng.integers(0, 2 ** 32, (3, 5, t), dtype=np.uint64)
             & lo).astype(np.uint32)
    want = np.asarray(rops.bit_transpose(jnp.asarray(words), t))
    got = ops.bit_transpose(from_numpy_u32(words, "cpu"), t)
    assert tuple(got.shape) == words.shape
    assert np.array_equal(to_numpy_u32(got), want)
    twice = ops.bit_transpose(got, t)
    assert np.array_equal(to_numpy_u32(twice), words)


def test_wrappers_check_inputs_and_count_only_launches():
    x = torch.ones(10, 3)
    with pytest.raises(ValueError, match="tile dim"):
        bitpack.pack_rows(x, 6)
    with pytest.raises(ValueError, match="2-D"):
        bitpack.pack_rows(torch.ones(10), 8)
    with pytest.raises(ValueError, match="contiguous"):
        bitpack.pack_dense(torch.ones(3, 10).T, 8)
    with pytest.raises(ValueError, match=r"\[N, 8\]"):
        bitpack.bit_transpose(torch.zeros(4, 4, dtype=torch.int32), 8)
    with pytest.raises(TypeError, match="int32"):
        bitpack.bit_transpose(torch.zeros(4, 8, dtype=torch.int64), 8)
    # a dtype the kernels do not take is binarized first
    xd = torch.from_numpy(feats(1, 10, 3).astype(np.float64))
    assert torch.equal(bitpack.pack_rows(xd, 8), ref.pack_rows(xd != 0, 8))
    before = (bitpack.pack_rows.launches, bitpack.pack_dense.launches,
              bitpack.bit_transpose.launches)
    bitpack.pack_rows(x, 8)                  # CPU: the plain versions
    bitpack.pack_dense(x, 8)
    bitpack.bit_transpose(torch.zeros(2, 8, dtype=torch.int32), 8)
    assert (bitpack.pack_rows.launches, bitpack.pack_dense.launches,
            bitpack.bit_transpose.launches) == before


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", TILE_DIMS)
def test_bitpack_kernels_match_plain_on_card(cuda, t):
    rng = np.random.default_rng(t)
    for n, d in ((1, 1), (37, 16), (1000, 33), (70, 130)):
        xf = torch.from_numpy(feats(t + d, n, d)).to(cuda)
        for x in (xf, xf > 0, (xf != 0).to(torch.uint8),
                  (xf != 0).to(torch.int32)):
            before = bitpack.pack_rows.launches
            got = bitpack.pack_rows(x, t)
            assert bitpack.pack_rows.launches == before + 1
            assert torch.equal(got, ref.pack_rows(x, t)), (n, d, x.dtype)
    for n, m in ((1, 1), (45, 70), (300, 1000)):
        x = torch.from_numpy(rng.random((n, m)) < 0.3).to(cuda)
        for col_major in (False, True):
            for xx in (x, x.float()):
                assert torch.equal(bitpack.pack_dense(xx, t, col_major),
                                   ref.pack_dense(xx, t, col_major))
    words = from_numpy_u32(rng.integers(0, 2 ** 32, (1001, t),
                                        dtype=np.uint64).astype(np.uint32),
                           cuda)
    before = bitpack.bit_transpose.launches
    got = bitpack.bit_transpose(words, t)
    assert bitpack.bit_transpose.launches == before + 1
    assert torch.equal(got, ref.bit_transpose(words, t))
