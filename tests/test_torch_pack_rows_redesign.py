"""PyTorch port vs the JAX reference: ``pack_rows``, the activation
packing of the BitGNN layers.

The same numpy-seeded entries go through ``repro.kernels.bitpack.ops.
pack_columns`` (its Pallas kernel in interpret mode) and the port's
``pack_columns`` on the CPU (the wrapper's plain version), at every tile
dim, on ragged shapes (70 rows: not a multiple of 32 or of any tile dim;
D = 1, 7, 16, 33, 130), every entry type the kernel takes (and float16,
which the wrapper binarizes first), float32 with -0.0 and NaN, and views
with a storage offset. The words must be equal as ``np.uint32``. The
tests marked ``cuda`` hold the kernel against its plain version on the
same inputs (16-byte loads and the scalar path both) and skip here.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.kernels.bitpack import ops as rbitpack
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core.b2sr import TILE_DIMS  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.kernels.bitpack import bitpack, ops  # noqa: E402
from repro_torch.kernels.bitpack import ref  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 70                                   # not a multiple of 4, 8, 16, 32
WIDTHS = (1, 7, 16, 33, 130)             # 16 takes the kernel's vector path
DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.float32)


def entries(dtype, n: int, d: int, seed: int) -> np.ndarray:
    """0/1-pattern ``[n, d]`` entries of ``dtype`` (as numpy), about 30%
    non-zero: negative int8 and int32 values, float32 with -0.0 for half
    its zeros and a NaN, large int32 values whose low byte is 0."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n, d)) < 0.3
    v = rng.integers(-3, 4, (n, d))
    v[v == 0] = 2
    if dtype == torch.bool:
        return keep
    if dtype == torch.uint8:
        return np.where(keep, np.abs(v), 0).astype(np.uint8)
    if dtype == torch.int8:
        return np.where(keep, v, 0).astype(np.int8)
    if dtype == torch.int32:
        return np.where(keep, v * 256, 0).astype(np.int32)
    if dtype == torch.float16:
        return np.where(keep, v * 0.5, 0.0).astype(np.float16)
    x = np.where(keep, v * 0.25, 0.0).astype(np.float32)
    x[~keep & (rng.random((n, d)) < 0.5)] = -0.0
    x[0, -1] = np.nan
    return x


def ref_words(x: np.ndarray, t: int) -> np.ndarray:
    return np.asarray(rbitpack.pack_columns(jnp.asarray(x), t,
                                            interpret=True))


def port_words(x, t: int) -> np.ndarray:
    return to_numpy_u32(ops.pack_columns(torch.as_tensor(x), t))


@needs_reference
@pytest.mark.parametrize("t", TILE_DIMS)
@pytest.mark.parametrize("dtype", (*DTYPES, torch.float16),
                         ids=lambda d: str(d)[6:])
def test_plain_pack_rows_matches_reference(dtype, t):
    for d in WIDTHS:
        x = entries(dtype, N, d, d + t)
        got = port_words(x, t)
        assert got.shape == (-(-N // t), d)
        assert np.array_equal(got, ref_words(x, t)), d


@needs_reference
@pytest.mark.parametrize("t", TILE_DIMS)
def test_plain_pack_rows_negative_zero_and_nan(t):
    # -0.0 packs as 0 and NaN as 1, as `x != 0` gives them
    x = np.zeros((N, 16), dtype=np.float32)
    x[::3, 5] = -0.0
    x[1::3, 5] = np.nan
    x[2::5, 9] = -0.0
    x[4::5, 9] = 1e-30
    got = port_words(x, t)
    assert np.array_equal(got, ref_words(x, t))
    # bit r of word [c, j] is row c*t + r
    bits = (got[:, None, :] >> np.arange(t, dtype=np.uint32)[None, :, None]
            ) & 1
    rows = bits.reshape(-1, 16)[:N].astype(bool)
    assert np.array_equal(rows, x != 0)
    assert rows[1::3, 5].all() and not rows[::3, 5].any()
    assert rows[4::5, 9].all() and not rows[2::5, 9].any()


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_plain_pack_rows_of_an_offset_view_matches_reference(dtype):
    flat = torch.from_numpy(entries(dtype, 1, N * 16 + 8, 3)).flatten()
    for off, t in ((5, 8), (3, 32), (1, 4)):
        view = flat[off:off + N * 16].view(N, 16)
        assert view.is_contiguous() and view.storage_offset() == off
        got = to_numpy_u32(bitpack.pack_rows(view, t))
        assert np.array_equal(got, ref_words(view.numpy(), t)), (off, t)


def test_cpu_pack_rows_counts_no_launch():
    x = torch.from_numpy(entries(torch.float32, N, 33, 1))
    before = bitpack.pack_rows.launches
    for t in TILE_DIMS:
        assert torch.equal(bitpack.pack_rows(x, t), ref.pack_rows(x, t))
    assert bitpack.pack_rows.launches == before


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _card_inputs(dev):
    """(label, entries) on the card: each type at WIDTHS and at n = 70,
    1,000 and 4,133 (several groups a warp; a last group cut short), and
    views with an offset of 5 entries (scalar path) and of 16 bytes
    (16-byte loads from an offset base)."""
    for dtype, n, d in itertools.product(DTYPES, (N, 1000, 4133), WIDTHS):
        yield f"{dtype} [{n}, {d}]", torch.from_numpy(
            entries(dtype, n, d, n + d)).to(dev)
    for dtype in DTYPES:
        flat = torch.from_numpy(entries(dtype, 1, 4133 * 16 + 64, 3)
                                ).flatten().to(dev)
        for off in (5, 16 // flat.element_size()):
            yield (f"{dtype} offset {off}",
                   flat[off:off + 4133 * 16].view(4133, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("t", TILE_DIMS)
def test_pack_rows_matches_plain_on_card(cuda, t):
    for label, x in _card_inputs(cuda):
        before = bitpack.pack_rows.launches
        got = bitpack.pack_rows(x, t)
        assert bitpack.pack_rows.launches == before + 1
        assert torch.equal(got, ref.pack_rows(x, t)), label


@pytest.mark.cuda
def test_pack_rows_main_path_shape_on_card(cuda):
    # gnn_infer's hidden layer at gcn-cora's widths on a 2^21-node graph
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((1 << 21, 16), generator=gen, device=cuda).relu()
    for x in (h > 0, h):
        assert torch.equal(bitpack.pack_rows(x, 32), ref.pack_rows(x, 32))


@pytest.mark.cuda
def test_pack_rows_wider_than_the_grid_on_card(cuda):
    # more runs of 32 columns than the grid's 65,535: blocks walk several
    d = 32 * 65535 + 45
    gen = torch.Generator(device=cuda).manual_seed(1)
    for n, dtype in ((37, torch.bool), (5, torch.float32)):
        x = (torch.rand((n, d), generator=gen, device=cuda) < 0.3).to(dtype)
        for t in (4, 32):
            assert torch.equal(bitpack.pack_rows(x, t), ref.pack_rows(x, t))
