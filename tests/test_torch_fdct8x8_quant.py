"""Port parity: the fused 8×8 DCT + quant (counterpart of the Pallas kernel).

The port's plain version is held against the Pallas kernel in interpret
mode and against the reference einsum path, at the tolerance of
tests/test_pallas_dct.py: float summation order can flip the round-half
boundary on a handful of coefficients, so |Δ| ≤ 1 on < 0.5 % of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.codecs import jpeg_common as jc
from go_dicom_codec_tpu.ops import dct8x8 as ref
from go_dicom_codec_tpu.ops.pallas_dct import encode_plane_blocks_pallas
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch.ops import dct8x8 as port
from go_dicom_codec_torch.ops.fdct8x8_quant import (encode_plane_blocks,
                                                    fdct8x8_quant)


def _assert_close(got, want):
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1
    assert (d != 0).mean() < 0.005


@pytest.mark.parametrize("shape", [(64, 128), (64, 136), (33, 17), (8, 8)])
@pytest.mark.parametrize("quality", [50, 90])
def test_port_matches_pallas_and_einsum(shape, quality, rng):
    h, w = shape
    img = rng.integers(0, 4096, (h, w)).astype(np.int32)
    q = jc.scale_quant_table(jc.LUMA_QUANT, quality, 255)

    got = encode_plane_blocks(torch.as_tensor(img), q, level_shift=2048)
    assert got.dtype == torch.int32
    got = got.numpy()
    pallas = encode_plane_blocks_pallas(img, q, level_shift=2048,
                                        interpret=True)
    p = np.asarray(ref.pad_replicate_to_8(jnp.asarray(img))
                   ).astype(np.float32) - 2048
    einsum = np.asarray(ref.quantize(ref.fdct8x8(ref.to_blocks(
        jnp.asarray(p))), jnp.asarray(q)))
    assert got.shape == einsum.shape == pallas.shape
    _assert_close(got, pallas)
    _assert_close(got, einsum)


def test_batched_raster_layout_matches_blocks(rng):
    x = rng.integers(0, 4096, (3, 16, 24)).astype(np.int32)
    q = port.scale_quant_table(port.LUMA_QUANT, 75, 255)
    out = fdct8x8_quant(torch.as_tensor(x), q, level_shift=2048).numpy()
    for b in range(3):
        blocks = encode_plane_blocks(torch.as_tensor(x[b]), q, 2048).numpy()
        np.testing.assert_array_equal(
            out[b].reshape(2, 8, 3, 8).transpose(0, 2, 1, 3), blocks)


@pytest.mark.parametrize("shape", [(8, 8), (13, 21), (16, 24)])
def test_helpers_bit_exact(shape, rng):
    x = rng.integers(-1000, 1000, shape).astype(np.int32)
    padded = port.pad_replicate_to_8(torch.as_tensor(x))
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(ref.pad_replicate_to_8(jnp.asarray(x))))
    blocks = port.to_blocks(padded)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(ref.to_blocks(jnp.asarray(padded))))
    np.testing.assert_array_equal(port.from_blocks(blocks).numpy(),
                                  padded.numpy())
    c = rng.normal(0, 300, (5, 8, 8)).astype(np.float32)
    c[0, 0, :4] = [16.0, -16.0, 8.0, -8.0]  # exact half-way cases
    q = torch.full((64,), 32.0)
    np.testing.assert_array_equal(
        port.quantize(torch.as_tensor(c), q).numpy(),
        np.asarray(ref.quantize(jnp.asarray(c), jnp.asarray(q.numpy()))))


def test_constants_match_reference():
    np.testing.assert_array_equal(port._D_np, ref._D_np)
    assert port._D_np.dtype == ref._D_np.dtype
    np.testing.assert_array_equal(port.LUMA_QUANT, jc.LUMA_QUANT)
    for quality in range(1, 101):
        np.testing.assert_array_equal(
            port.scale_quant_table(port.LUMA_QUANT, quality, 255),
            jc.scale_quant_table(jc.LUMA_QUANT, quality, 255))
    with pytest.raises(TypeError):   # no default device
        port.tables_from_numpy(ref._D_np, jc.LUMA_QUANT)
    d, q = port.tables_from_numpy(ref._D_np, jc.LUMA_QUANT,
                                  torch.device("cpu"))
    assert d.device.type == "cpu"
    assert d.dtype == q.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), ref._D_np)
    np.testing.assert_array_equal(q.numpy(), jc.LUMA_QUANT.reshape(64))


def test_kernel_wrapper_rejects_cpu_tensors():
    x = torch.zeros((1, 8, 8), dtype=torch.int32)
    d, q = port.tables_from_numpy(port._D_np, port.LUMA_QUANT,
                                  torch.device("cpu"))
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.fdct8x8_quant(x, torch.empty_like(x), d.reshape(64), q, 128)
    with pytest.raises(ValueError, match="no lane"):
        fdct8x8_quant(x.to("meta"), q, 128)


# ---- a model of csrc/fdct8x8_quant.cu's walk ------------------------------
#
# The kernel cannot run here, so this numpy model follows its index
# arithmetic: a persistent grid of blocks of 8 warps, each warp walking
# tiles of 8 rows × 32 columns by the division-free step, each lane moving
# two 16-byte chunks (memory roles) and computing one column, then one row,
# of one 8×8 block (compute roles), through the warp's shared tile at a
# block pitch of 72 floats.

WARPS, TILE_W, PITCH = 8, 32, 72
LANES = np.arange(32)
M, RM = LANES & 7, LANES >> 3       # memory roles: chunk, first row
BLK, J = LANES >> 3, LANES & 7      # compute roles: block, column/row


def _walk(n_tiles, tiles_x, resident):
    """Every (warp, tile, g, tx) the kernel's warps visit, in order, with
    the grid the C entry launches: min(ceil(n_tiles / 8), resident)."""
    grid = min(-(-n_tiles // WARPS), resident)
    stride = grid * WARPS
    sq, sr = divmod(stride, tiles_x)
    for warp in range(min(stride, n_tiles)):
        tile = warp
        g, tx = divmod(tile, tiles_x)
        while tile < n_tiles:
            assert g * tiles_x + tx == tile   # the step is exact
            yield warp, tile, g, tx
            tile, g, tx = tile + stride, g + sq, tx + sr
            if tx >= tiles_x:
                tx, g = tx - tiles_x, g + 1


def _chunks(g, tx, w):
    """[32, 2] element offsets of each lane's two chunks (rows rm and
    rm + 4), [32] their first column, and [32] whether the lane's block
    lies inside the plane."""
    col = tx * TILE_W + M * 4
    first = (g * 8 + RM) * w + col
    inside = tx * TILE_W + (M >> 1) * 8 < w
    return np.stack([first, first + 4 * w], axis=1), col, inside


def _coverage(shape, resident):
    b, h, w = shape
    tiles_x = -(-w // TILE_W)
    n_tiles = b * (h // 8) * tiles_x
    hits = np.zeros(b * h * w, np.int64)
    tiles = []
    for _, tile, g, tx in _walk(n_tiles, tiles_x, resident):
        offs, col, inside = _chunks(g, tx, w)
        for k in range(4):   # four int32 a 16-byte chunk
            np.add.at(hits, (offs[inside] + k).ravel(), 1)
        assert (offs[inside] % 4 == 0).all()   # 16-byte aligned chunks
        assert (col[~inside] >= w).all()   # masked: past W, and only so
        assert (col[inside] + 4 <= w).all()
        tiles.append(tile)
    return hits, sorted(tiles) == list(range(n_tiles))


SMALL_SHAPES = [(1, 8, 40), (3, 8, 40), (1, 64, 40), (5, 24, 136),
                (7, 8, 8), (1, 8, 8), (3, 56, 96)]


@pytest.mark.parametrize("shape, resident",
                         [((32, 512, 512), 264)]
                         + [(s, r) for s in SMALL_SHAPES for r in (264, 5, 1)])
def test_kernel_walk_covers_every_sample_once(shape, resident):
    """Loads and stores take the same chunks: each sample exactly once,
    every tile once, the chunks past W masked, whatever the grid (the
    card's 2 blocks an SM, a grid smaller than B × H/8, one block)."""
    hits, every_tile = _coverage(shape, resident)
    assert every_tile
    assert (hits == 1).all()


def _banks(word_offsets):
    return np.asarray(word_offsets) % 32


def test_kernel_shared_tile_roles_and_banks(rng):
    """The chunks a lane stores land where the compute lanes read their
    block's columns and rows, and Z rows go back out as the chunks of the
    load; each quarter warp's 16-byte access and each 4-byte column access
    hits distinct banks."""
    tile = rng.integers(-2048, 2048, (8, TILE_W))
    smem = np.full(4 * PITCH, np.nan)
    chunk_base = (M >> 1) * PITCH + RM * 8 + (M & 1) * 4
    for lane in range(32):
        for k in range(2):   # rows rm and rm + 4: 32 floats further
            r = RM[lane] + 4 * k
            smem[chunk_base[lane] + 32 * k + np.arange(4)] = \
                tile[r, M[lane] * 4 + np.arange(4)]
    blocks = tile.reshape(8, 4, 8).transpose(1, 0, 2)   # [blk, row, col]
    for k in range(8):   # column reads: lane (blk, j) reads X[blk][k][j]
        addr = BLK * PITCH + k * 8 + J
        np.testing.assert_array_equal(smem[addr], blocks[BLK, k, J])
        assert len(set(_banks(addr))) == 32
    for q in range(4):   # quarter warps of the chunk accesses
        lanes = LANES[8 * q:8 * q + 8]
        for k in range(2):
            words = np.concatenate([chunk_base[i] + 32 * k + np.arange(4)
                                    for i in lanes])
            assert len(set(_banks(words))) == 32
    # Z rows: lane (blk, j) writes row j of its block, half (j >= 4) first
    z = rng.integers(-99, 99, (4, 8, 8))
    zs = np.full(4 * PITCH, -1)
    for step in range(2):
        words = []
        for lane in range(32):
            half = (J[lane] >= 4) ^ step
            at = BLK[lane] * PITCH + J[lane] * 8 + half * 4 + np.arange(4)
            zs[at] = z[BLK[lane], J[lane], half * 4 + np.arange(4)]
            words.append(at)
        for q in range(4):
            assert len(set(_banks(np.concatenate(words[8 * q:8 * q + 8])))) \
                == 32
    out = np.zeros((8, TILE_W), np.int64)
    for lane in range(32):
        for k in range(2):
            out[RM[lane] + 4 * k, M[lane] * 4 + np.arange(4)] = \
                zs[chunk_base[lane] + 32 * k + np.arange(4)]
    np.testing.assert_array_equal(out.reshape(8, 4, 8).transpose(1, 0, 2), z)


def test_kernel_wrapper_checks_alignment(monkeypatch):
    """A view that does not start on a 16-byte boundary is refused before
    the launch; ops.fdct8x8_quant copies such a view first. (Run here with
    the device check stubbed: the check itself needs no card.)"""
    base = torch.zeros(4 * 8 * 8 + 1, dtype=torch.int32)
    assert _kernels.aligned16(base[:256]) and _kernels.aligned16(base[4:260])
    odd = base[1:257].view(4, 8, 8)
    assert not _kernels.aligned16(odd)
    monkeypatch.setattr(_kernels, "_require", lambda *a: None)
    monkeypatch.setattr(_kernels, "_load", lambda: pytest.fail("launched"))
    d, q = port.tables_from_numpy(port._D_np, port.LUMA_QUANT,
                                  torch.device("cpu"))
    with pytest.raises(_kernels.KernelLaunchError, match="16-byte"):
        _kernels.fdct8x8_quant(odd, torch.empty_like(odd), d.reshape(64), q,
                               128)
    with pytest.raises(_kernels.KernelLaunchError, match="16-byte"):
        _kernels.fdct8x8_quant(base[:256].view(4, 8, 8), odd, d.reshape(64),
                               q, 128)
