"""Port parity: reversible 5/3 DWT, bit-exact against the JAX package.

Covers the shape, parity, origin and level matrix of tests/test_dwt53.py
and tests/test_wavelet_sizes.py, the geometry helpers the port copies,
and the kernel lane's host side: the fused stages' level tables for every
line length (each checked as csrc/lifting.cuh::read_schedule checks it),
and the kernel lane run through the numpy models of one launch of each
stage (tests/test_torch_j2k_*_stage.py) at tiles of 4 samples, over the
odd-shape matrix and long, thin windows.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import dwt53 as ref
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch.ops import dwt53 as port


def _jax_fwd(x, levels, x0=0, y0=0):
    # the jit wrapper compiles one program per shape, several times faster
    # here than the op-by-op eager call of the same function
    return np.asarray(ref.fwd53_multilevel_jit(jnp.asarray(x), levels, x0,
                                               y0))


def _check_multilevel(x, levels, x0=0, y0=0):
    """Forward bit-exact against JAX; the inverse must give x back, which
    is what the JAX inverse gives (pinned by the reference's own tests)."""
    t = torch.as_tensor(x)
    got = port.fwd53_multilevel_(t.clone(), levels, x0, y0)
    np.testing.assert_array_equal(got.numpy(), _jax_fwd(x, levels, x0, y0))
    back = port.inv53_multilevel_(got, levels, x0, y0)
    np.testing.assert_array_equal(back.numpy(), x)


def test_geometry_helpers_match_reference():
    for w, h, x0, y0 in itertools.product(range(0, 12), range(0, 12),
                                          range(4), range(4)):
        assert port.next_window(w, h, x0, y0) == ref.next_window(w, h, x0, y0)
        for levels in range(0, 7):
            assert (port.ll_dimensions(w, h, levels, x0, y0)
                    == ref.ll_dimensions(w, h, levels, x0, y0))
            assert (port._level_windows(w, h, levels, x0, y0)
                    == ref._level_windows(w, h, levels, x0, y0))
    for n in range(0, 9):
        for even in (True, False):
            assert port.low_len(n, even) == ref.low_len(n, even)


WIDTHS = [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 31, 64, 127, 128]


@pytest.mark.parametrize("even", [True, False])
@pytest.mark.parametrize("w", WIDTHS)
def test_1d_bit_exact(w, even, rng):
    x = rng.integers(-(1 << 14), 1 << 14, (3, w)).astype(np.int32)
    got = port.fwd53_1d(torch.as_tensor(x), even)
    want = np.asarray(ref.fwd53_1d(jnp.asarray(x), even))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port.inv53_1d(got, even)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.inv53_1d(jnp.asarray(want), even)))
    np.testing.assert_array_equal(back.numpy(), x)


SHAPES_2D = [(1, 1), (1, 8), (8, 1), (2, 2), (3, 5), (5, 3), (8, 8), (9, 7),
             (16, 16), (17, 31), (64, 64), (33, 129)]


@pytest.mark.parametrize("even_row", [True, False])
@pytest.mark.parametrize("even_col", [True, False])
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_2d_bit_exact(shape, even_row, even_col, rng):
    x = rng.integers(-(1 << 12), 1 << 12, shape).astype(np.int32)
    got = port.fwd53_2d(torch.as_tensor(x), even_row, even_col)
    want = np.asarray(ref.fwd53_2d(jnp.asarray(x), even_row, even_col))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port.inv53_2d(got, even_row, even_col)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("levels", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,origin", [((64, 64), (0, 0)),
                                          ((60, 52), (3, 1)),
                                          ((127, 129), (0, 0)),
                                          ((33, 20), (5, 7))])
def test_multilevel_bit_exact(shape, origin, levels, rng):
    x = rng.integers(-(1 << 12), 1 << 12, (2,) + shape).astype(np.int32)
    _check_multilevel(x, levels, *origin)


def _gradient(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return ((x + y) % 256).astype(np.int32)


@pytest.mark.parametrize("size", [192, 256])
@pytest.mark.parametrize("levels", [1, 3, 5])
def test_large_square_bit_exact(size, levels):
    _check_multilevel(_gradient(size, size), levels)


@pytest.mark.parametrize("shape", [(256, 192), (192, 256), (255, 255),
                                   (257, 255), (253, 1), (1, 253),
                                   (129, 127), (96, 33)])
def test_odd_rect_bit_exact(shape, rng):
    data = rng.integers(-2048, 2048, shape).astype(np.int32)
    for levels in ((1, 2, 5) if shape == (129, 127) else (5,)):
        _check_multilevel(data, levels)


@pytest.mark.parametrize("origin", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_256_odd_origin_bit_exact(origin, rng):
    data = rng.integers(-1 << 14, 1 << 14, (256, 256)).astype(np.int32)
    _check_multilevel(data, 4, *origin)


@pytest.mark.parametrize("case", ["deep", "extreme", "batch"])
def test_special_inputs_bit_exact(case, rng):
    if case == "deep":      # more levels than the image supports
        _check_multilevel(rng.integers(-100, 100, (16, 16)).astype(np.int32),
                          10)
    elif case == "extreme":  # 16-bit extremes through 5 levels
        data = np.full((64, 64), 32767, dtype=np.int32)
        data[::2, ::2] = -32768
        _check_multilevel(data, 5)
    else:
        _check_multilevel(
            rng.integers(-4096, 4096, (6, 96, 64)).astype(np.int32), 3)


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 7, 8])
def test_tiny_sizes_bit_exact(size, rng):
    data = rng.integers(-500, 500, (size, size)).astype(np.int32)
    for levels in (1, 2):
        _check_multilevel(data, levels)


# ---- kernel lane, host side -------------------------------------------------

INT32_MAX = (1 << 31) - 1


def read_schedule(schedule, width, height, inverse):
    """csrc/lifting.cuh::read_schedule's checks of a stage's table for
    planes of width × height, and the tiles of each grid row and of the
    first level counted in an int, as the kernels count them."""
    tile, words, rows = schedule
    assert 0 <= len(rows) <= _kernels.STAGE_MAX_ROWS
    assert 2 <= tile <= _kernels.STAGE_MAX_TILE and tile % 2 == 0
    assert 0 <= words <= INT32_MAX
    for k, (kind, w, h, even_x, even_y, in_off, out_off) in enumerate(rows):
        area = w * h
        ll = ((w + even_x) >> 1) * ((h + even_y) >> 1)
        in_words, out_words = (ll, area) if inverse else (area, ll)
        assert kind in port.ROW_KINDS.values()
        assert 1 <= w <= width and 1 <= h <= height
        assert in_off >= -1 and out_off >= -1
        assert (in_off >= 0) == (k > 0)
        assert (out_off >= 0) == (k < len(rows) - 1)
        assert in_off < 0 or in_off + in_words <= words
        assert out_off < 0 or out_off + out_words <= words
        assert max(abs(v) for v in (w, h, in_off, out_off)) <= INT32_MAX
        assert -(-w // tile) * -(-h // tile) <= INT32_MAX


@pytest.fixture
def stage_models(monkeypatch):
    """Both stages' kernel lane on CPU tensors through their launch models
    at tiles of 4 samples (the tables built anew, and none left in the
    caches after the test); no other kernel may launch. Yields the
    launches' epilogues, forward and inverse in order."""
    from test_torch_j2k_fwd_stage import _stage_model, no_other_kernels
    from test_torch_j2k_inv_stage import _inv_stage_model

    launches = []
    no_other_kernels(monkeypatch, ("j2k_fwd_stage", "j2k_inv_stage"))
    monkeypatch.setattr(_kernels, "j2k_fwd_stage", _stage_model(launches))
    monkeypatch.setattr(_kernels, "j2k_inv_stage",
                        _inv_stage_model(launches))
    monkeypatch.setattr(port, "_TILE", 4)
    port.fwd_schedule.cache_clear()
    port.inv_schedule.cache_clear()
    yield launches
    port.fwd_schedule.cache_clear()
    port.inv_schedule.cache_clear()


def _stage_round_trip(x, levels, origin, want_fwd, want_inv):
    """x through the forward stage's and then the inverse stage's kernel
    lane, each one launch, against the reference's coefficients and
    reconstruction."""
    got = port._fwd_multilevel_kernel_(torch.tensor(x), levels, *origin)
    np.testing.assert_array_equal(got.numpy(), want_fwd)
    back = port._inv_multilevel_kernel_(got, levels, *origin)
    np.testing.assert_array_equal(back.numpy(), want_inv)
    np.testing.assert_array_equal(back.numpy(), x)


KERNEL_LANE_CASES = [((3, 61, 37), o, lv) for o in [(0, 0), (1, 0), (0, 1),
                                                      (1, 1)]
                     for lv in (1, 3, 6)] + [
    ((2, h, w), (1, 1), 2) for h, w in [(1, 1), (1, 5), (6, 1), (2, 7)]]


@pytest.mark.parametrize("shape,origin,levels", KERNEL_LANE_CASES)
def test_kernel_lane_model_bit_exact(shape, origin, levels, stage_models,
                                     rng):
    """The odd-shape, origin and level matrix through both stages' launch
    models at tiles of 4 samples: the forward against JAX, the inverse
    back to the input."""
    x = rng.integers(-4096, 4096, shape).astype(np.int32)
    _stage_round_trip(x, levels, origin, _jax_fwd(x, levels, *origin), x)
    assert stage_models == ["coeffs", "coeffs"]


# long and thin windows: tiles of 4 samples along a side of 97-301, one
# or two samples across (the fold at n = 1 and n = 2, the ×2 and >>1
# rule), both ways
THIN_SHAPES = [(1, 2, 301), (1, 301, 2), (2, 5, 129), (2, 129, 5),
               (1, 1, 97), (1, 97, 1)]


@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("origin", [(0, 0), (1, 1)])
@pytest.mark.parametrize("shape", THIN_SHAPES)
def test_long_thin_windows_bit_exact(shape, origin, levels, stage_models,
                                     rng):
    """Long, thin windows through both stages' launch models, bit-exact
    against the JAX package's op-by-op fwd53_multilevel and
    inv53_multilevel."""
    x = rng.integers(-4096, 4096, shape).astype(np.int32)
    want = np.asarray(ref.fwd53_multilevel(jnp.asarray(x), levels, *origin))
    back = np.asarray(ref.inv53_multilevel(jnp.asarray(want), levels,
                                           *origin))
    _stage_round_trip(x, levels, origin, want, back)
    assert stage_models == ["coeffs", "coeffs"]


@pytest.mark.parametrize("shape", [(1, 8, 65535), (1, 65535, 8)])
def test_plain_lane_at_the_longest_lines(shape, rng):
    """The plain lane, the kernels' reference, bit-exact against the JAX
    package's op-by-op 5/3 at DICOM's longest side, forward and back."""
    x = rng.integers(-2048, 2048, shape).astype(np.int32)
    got = port.fwd53_multilevel_plain_(torch.tensor(x), 5)
    want = np.asarray(ref.fwd53_multilevel(jnp.asarray(x), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port.inv53_multilevel_plain_(got, 5)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.inv53_multilevel(jnp.asarray(want), 5)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("n", [58111, 58112, 60001, 65535])
def test_long_line_tables(n, axis):
    """Sides of 58111 (the longest the stages' shared memory held before
    the tile pass took every length), 58112, 60001 and 65535 (DICOM's
    longest), along rows or along columns, across 1, 2, 16 and n samples:
    the tables of both stages at 0-6 and 32 levels and both origin
    parities pass read_schedule's checks, and their first (forward) or
    last (inverse) row is the whole plane."""
    for m in (1, 2, 16, n):
        w, h = (n, m) if axis == "rows" else (m, n)
        for levels in (*range(7), 32):
            for x0, y0 in ((0, 0), (1, 1)):
                fwd = port.fwd_schedule(w, h, levels, x0, y0)
                inv = port.inv_schedule(w, h, levels, x0, y0)
                read_schedule(fwd, w, h, inverse=False)
                read_schedule(inv, w, h, inverse=True)
                if fwd[2]:
                    assert fwd[2][0][1:3] == inv[2][-1][1:3] == (w, h)
                assert inv[1] == fwd[1]
    if n == 65535:
        # the most scratch a plane takes: LL1 and, from three levels on,
        # LL2 of 65535², within the int of the kernels' table
        assert port.fwd_schedule(n, n, 2)[1] == 32768 ** 2
        for levels in (3, 5, 32):
            assert port.fwd_schedule(n, n, levels)[1] == (
                32768 ** 2 + 16384 ** 2) == 1342177280 <= INT32_MAX


def test_stage_refuses_planes_past_its_int32_indices(monkeypatch):
    """A plane whose table or tiles an int32 cannot count is refused
    before the launch (meta tensors: shapes without memory); a 65535²
    plane, DICOM's largest, passes the checks and reaches the launch."""
    class Launched(Exception):
        pass

    def launch():
        raise Launched
    monkeypatch.setattr(_kernels, "_require", lambda *args: None)
    monkeypatch.setattr(_kernels, "_load", launch)

    def fwd(h, w, levels):
        src = torch.empty((1, h, w), dtype=torch.uint16, device="meta")
        _kernels.j2k_fwd_stage(
            src, None, port.fwd_schedule(w, h, levels), 0, "narrow",
            narrow=torch.empty((1, h, w), dtype=torch.int16, device="meta"),
            maxabs=torch.empty(1, dtype=torch.int32, device="meta"))

    def inv(h, w, levels):
        src = torch.empty((1, h, w), dtype=torch.int16, device="meta")
        _kernels.j2k_inv_stage(src, torch.empty((1, h, w), dtype=torch.int32,
                                                device="meta"),
                               port.inv_schedule(w, h, levels), 1, "coeffs")

    for call in (fwd, inv):
        # 100000²: two LL areas of 3,125,000,000 words
        with pytest.raises(_kernels.KernelLaunchError, match="int32"):
            call(100000, 100000, 5)
        # a side past the fold's int period
        with pytest.raises(_kernels.KernelLaunchError, match="side"):
            call(1, _kernels.STAGE_MAX_SIDE + 1, 1)
    with pytest.raises(Launched):
        fwd(65535, 65535, 5)
    _kernels._stage_plane("j2k_inv_stage", 65535, 65535,
                          port.inv_schedule(65535, 65535, 5))
    with pytest.raises(_kernels.KernelLaunchError, match="code-blocks"):
        _kernels._stage_plane("j2k_fwd_stage", 65535, 65535,
                              port.fwd_schedule(65535, 65535, 5), cb=1)


def _parent_schedule(width, height, levels, x0, y0, inverse):
    """The stages' tables as they were built before any line over 58111
    samples reached them, rebuilt here from their rules (tiles of 64; a
    forward block row fits one tile; an inverse block row holds at most
    64² samples; two scratch areas in turns)."""
    wins = [(w, h, lx0, ly0) for (w, h, lx0, ly0)
            in ref._level_windows(width, height, levels, x0, y0)
            if not (w == h == 1 and lx0 % 2 == 0 and ly0 % 2 == 0)]
    if inverse:
        wins = wins[::-1]
        sizes = [w * h for (w, h, _, _) in wins[-2::-1]]
    else:
        sizes = [ref.low_len(w, lx0 % 2 == 0) * ref.low_len(h, ly0 % 2 == 0)
                 for (w, h, lx0, ly0) in wins[:-1]]
    slots = [0, sizes[0] if sizes else 0]
    outs = [slots[i % 2] for i in range(len(sizes))]
    if inverse:
        outs = outs[::-1]
    rows = tuple(
        (int(w * h <= 64 * 64 if inverse else (w <= 64 and h <= 64)), w, h,
         int(lx0 % 2 == 0), int(ly0 % 2 == 0), outs[i - 1] if i else -1,
         outs[i] if i < len(wins) - 1 else -1)
        for i, (w, h, lx0, ly0) in enumerate(wins))
    return (64, sum(sizes[:2]), rows)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(512, 512), (256, 256), (61, 37),
                                   (48, 40), (16, 16), (5, 1), (1, 6)])
def test_timed_tables_unchanged(shape, inverse):
    """The tables of the planes the device bench and the smoke time (512²
    frames, the mesh's 256² tiles) and of the launch-model matrix are
    those the stages ran before they took every line length, at 0-6
    levels and every origin: their rows cannot have moved."""
    w, h = shape
    build = port.inv_schedule if inverse else port.fwd_schedule
    for levels in range(7):
        for x0, y0 in ((0, 0), (1, 0), (0, 1), (1, 1)):
            assert build(w, h, levels, x0, y0) == _parent_schedule(
                w, h, levels, x0, y0, inverse)


def test_route_by_shape():
    """Every shape takes one launch of a fused stage, whose table follows
    from the shape alone, before any launch: lines of every length, up to
    DICOM's 65535 samples, along rows or along columns."""
    for n in (58104, 58111, 58112, 60001, 65535):
        assert port.fwd_schedule(n, 3, 5)[2][0][1:3] == (n, 3)
        assert port.fwd_schedule(3, n, 5)[2][0][1:3] == (3, n)
    # one row a level, finest first: levels 1-3 on the grid, 4 and 5 (64²
    # and 32², one tile each) in one block a plane; each level reads the
    # scratch area the level before wrote and writes the other
    grid, block = port.ROW_KINDS["grid"], port.ROW_KINDS["block"]
    tile, words, rows = port.fwd_schedule(512, 512, 5)
    assert (tile, words) == (64, 256 * 256 + 128 * 128)
    assert rows == ((grid, 512, 512, 1, 1, -1, 0),
                    (grid, 256, 256, 1, 1, 0, 65536),
                    (grid, 128, 128, 1, 1, 65536, 0),
                    (block, 64, 64, 1, 1, 0, 65536),
                    (block, 32, 32, 1, 1, 65536, -1))
    # a long line: every level on the grid, 1024 tiles at level 1 of a
    # 16-row frame, its LL areas in turns
    tile, words, rows = port.fwd_schedule(65535, 16, 5)
    assert words == 32768 * 8 + 16384 * 4
    assert [r[:3] for r in rows] == [(grid, 65535, 16), (grid, 32768, 8),
                                     (grid, 16384, 4), (grid, 8192, 2),
                                     (grid, 4096, 1)]
    assert -(-65535 // tile) * -(-16 // tile) == 1024
    # odd origin, 1-sample windows still run (the ×2 rule); windows of one
    # sample at even parity both ways change nothing and have no row
    assert port.fwd_schedule(1, 1, 2, 1, 1) == (
        64, 0, ((block, 1, 1, 0, 0, -1, -1),))
    assert port.fwd_schedule(1, 1, 3, 0, 0) == (64, 0, ())


@pytest.mark.parametrize("source", ["j2k_fwd_stage.cu", "j2k_inv_stage.cu",
                                    "lifting.cuh"])
def test_lifting_kernels_declare_no_static_shared_memory(source):
    """The fused stages take their shared memory as one dynamic buffer,
    the size the launch asks for (``stage_smem_bytes``), the block
    reduction's scratch in it too: a static __shared__ array beside it
    would add to that unseen."""
    text = (_kernels.CSRC / source).read_text()
    decls = [ln.strip() for ln in text.splitlines() if "__shared__" in ln
             and not ln.strip().startswith("//")]
    assert all(d.startswith("extern __shared__") for d in decls), decls


def test_lanes_by_device():
    x = torch.zeros((2, 8, 8), dtype=torch.int32)
    assert port.fwd53_multilevel_(x, 2) is x        # CPU: plain, in place
    with pytest.raises(ValueError, match="no lane"):
        port.fwd53_multilevel_(torch.zeros((8, 8), dtype=torch.int32,
                                           device="meta"), 1)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k_fwd_stage(x, x.clone(), port.fwd_schedule(8, 8, 2), 0,
                               "coeffs")
    # a line of any length (DICOM allows 65535 columns) reaches the device
    # check like any other: no route is refused or falls back
    long = torch.zeros((1, 1, 60000), dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k_inv_stage(long, long.clone(),
                               port.inv_schedule(60000, 1, 5), 1, "coeffs")
