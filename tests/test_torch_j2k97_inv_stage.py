"""Port parity: the 9/7 decode stage, bit-exact against the JAX package.

A numpy model of one csrc/j2k97_inv_stage.cu launch stands in for the
kernel here. It takes the launch's arguments (the level table with its
head, the epilogue, the components and the ICT) and runs what the kernel
runs, item by item (csrc/lifting97.cuh's strip pass, modelled in
test_torch_j2k97_fwd_stage): each level, coarsest first, loads the rows of
each strip and segment with a halo of 6 through the symmetric fold, a
lane's low and high columns from the packed row's low and high halves —
the LL from the scratch area the level above wrote (the coarsest level's
from the input), the high bands from the input —, scales each row by K
and 1/K and undoes its lifting along x at once, lane by lane through the
card's shuffles, the reference's six steps (two of coefficient 0.0), then
scales it by K or 1/K along y and undoes the column lifting in a rolling
window over the segment's pairs of rows, each float32 operation rounded
once; each row out of it is stored interleaved: to scratch, or at the
finest level through the epilogue (the inverse ICT of a group of
components 0-2, round half to even saturating as the reference's cast,
unshift, clip and 16-bit cast). Scratch and output start as NaN; the
model checks that every output sample is written once and that no level
writes scratch it reads. Strips of 4 lanes and segments of 4 rows (on the
card up to 32 lanes and 64 rows, chosen per level).

Tolerance 0 against the JAX package's op-by-op ``inv97_multilevel``
(go_dicom_codec_tpu/ops/dwt97.py:130), ``ict_inverse``, ``jnp.round``,
``astype(int32)``, the unshift and the clip (pipeline.py:471-485), bit for
bit, over the covering of tests/test_torch_dwt97.py, with the ICT on and
off, all three epilogues, 8, 12 and 16 bits, signed and unsigned. Decodes
of .91, .93 and .203 streams through the model equal the plain lane bit
for bit, and the reference's jitted stage within ±1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import go_dicom_codec_torch as gdc
from go_dicom_codec_tpu import pipeline as ref
from go_dicom_codec_tpu.codecs import jpeg2000 as ref_j2k
from go_dicom_codec_tpu.ops import dwt97 as ref_dwt97
from go_dicom_codec_tpu.ops import mct as ref_mct
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline as port
from go_dicom_codec_torch.codecs import jpeg2000 as port_j2k
from go_dicom_codec_torch.ops import dwt97
from go_dicom_codec_torch.ops import j2k97_inv_stage as stage
from go_dicom_codec_torch.ops.j2k97_fwd_stage import fwd97_stage_plain
from test_torch_dwt97 import LARGE, SMALL, _cases
from test_torch_j2k97_fwd_stage import (F32, H100_WARPS, ICT_INV,
                                        INT32_MAX, INT32_MIN, INV_K,
                                        INV_STEPS, K, SPECIAL, Scratch97,
                                        Strips, bits_equal, card_warps,
                                        geometry, lift_x)
from test_torch_j2k_fwd_stage import (fold, groups, no_other_kernels,
                                      phases, to_packed)

CPU = torch.device("cpu")


def ict_inv(y, cb, cr):
    """Pixels::put_ict: r = y + c0·cr, g = (y + c1·cb) + c2·cr,
    b = y + c3·cb, as ops/mct.ict_inverse."""
    c0, c1, c2, c3 = ICT_INV
    return [y + c0 * cr, y + c1 * cb + c2 * cr, y + c3 * cb]


def inv97_launch_model(x, schedule, comps, ict):
    """One launch of csrc/j2k97_inv_stage.cu on float32 coefficients x
    [P, H, W]: the finest level's reconstruction after the inverse ICT,
    float32, each sample written once."""
    words, rows = schedule
    p, h, w = x.shape
    frames = p // comps
    rec = np.full((p, h, w), np.nan, F32)
    count = np.zeros((p, h, w), np.int64)
    scr = Scratch97(p, words)
    with np.errstate(all="ignore"):
        if not rows:               # no level: the epilogue of the input
            f = x.reshape(frames, comps, h, w).copy()
            if ict:
                f[:, :3] = np.stack(ict_inv(f[:, 0], f[:, 1], f[:, 2]), 1)
            rec[...] = f.reshape(p, h, w)
            count += 1
        for r0, r1 in phases(rows):
            g3 = ict and r1 == len(rows)
            for plane0, nb in groups(frames, comps, g3):
                for ri in range(r0, r1):
                    inv97_level_model(rows[ri], ri, plane0, nb, g3, x, rec,
                                      count, scr)
    scr.check()
    assert (count == 1).all(), "an output sample is not written once"
    return rec


def inv97_level_model(row, ri, plane0, nb, g3, x, rec, count, scr):
    """csrc/j2k97_inv_stage.cu::inv_level for one plane group: every item
    of level ``ri`` (Packed::load and finish, run_item, Recon)."""
    _, w, h, even_x, even_y, in_off, out_off, lanes, seg = row
    st = Strips(row, _kernels.INV97_HALO)
    planes = (plane0 + np.arange(nb))[:, None, None, None]
    px = to_packed(st.fx, st.snx, st.lo_x)

    def load(y, kind):
        py = np.broadcast_to(to_packed(fold(y, h), st.sny,
                                       st.lo_y)[:, None, None], px.shape)
        v = x[planes, py[None], px[None]]
        ll = (py < st.sny) & (px < st.snx)
        if in_off >= 0 and ll.any():
            v[:, ll] = scr.read(ri, scr.at(planes[:, :, 0, 0], in_off,
                                           py[ll][None], px[ll][None],
                                           st.snx))
        if w > 1:
            v[..., 0::2] *= K
            v[..., 1::2] *= INV_K
            v = lift_x(v, INV_STEPS)
        if kind != "only":
            v = v * (K if kind == "low" else INV_K)
        return v

    def emit(y, v, kind):
        keep = st.out(y)
        qy = np.broadcast_to(y[:, None, None], keep.shape)[keep]
        qx = st.x[keep]
        out = v[:, keep]
        if out_off >= 0:
            for k in range(nb):
                scr.write(ri, scr.at(plane0 + k, out_off, qy, qx, w), out[k])
            return
        if g3 and nb == 3:
            out = np.stack(ict_inv(*out))
        for k in range(nb):
            rec[plane0 + k, qy, qx] = out[k]
            count[plane0 + k, qy, qx] += 1

    st.run(load, emit, INV_STEPS)


def epilogue_model(rec, epilogue, bits, signed):
    """Pixels::put after the ICT: __float2int_rn (round half to even,
    NaN → 0, saturating), + 2^(bits-1) unless signed in wrapping int32,
    and for "narrow" the clip and the 16-bit cast."""
    if epilogue == "coeffs":
        return rec
    with np.errstate(invalid="ignore"):
        r = np.rint(rec.astype(np.float64))
        v = np.where(np.isnan(r), 0, np.clip(r, INT32_MIN, INT32_MAX))
    dc = 0 if signed else 1 << (bits - 1)
    v = (v.astype(np.int64) + dc + (1 << 31)) % (1 << 32) - (1 << 31)
    if epilogue == "pixels":
        return v.astype(np.int32)
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
              else (0, (1 << bits) - 1))
    return np.clip(v, lo, hi).astype(np.int16 if signed else np.uint16)


def _inv97_model(launches):
    """A stand-in for _kernels.j2k97_inv_stage; each launch's epilogue is
    appended to ``launches``."""
    def launch(src, out, schedule, comps, epilogue, mct=False, bits=16,
               signed=False):
        assert src.dtype == torch.float32 and src.dim() == 3
        assert src.shape[0] % comps == 0
        assert out.shape == src.shape and out.data_ptr() != src.data_ptr()
        assert out.dtype == {"coeffs": torch.float32, "pixels": torch.int32,
                             "narrow": torch.int16 if signed
                             else torch.uint16}[epilogue]
        ict = mct and epilogue != "coeffs" and comps >= 3
        _kernels._stage97_plane("j2k97_inv_stage", *src.shape[1:], schedule,
                                _kernels.INV97_HALO)
        launches.append(epilogue)
        rec = inv97_launch_model(src.numpy(), schedule, comps, ict)
        out.copy_(torch.as_tensor(epilogue_model(rec, epilogue, bits,
                                                 signed)))
    return launch


@pytest.fixture
def kernel_lane(monkeypatch, geometry):
    """The 9/7 decode stage's kernel lane on CPU tensors, through the
    model, for the stage, the pipelines' stage, the scalar decoder's
    branches and ``inv97_multilevel``; no other kernel may launch. Yields
    the launches."""
    launches = []
    no_other_kernels(monkeypatch, ("j2k97_inv_stage",))
    monkeypatch.setattr(_kernels, "j2k97_inv_stage", _inv97_model(launches))
    for mod in (port, port_j2k):
        monkeypatch.setattr(mod, "inv97_stage", stage._inv97_stage_kernel)
    monkeypatch.setattr(dwt97, "_on_cuda", lambda x: True)
    return launches


def plain_lane(monkeypatch):
    """Sends the pipelines and the scalar decoder back to the plain
    version."""
    for mod in (port, port_j2k):
        monkeypatch.setattr(mod, "inv97_stage", stage.inv97_stage_plain)


def _ref_epilogue(rec, bits, signed, mct, epilogue):
    """The reference's decode stage after its 9/7 (pipeline.py:471-485),
    op by op."""
    if epilogue == "coeffs":
        return np.asarray(rec)
    if mct and rec.shape[1] >= 3:
        rgb = jnp.stack(ref_mct.ict_inverse(rec[:, 0], rec[:, 1],
                                            rec[:, 2]), axis=1)
        rec = jnp.concatenate([rgb, rec[:, 3:]], axis=1)
    px = ref_mct.inv_dc_level_shift(jnp.round(rec).astype(jnp.int32), bits,
                                    signed)
    if epilogue == "narrow":
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
        px = jnp.clip(px, lo, hi).astype(jnp.int16 if signed
                                         else jnp.uint16)
    return np.asarray(px)


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == np.float32:
        bits_equal(got, want)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _coefficients(rng, shape, levels, x0, y0):
    """Float32 coefficients [1, 3, h, w] of 12-bit frames with the ICT
    (the forward plain version), one of them pushed out of range so that
    the clip and the round's saturation act."""
    px = torch.as_tensor(rng.integers(0, 4096, (1, 3) + shape)
                         .astype(np.uint16))
    c = fwd97_stage_plain(px, 2048, levels, x0, y0, mct=True).numpy()
    c[0, 0, 0, 0] += F32(3e4)
    c[0, 2, -1, -1] = F32(-3e9)
    return c


@pytest.mark.parametrize("shape,x0,y0,levels", _cases(SMALL + LARGE))
def test_stage_bit_exact_over_the_covering(shape, x0, y0, levels,
                                           kernel_lane, rng):
    """The model (the kernel lane) and the plain version against the JAX
    package's op-by-op 9/7 and epilogue: "coeffs", and "pixels" and
    "narrow" with the ICT and without; 8, 12 and 16 bits, signed and
    unsigned, in turns over the covering."""
    k = shape[0] + 3 * shape[1] + x0 + 2 * y0
    bits, signed = (8, 12, 16)[k % 3], bool(k // 3 % 2)
    c = _coefficients(rng, shape, levels, x0, y0)
    rec = ref_dwt97.inv97_multilevel(jnp.asarray(c), levels, x0, y0)
    t = torch.as_tensor(c)
    for epilogue, mct_on in (("coeffs", False), ("pixels", True),
                             ("narrow", True), ("pixels", False),
                             ("narrow", False)):
        want = _ref_epilogue(rec, bits, signed, mct_on, epilogue)
        args = (levels, x0, y0, bits, signed, mct_on, epilogue)
        _eq(stage.inv97_stage_plain(t, *args).numpy(), want)
        _eq(stage._inv97_stage_kernel(t, *args).numpy(), want)
    assert kernel_lane == ["coeffs", "pixels", "narrow", "pixels", "narrow"]


@pytest.mark.parametrize("shape,x0,y0,levels", _cases(LARGE))
@pytest.mark.parametrize("geometry", ["card"], indirect=True)
def test_stage_bit_exact_at_the_cards_tile(shape, x0, y0, levels,
                                           kernel_lane, rng):
    """61×37 at every level at the card's strip geometry, in all three
    epilogues, against the plain version, which the covering holds to the
    JAX package."""
    t = torch.as_tensor(_coefficients(rng, shape, levels, x0, y0))
    for epilogue in ("coeffs", "pixels", "narrow"):
        args = (levels, x0, y0, 12, False, True, epilogue)
        _eq(stage._inv97_stage_kernel(t, *args).numpy(),
            stage.inv97_stage_plain(t, *args).numpy())
    assert kernel_lane == ["coeffs", "pixels", "narrow"]


@pytest.mark.parametrize("shape", [(1, 2, 61), (1, 61, 2), (2, 1, 37),
                                   (2, 37, 1), (3, 5, 3)])
@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 1)])
def test_thin_windows_and_four_components(shape, x0, y0, kernel_lane, rng):
    """Long, thin windows (a side of one left as it is, the fold at n = 1
    and 2) and frames of four components, the ICT on components 0-2
    only, against the plain version."""
    t = torch.as_tensor(rng.uniform(-3000, 3000, (2, 4) + shape[1:])
                        .astype(F32))
    for epilogue in ("coeffs", "narrow"):
        args = (4, x0, y0, 12, False, True, epilogue)
        _eq(stage._inv97_stage_kernel(t, *args).numpy(),
            stage.inv97_stage_plain(t, *args).numpy())
    assert kernel_lane == ["coeffs", "narrow"]


SATURATE = (3e9, -3e9, np.nan, np.inf, -np.inf, 2147483520.0, 2.0 ** 31,
            -2.0 ** 31, 2.5, -2.5, 0.5, -0.0, 0.0)


@pytest.mark.parametrize("mct_on", [False, True])
def test_saturation_and_signed_zero(mct_on, kernel_lane):
    """NaN, ±inf, values past int32, ties and ±0 in the coefficients: the
    zero-coefficient steps turn an inf into a NaN and -0.0 into +0.0 as
    the reference's do, the round saturates (NaN → 0), the clip holds;
    the model, the plain version and the JAX package agree bit for bit."""
    f = np.full((1, 3 if mct_on else 1, 2, 7), 1234.25, F32)
    f.reshape(f.shape[1], -1)[0, :len(SATURATE)] = SATURATE
    if mct_on:
        f.reshape(3, -1)[1:, :len(SATURATE)] = 0.0
        f.reshape(3, -1)[1:, -1] = (np.inf, -np.inf)
    t = torch.as_tensor(f)
    for levels in (0, 1, 2):
        rec = ref_dwt97.inv97_multilevel(jnp.asarray(f), levels)
        for signed in (True, False):
            for epilogue in ("coeffs", "pixels", "narrow"):
                want = _ref_epilogue(rec, 12, signed, mct_on, epilogue)
                args = (levels, 0, 0, 12, signed, mct_on, epilogue)
                _eq(stage._inv97_stage_kernel(t, *args).numpy(), want)
                _eq(stage.inv97_stage_plain(t, *args).numpy(), want)
    assert len(kernel_lane) == 18


@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 1), (1, 0), (0, 1)])
def test_strip_and_segment_seams(x0, y0, kernel_lane, rng):
    """Coefficients of 19×21 frames at the tests' geometry (strips of 4
    output columns, segments of 4 rows: many seams a level), each frame
    with one of ±0, ±inf, NaN, ±3e9 on a strip seam, a segment seam and
    the last sample, at 3 levels, "coeffs" and "pixels": the model, the
    plain version and the JAX package agree bit for bit."""
    c = rng.uniform(-3000, 3000, (len(SPECIAL), 1, 19, 21)).astype(F32)
    for i, v in enumerate(SPECIAL):
        c[i, 0, 4, 4] = c[i, 0, 9, 12] = c[i, 0, -1, -1] = v
    rec = ref_dwt97.inv97_multilevel(jnp.asarray(c), 3, x0, y0)
    t = torch.as_tensor(c)
    for epilogue in ("coeffs", "pixels"):
        want = _ref_epilogue(rec, 12, False, False, epilogue)
        args = (3, x0, y0, 12, False, False, epilogue)
        _eq(stage._inv97_stage_kernel(t, *args).numpy(), want)
        _eq(stage.inv97_stage_plain(t, *args).numpy(), want)
    assert kernel_lane == ["coeffs", "pixels"]


@pytest.mark.parametrize("narrow", [False, True])
def test_decode_stage_within_one_of_the_jitted_stage(narrow, kernel_lane,
                                                     rng):
    """The pipelines' stage through the model, against the reference's
    jitted ``_j2k_decode_device_stage_97`` (XLA fuses its float ops:
    within ±1) and bit for bit the plain version."""
    c = _coefficients(rng, (61, 37), 5, 1, 0)
    c[0, 2, -1, -1] = 0.0
    got = port._j2k_decode_device_stage_97(torch.as_tensor(c), 5, 1, 0, 12,
                                           False, True, narrow)
    want = np.asarray(ref._j2k_decode_device_stage_97(
        jnp.asarray(c), 5, 1, 0, 12, False, True, narrow))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert np.abs(got.numpy().astype(np.int64) - want).max() <= 1
    _eq(got.numpy(), stage.inv97_stage_plain(
        torch.as_tensor(c), 5, 1, 0, 12, False, True,
        "narrow" if narrow else "pixels").numpy())
    assert kernel_lane == ["narrow" if narrow else "pixels"]


def test_multilevel_kernel_lane(kernel_lane, rng):
    """``inv97_multilevel``'s kernel lane: one "coeffs" launch, input left
    as it was, bit for bit the plain lane."""
    x = torch.as_tensor(rng.uniform(-2048, 2048, (2, 3, 13, 21)).astype(F32))
    keep = x.clone()
    got = dwt97.inv97_multilevel(x, 3, 0, 1)
    assert torch.equal(x, keep)
    bits_equal(got.numpy(), dwt97.inv97_multilevel_plain(x, 3, 0, 1).numpy())
    assert kernel_lane == ["coeffs"]


# ---- decodes through the model ---------------------------------------------

def _walk(rng, shape, bits):
    return (np.cumsum(rng.integers(-9, 10, shape), axis=2)
            % (1 << bits)).astype(np.int32)


def _lossy_streams(frames, bits):
    enc = ref_j2k.J2KEncoder(ref_j2k.J2KEncodeParams(
        num_levels=3, lossless=False, quality=90))
    c = frames.shape[3] if frames.ndim == 4 else 1
    h, w = frames.shape[1:3]
    return [enc.encode(f, w, h, c, bits) for f in frames]


@pytest.mark.parametrize("rgb", [False, True])
def test_pipelined_91_decode_through_the_model(rgb, kernel_lane,
                                               monkeypatch, rng):
    """.91 streams through ``decode_frames_pipelined``: one stage launch a
    chunk, bit for bit the plain lane, within ±1 of the reference's
    pipeline (its jitted stage)."""
    shape, bits = ((3, 24, 40, 3), 8) if rgb else ((3, 40, 48), 12)
    streams = _lossy_streams(_walk(rng, shape, bits), bits)
    got = port.decode_frames_pipelined(streams, chunk=2, engine="device",
                                       device=CPU)
    assert kernel_lane == ["narrow"] * 2
    plain_lane(monkeypatch)
    plain = port.decode_frames_pipelined(streams, chunk=2, engine="device",
                                         device=CPU)
    want = ref.decode_frames_pipelined(streams, chunk=2, device="device")
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        assert np.abs(g.astype(np.int64) - w).max() <= 1


def _registry_decode(uid, streams, info):
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    for s in streams:
        enc.add_frame(s)
    dec = gdc.MemoryPixelData(info=info)
    gdc.make_registry(CPU, engine="device").get_codec(uid).decode(enc, dec)
    return [np.frombuffer(dec.get_frame(i), np.uint8)
            for i in range(len(streams))]


def _registry_streams(uid, frames, info, params=None):
    """Codestreams of the reference's registry codec of ``uid``."""
    from go_dicom_codec_tpu import frames as ref_frames
    from go_dicom_codec_tpu import get_global_registry, params as ref_params

    ref_info = ref_frames.FrameInfo(**vars(info))
    src = ref_frames.MemoryPixelData(info=ref_info)
    for f in frames:
        src.add_frame(f.tobytes())
    enc = ref_frames.MemoryPixelData(info=ref_info, encapsulated=True)
    get_global_registry().get_codec(uid).encode(
        src, enc, params and ref_params.Parameters(**params))
    dec = ref_frames.MemoryPixelData(info=ref_info)
    get_global_registry().get_codec(uid).decode(enc, dec)
    return ([enc.get_frame(i) for i in range(len(frames))],
            [np.frombuffer(dec.get_frame(i), np.uint8)
             for i in range(len(frames))])


@pytest.mark.parametrize("uid", [gdc.uids.JPEG_2000_LOSSY,
                                 gdc.uids.JPEG_2000_MC_LOSSY,
                                 gdc.uids.HTJ2K])
def test_registry_decode_through_the_model(uid, kernel_lane, monkeypatch,
                                           rng):
    """Three RGB 8-bit frames of .91, .93 (a Part-2 matrix: the stage's
    "coeffs" launch, then the matrix in torch) and .203 through
    ``make_registry(cpu, "device")``: bit for bit the plain lane, within
    ±1 of the reference's registry decode."""
    frames = _walk(rng, (3, 24, 40, 3), 8).astype(np.uint8)
    info = gdc.FrameInfo(width=40, height=24, bits_allocated=8,
                         samples_per_pixel=3,
                         photometric_interpretation="RGB")
    params = None
    if uid == gdc.uids.JPEG_2000_MC_LOSSY:
        m = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]
        params = dict(mct_matrix=m, mct_inverse=np.linalg.inv(m).tolist())
    streams, want = _registry_streams(uid, frames, info, params)
    got = _registry_decode(uid, streams, info)
    assert kernel_lane and set(kernel_lane) <= {"narrow", "coeffs"}
    assert (set(kernel_lane) == {"coeffs"}) == (params is not None)
    plain_lane(monkeypatch)
    for g, p, w in zip(got, _registry_decode(uid, streams, info), want):
        np.testing.assert_array_equal(g, p)
        assert np.abs(g.astype(np.int64) - w).max() <= 1


def _coc_lossy_stream(a, b, levels_b):
    """One 2-component 9/7 codestream of two gray 16-bit frames, component
    1 at its own level count by COC and QCC (tests/test_sharding.py's
    remux recipe on lossy streams)."""
    from test_j2k_markers import _split_packets

    from go_dicom_codec_tpu.codestream import j2k

    def encode(img, levels):
        h, w = img.shape
        return j2k.parse_codestream(ref_j2k.J2KEncoder(
            ref_j2k.J2KEncodeParams(num_levels=levels, lossless=False,
                                    quality=90)).encode(
            img.astype("<u2").tobytes(), w, h, 1, 16, False))
    cs_a, cs_b = encode(a, 3), encode(b, levels_b)
    tagged = sorted(
        [(r, c, blob) for c, cs in enumerate((cs_a, cs_b))
         for (r, blob) in _split_packets(cs.tiles[0].data,
                                         cs.siz.tile_rect(0, 0), cs.cod,
                                         cs.qcd)], key=lambda t: t[:2])
    h, w = a.shape
    siz = j2k.SizInfo(xsiz=w, ysiz=h, xtsiz=w, ytsiz=h,
                      components=[cs_a.siz.components[0]] * 2)
    out = bytearray(b"\xff\x4f") + j2k.write_siz(siz)
    out += j2k.write_cod(cs_a.cod)
    out += j2k.write_coc(j2k.CocInfo(
        comp=1, num_levels=cs_b.cod.num_levels, cb_width=cs_b.cod.cb_width,
        cb_height=cs_b.cod.cb_height, cb_style=cs_b.cod.cb_style,
        transform=cs_b.cod.transform), 2)
    out += j2k.write_qcd(cs_a.qcd) + j2k.write_qcc(1, cs_b.qcd, 2)
    out += j2k.write_tile_part(0, b"".join(blob for (_, _, blob) in tagged))
    return bytes(out + j2k.EOC.to_bytes(2, "big"))


@pytest.mark.parametrize("case", ["homogeneous", "coc_levels"])
def test_scalar_decoder_branches_through_the_model(case, kernel_lane,
                                                   monkeypatch, rng):
    """The scalar decoder's device branches with the native 9/7 off: a
    homogeneous RGB tile (one "pixels" launch, the ICT in it) and a COC
    stream whose components differ in levels (one launch a component);
    bit for bit the plain lane, within ±1 of the reference's decoder."""
    from go_dicom_codec_torch import native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    if case == "homogeneous":
        stream = _lossy_streams(_walk(rng, (1, 24, 40, 3), 8), 8)[0]
        launches = ["pixels"]
    else:
        a, b = (rng.integers(0, 1 << 16, (2, 40, 48)) // 7).astype(np.uint16)
        stream = _coc_lossy_stream(a, b, 1)
        launches = ["pixels"] * 2
    got = port_j2k.J2KDecoder(device=CPU).decode(stream)[0]
    assert kernel_lane == launches
    plain_lane(monkeypatch)
    np.testing.assert_array_equal(
        got, port_j2k.J2KDecoder(device=CPU).decode(stream)[0])
    want = ref_j2k.J2KDecoder().decode(stream)[0]
    assert np.abs(got.astype(np.int64) - want).max() <= 1


def test_refused_launch_propagates_through_the_decode_adapter(monkeypatch,
                                                              rng):
    """A refused 9/7 stage launch leaves a multi-frame .91 decode as
    KernelLaunchError; the adapters' scalar fallback catches only
    ValueError."""
    frames = rng.integers(0, 4096, (3, 16, 24)).astype(np.uint16)
    info = gdc.FrameInfo(width=24, height=16, bits_allocated=16,
                         bits_stored=12)
    streams, _ = _registry_streams(gdc.uids.JPEG_2000_LOSSY, frames, info)

    def refused(*args, **kwargs):
        raise _kernels.KernelLaunchError("j2k97_inv_stage: refused")
    monkeypatch.setattr(_kernels, "j2k97_inv_stage", refused)
    card_warps(monkeypatch)
    monkeypatch.setattr(port, "inv97_stage", stage._inv97_stage_kernel)
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        _registry_decode(gdc.uids.JPEG_2000_LOSSY, streams, info)


def test_stage_lanes_by_device():
    x = torch.zeros((1, 3, 8, 8), dtype=torch.float32)
    got = stage.inv97_stage(x, 2, bits=8, mct=True)   # CPU: plain, pixels
    assert got.dtype == torch.int32 and bool((got == 128).all())
    assert stage.inv97_stage(x, 2, bits=8, epilogue="narrow").dtype \
        == torch.uint16
    assert stage.inv97_stage(x, 2, epilogue="coeffs").dtype == torch.float32
    with pytest.raises(ValueError, match="no lane"):
        stage.inv97_stage(x.to("meta"), 1)
    with pytest.raises(ValueError, match="no lane"):
        dwt97.inv97_multilevel(x.to("meta"), 1)
    with pytest.raises(ValueError, match="epilogue"):
        stage.inv97_stage(x, 1, epilogue="stats")
    x3 = torch.zeros((3, 8, 8), dtype=torch.float32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k97_inv_stage(x3, x3.clone(),
                                 dwt97.inv97_schedule(
                                     8, 8, 2, warps=H100_WARPS[False]), 3,
                                 "coeffs")
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k97_inv_warps(x3)
