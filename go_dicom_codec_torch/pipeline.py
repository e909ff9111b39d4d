"""JPEG 2000 multi-frame encode and decode pipelines and their device
stages.

Port of the J2K half of ``go_dicom_codec_tpu/pipeline.py``:

- the device stages: the encode transform (DC shift → RCT for RGB →
  multilevel 5/3 → per-codeblock stats), the pipelines' encode stage with
  its int16 narrow readback and max-abs flag, the int32 redo on overflow
  (``fetch_coeffs``) and the reversible and irreversible decode stages.
  Every stage takes tensors on the device it should run on; the 5/3 runs
  through the hand-written kernels on CUDA tensors;
- the measured transfer policy that picks the transform engine;
- the double-buffered ``encode_frames_pipelined`` and
  ``decode_frames_pipelined``: the device transforms chunk k+1 while the
  host entropy-codes chunk k (``_Lane`` holds the CUDA side of that).

The reference's ``device="auto"|"device"|"host"`` argument chooses an
engine, not a device: here it is ``engine=``, and ``device`` is the
``torch.device`` the device engine runs on.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, List, Optional

import numpy as np
import torch

from .ops.blockstats import codeblock_max_abs, max_bitplane
from .ops.dwt53 import fwd53_multilevel_, inv53_multilevel_
from .ops.dwt97 import inv97_multilevel
from .ops.mct import (dc_level_shift, ict_inverse, ict_inverse_np,
                      inv_dc_level_shift, rct_forward, rct_forward_np,
                      rct_inverse, rct_inverse_np)

INT16_MAX = 32767
ENGINES = ("auto", "device", "host")


def _shifted(frames: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """DC-shifted int32 samples in a tensor the transform may overwrite."""
    s = dc_level_shift(frames.to(torch.int32), bits, signed)
    if s.data_ptr() == frames.data_ptr():
        return s.clone(memory_format=torch.contiguous_format)
    return s.contiguous()


def _rct_shifted(frames: torch.Tensor, bits: int) -> torch.Tensor:
    """[B, 3, H, W] → DC shift → RCT, stacked as [B, 3, H, W] int32."""
    s = dc_level_shift(frames.to(torch.int32), bits, signed=False)
    return torch.stack(rct_forward(s[:, 0], s[:, 1], s[:, 2]), dim=1)


def _stats(coeffs: torch.Tensor, cb: int):
    m = codeblock_max_abs(coeffs, cb, cb)
    return coeffs, m, max_bitplane(m)


def j2k_lossless_encode_transform(frames: torch.Tensor, levels: int = 5,
                                  bits: int = 16, signed: bool = False,
                                  cb: int = 64):
    """Grayscale J2K lossless device stage: [B, H, W] → coeffs + stats.

    Returns (coeffs [B,H,W] int32 packed-Mallat, cb_max [B,nby,nbx],
    cb_bitplanes [B,nby,nbx]).
    """
    return _stats(fwd53_multilevel_(_shifted(frames, bits, signed), levels),
                  cb)


def j2k_rgb_lossless_encode_transform(frames: torch.Tensor, levels: int = 5,
                                      bits: int = 8, cb: int = 64):
    """RGB J2K lossless device stage: [B, 3, H, W] → coeffs + stats.

    DC shift → RCT → per-component multilevel 5/3.
    """
    return _stats(fwd53_multilevel_(_rct_shifted(frames, bits), levels), cb)


def _narrowed(c: torch.Tensor, narrow: bool):
    if not narrow:
        return c
    # int16 readback halves the transfer. Typical 5/3 coefficients of
    # ≤12-bit input fit int16, but the lifting gain compounds per level, so
    # the max |coeff| rides along and the host redoes the stage in int32
    # on overflow (fetch_coeffs).
    return c.to(torch.int16), c.abs().amax()


def _pipeline_device_stage(x: torch.Tensor, bits: int, signed: bool,
                           lv: int, narrow: bool = False):
    """[B, H, W] → DC shift → 5/3: int32 coefficients, or with ``narrow``
    (int16 coefficients, max |coeff|)."""
    return _narrowed(fwd53_multilevel_(_shifted(x, bits, signed), lv),
                     narrow)


def _pipeline_device_stage_rgb(x: torch.Tensor, bits: int, lv: int,
                               narrow: bool = False):
    """[B, 3, H, W] → DC shift → RCT → per-component 5/3."""
    return _narrowed(fwd53_multilevel_(_rct_shifted(x, bits), lv), narrow)


def fetch_coeffs(result, x: torch.Tensor, bits: int, signed: bool, lv: int,
                 rgb: bool = False) -> np.ndarray:
    """Host int32 coefficients of a device stage's ``result``.

    A narrow result (int16 coefficients, max |coeff|) whose max exceeds
    int16 is recomputed in int32 from the stage's input ``x``.
    """
    if not isinstance(result, tuple):
        return result.cpu().numpy()
    c16, maxabs = result
    if int(maxabs) <= INT16_MAX:
        return c16.cpu().numpy().astype(np.int32)
    if rgb:
        wide = _pipeline_device_stage_rgb(x, bits, lv)
    else:
        wide = _pipeline_device_stage(x, bits, signed, lv)
    return wide.cpu().numpy()


def _j2k_decode_device_stage(packed: torch.Tensor, levels: int, x0: int,
                             y0: int, bits: int, signed: bool, mct: bool,
                             narrow: bool = False) -> torch.Tensor:
    """[B, C, th, tw] packed coefficients (int32, or int16 when the host
    verified they fit) → samples: inverse 5/3, inverse RCT, DC unshift.

    With ``narrow`` the samples are clipped to the declared range (the
    identity for conformant streams; it stops hostile coefficients from
    wrapping through the cast) and cast to int16/uint16. The clip runs in
    int32 because torch has no uint16 arithmetic.
    """
    rec = packed.to(torch.int32, copy=True,
                     memory_format=torch.contiguous_format)
    rec = inv53_multilevel_(rec, levels, x0=x0, y0=y0)
    if mct and rec.shape[1] >= 3:
        rgb = torch.stack(rct_inverse(rec[:, 0], rec[:, 1], rec[:, 2]),
                          dim=1)
        rec = torch.cat([rgb, rec[:, 3:]], dim=1)
    px = inv_dc_level_shift(rec, bits, signed)
    return _narrow_pixels(px, bits, signed) if narrow else px


def _narrow_pixels(px: torch.Tensor, bits: int,
                   signed: bool) -> torch.Tensor:
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
              else (0, (1 << bits) - 1))
    return px.clamp(lo, hi).to(torch.int16 if signed else torch.uint16)


def _j2k_decode_device_stage_97(fbatch: torch.Tensor, levels: int, x0: int,
                                y0: int, bits: int, signed: bool, mct: bool,
                                narrow: bool = False) -> torch.Tensor:
    """[B, C, th, tw] dequantized float32 coefficients → samples: float
    9/7 inverse, inverse ICT, round, DC unshift.

    With ``narrow`` the samples are clipped to the declared range before
    the 16-bit cast: lossy reconstructions overshoot it by a few codes,
    and an unclipped -1 would wrap to 65535.
    """
    rec = inv97_multilevel(fbatch, levels, x0=x0, y0=y0)
    if mct and rec.shape[1] >= 3:
        rgb = torch.stack(ict_inverse(rec[:, 0], rec[:, 1], rec[:, 2]),
                          dim=1)
        rec = torch.cat([rgb, rec[:, 3:]], dim=1)
    px = inv_dc_level_shift(torch.round(rec).to(torch.int32), bits, signed)
    return _narrow_pixels(px, bits, signed) if narrow else px


# ---- transfer policy --------------------------------------------------------

# Measured once per device and process, as in the reference: at first use
# the pipeline times a real host→device→host round trip and the native
# host transform on the same shape, and prefers the device engine only
# when the transfer leaves room for a win. Tests inject fake probes.
_POLICY: dict = {}


def _measure_roundtrip_ms_per_frame(device: torch.device) -> float:
    """Host→device→host round trip through pinned buffers, as the
    pipelines transfer: ms per 512² int32 frame."""
    x = torch.zeros((2, 512, 512), dtype=torch.int32, pin_memory=True)
    back = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    for _ in range(2):                  # warm, then timed
        t0 = time.perf_counter()
        back.copy_(x.to(device, non_blocking=True), non_blocking=True)
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1000 / 2


def _measure_host_transform_ms_per_frame() -> float:
    """Native host 5/3 transform, ms per 512² frame (the work the device
    engine replaces); a typical native cost when the library is missing."""
    from .native import dwt53_fwd_native, get_lib

    if get_lib() is None:
        return 3.0
    frame = np.zeros((512, 512), dtype=np.int32)
    dwt53_fwd_native(frame, 5, 0, 0)   # warm
    t0 = time.perf_counter()
    dwt53_fwd_native(frame, 5, 0, 0)
    return (time.perf_counter() - t0) * 1000


def transfer_policy(device: torch.device, force_remeasure: bool = False,
                    _probe_roundtrip: Optional[Callable[[], float]] = None,
                    _probe_host: Optional[Callable[[], float]] = None
                    ) -> dict:
    """The cached measured policy of ``device``: {"prefer_device",
    "reason", "roundtrip_ms", "host_ms"}. _probe_* let tests fake both
    regimes."""
    key = str(device)
    if key in _POLICY and not force_remeasure:
        return _POLICY[key]
    if device.type == "cpu":
        policy = {"prefer_device": False, "reason": "cpu device",
                  "roundtrip_ms": None, "host_ms": None}
    else:
        rt = (_probe_roundtrip() if _probe_roundtrip
              else _measure_roundtrip_ms_per_frame(device))
        host = (_probe_host or _measure_host_transform_ms_per_frame)()
        # the device engine must amortize the round trip against the host
        # transform it replaces; the 0.75 margin keeps ties on the host
        policy = {
            "prefer_device": rt < host * 0.75,
            "reason": (f"measured roundtrip {rt:.2f} ms/frame vs host "
                       f"transform {host:.2f} ms/frame"),
            "roundtrip_ms": round(rt, 3),
            "host_ms": round(host, 3),
        }
    _POLICY[key] = policy
    from .utils.profiling import log_event
    log_event("pipeline.transfer_policy", policy)
    return policy


def _tunnel_backend(device: torch.device) -> bool:
    """True when transfers to ``device`` are too slow for the batched
    device engine (measured, see transfer_policy; the name is the
    reference's). The CPU transfers nothing."""
    if device.type == "cpu":
        return False
    return not transfer_policy(device)["prefer_device"]


def prefer_batched_device(device: torch.device) -> bool:
    """True when a batched device engine beats the per-frame host path
    for multi-frame pipelines on ``device``, per the measured policy."""
    return device.type != "cpu" and transfer_policy(device)["prefer_device"]


def check_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return engine


def _use_host(engine: str, device: torch.device) -> bool:
    if check_engine(engine) == "auto":
        from .native import get_lib
        return _tunnel_backend(device) and get_lib() is not None
    return engine == "host"


def _host_dwt(native_fn, torch_fn, arr: np.ndarray, levels: int, x0: int = 0,
              y0: int = 0, as_int32: bool = True) -> np.ndarray:
    """Host-engine multilevel DWT of one plane: the native mirror when
    built, else the port's plain torch op on the CPU (bit-exact for the
    5/3, which the native lane mirrors). Keeps engine="host" working
    without the native library."""
    r = native_fn(arr, levels, x0, y0)
    if r is not None:
        return r
    out = torch_fn(torch.tensor(arr)[None], levels, x0=x0, y0=y0)[0].numpy()
    return out.astype(np.int32) if as_int32 and out.dtype != np.float32 \
        else out


# ---- double buffering -------------------------------------------------------

# One side stream per device for every pipeline call: the caching
# allocator reuses a freed block only on the stream that allocated it,
# so a new stream per call would cudaMalloc the chunk buffers again each
# call.
_STREAMS: dict = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    key = str(device)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


class _Chunk:
    """One chunk in flight: its event, its host results, and its device
    inputs (kept for the int32 redo)."""

    def __init__(self, lane: "_Lane", slot: int, done, host, inputs):
        self.lane, self.slot, self.done = lane, slot, done
        self.host, self.inputs = host, inputs

    def result(self) -> List[np.ndarray]:
        """The chunk's results as numpy copies, once its copies are done
        (a copy, since the pinned buffers serve a later chunk)."""
        if self.done is not None:
            self.done.synchronize()
        self.lane._unread[self.slot] = False
        return [np.array(h.numpy()) for h in self.host]


class _Lane:
    """Double-buffered transfers of one pipeline call on ``device``.

    On CUDA each chunk goes up from a pinned staging buffer and its
    results come back into pinned buffers, all with non_blocking copies
    on the device's side stream, which also runs the chunk's device
    stage. One
    event, recorded after the chunk's last copy, marks it done: the host
    reads a chunk's results only after that event, and the pinned
    buffers of a slot are written again only after the event of the
    chunk that last used them. On the CPU the same calls run
    synchronously.
    """

    SLOTS = 2

    def __init__(self, device: torch.device) -> None:
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"pipeline: no lane for device {device}")
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = _side_stream(device) if self.cuda else None
        self._pinned = [{} for _ in range(self.SLOTS)]
        self._busy = [None] * self.SLOTS
        self._unread = [False] * self.SLOTS
        self._next = 0

    def _buffer(self, slot: int, key, shape, dtype) -> torch.Tensor:
        k = (key, tuple(shape), dtype)
        buf = self._pinned[slot].get(k)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[slot][k] = buf
        return buf

    def submit(self, stage, *arrays: np.ndarray) -> _Chunk:
        """Upload ``arrays`` and start ``stage(*tensors)``, which returns a
        tensor or a tuple of tensors on the device, and their copies back."""
        slot = self._next
        self._next = (slot + 1) % self.SLOTS
        if self._unread[slot]:
            raise RuntimeError("pipeline: a chunk's results were not read "
                               "before its buffers came round again")
        self._unread[slot] = True
        if not self.cuda:
            inputs = [torch.from_numpy(np.ascontiguousarray(a))
                      for a in arrays]
            outs = stage(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            return _Chunk(self, slot, None, outs, inputs)
        if self._busy[slot] is not None:
            self._busy[slot].synchronize()   # its copies still read them
        staged = []
        for i, a in enumerate(arrays):
            buf = self._buffer(slot, ("in", i), a.shape,
                               torch.from_numpy(a[:0]).dtype)
            buf.numpy()[...] = a
            staged.append(buf)
        with torch.cuda.stream(self.stream):
            inputs = [b.to(self.device, non_blocking=True) for b in staged]
            outs = stage(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            host = []
            for j, o in enumerate(outs):
                hb = self._buffer(slot, ("out", j), o.shape, o.dtype)
                hb.copy_(o, non_blocking=True)
                host.append(hb)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._busy[slot] = done
        return _Chunk(self, slot, done, host, inputs)

    def rerun(self, chunk: _Chunk, stage) -> np.ndarray:
        """``stage`` again on a finished chunk's device inputs, on the
        lane's stream, read back before returning."""
        if not self.cuda:
            return stage(*chunk.inputs).numpy()
        with torch.cuda.stream(self.stream):
            return stage(*chunk.inputs).cpu().numpy()


# ---- pipelines --------------------------------------------------------------

def encode_frames_pipelined(frames, bit_depth: int = 16,
                            signed: bool = False, levels: int = 5,
                            chunk: int = 8, params=None,
                            engine: str = "auto", *,
                            device: torch.device) -> List[bytes]:
    """Double-buffered J2K-lossless multi-frame encode.

    The device transforms chunk k+1 while the host entropy-codes chunk k.

    engine: "auto" picks the transform engine from the measured transfer
    policy of ``device`` — the batched device stage unless transfers cost
    more than the native host 5/3 they replace (the CPU always takes the
    device stage: it transfers nothing); "device"/"host" force one.
    Output bytes are identical either way.

    frames: [F, H, W] (grayscale) or [F, H, W, 3] (RGB — encoded with the
    reversible RCT like the scalar path). Returns list of codestream
    bytes, one per frame. A call that returns logs a
    ``pipeline.encode`` event (utils.profiling) naming its engine.
    """
    from .codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
    from .codestream import j2k as j2kcs

    frames = np.asarray(frames)
    if frames.shape[0] == 0:
        return []
    rgb = frames.ndim == 4
    if rgb:
        f, h, w, nc = frames.shape
        if nc != 3:
            raise ValueError("RGB pipeline expects 3 components")
        frames = np.moveaxis(frames, -1, 1)  # [F, 3, H, W]
    else:
        f, h, w = frames.shape
        nc = 1
    p = params or J2KEncodeParams(num_levels=levels)
    p.num_levels = p.clamped_levels(w, h)
    enc = J2KEncoder(p, device=device)

    use_host = _use_host(engine, device)
    if use_host:
        from .native import dwt53_fwd_native

        def host_transform(arr):
            x = arr.astype(np.int32) - (
                0 if signed else (1 << (bit_depth - 1)))
            if rgb:
                x = np.stack(rct_forward_np(x[:, 0], x[:, 1], x[:, 2]),
                             axis=1)
                return np.stack([
                    np.stack([_host_dwt(dwt53_fwd_native,
                                        fwd53_multilevel_, x[k, c],
                                        p.num_levels)
                              for c in range(3)])
                    for k in range(x.shape[0])])
            return np.stack([_host_dwt(dwt53_fwd_native, fwd53_multilevel_,
                                       x[k], p.num_levels)
                             for k in range(x.shape[0])])

    # RCT widens U/V by one bit beyond the subband gain, hence the
    # tighter RGB cutoff for the int16 readback
    narrow = bit_depth <= (12 if rgb else 13) and not signed
    # compact uploads: the device stage widens to int32 on the device
    if not signed and bit_depth <= 16 and frames.dtype.itemsize > 2:
        frames = frames.astype(np.uint16)
    elif signed and bit_depth <= 15 and frames.dtype.itemsize > 2:
        frames = frames.astype(np.int16)

    def device_stage(x, narrow=narrow):
        if rgb:
            return _pipeline_device_stage_rgb(x, bit_depth, p.num_levels,
                                              narrow)
        return _pipeline_device_stage(x, bit_depth, signed, p.num_levels,
                                      narrow)

    def fetch(pending: _Chunk) -> np.ndarray:
        if not narrow:
            return pending.result()[0]
        c16, maxabs = pending.result()
        if int(maxabs) <= INT16_MAX:
            return c16.astype(np.int32)
        # rare: the worst-case lifting gain overflowed int16 — redo wide
        return lane.rerun(pending, partial(device_stage, narrow=False))

    # overlap needs >= 2 chunks in flight; small chunks also bound the
    # serial fill (first chunk's upload+compute+readback is unhidden)
    if f > 1:
        chunk = max(1, min(chunk, -(-f // 2), 4))
    chunks = [frames[i : i + chunk] for i in range(0, f, chunk)]
    if not use_host:
        # dispatch chunk 0; its copies proceed while the host assembles
        # the headers below
        lane = _Lane(device)
        pending = lane.submit(device_stage, chunks[0])
    out = []
    siz = j2kcs.SizInfo(xsiz=w, ysiz=h, xtsiz=w, ytsiz=h,
                        components=[(bit_depth, signed, 1, 1)] * nc)
    cod = j2kcs.CodInfo(progression=p.progression, num_layers=1,
                        mct=1 if rgb else 0,
                        num_levels=p.num_levels, cb_width=p.cb_width,
                        cb_height=p.cb_height, cb_style=p.cb_style,
                        transform=1, use_sop=p.use_sop, use_eph=p.use_eph)
    qcd = j2kcs.QcdInfo(style=0, guard_bits=p.guard_bits)
    from .codecs.j2k_geometry import band_gain
    from .codecs import j2k_quant as jq
    for (r, band) in jq.band_sequence(p.num_levels):
        qcd.exponents.append(bit_depth + band_gain(band))

    header = bytearray(b"\xff\x4f")
    header += j2kcs.write_siz(siz)
    header += j2kcs.write_cod(cod)
    header += j2kcs.write_qcd(qcd)
    if p.comment:
        header += j2kcs.write_com(p.comment)

    for ci in range(len(chunks)):
        if use_host:
            coeffs = host_transform(chunks[ci])
        else:
            if ci + 1 < len(chunks):  # overlap: dispatch next device work
                nxt = lane.submit(device_stage, chunks[ci + 1])
            else:
                nxt = None
            coeffs = fetch(pending)   # waits for chunk ci's copies
            pending = nxt
        for k in range(coeffs.shape[0]):
            frame_coeffs = coeffs[k] if rgb else coeffs[k : k + 1]
            split = bool(enc.params.packed_headers)
            want_plt = bool(enc.params.plt_markers)
            res = enc._encode_tile_entropy(frame_coeffs, (0, 0, w, h),
                                           cod, qcd, bit_depth,
                                           split=split, want_plt=want_plt)
            if split or want_plt:  # PPT/PLT tile-part header segments
                head = b""
                if split:
                    head += j2kcs.write_ppt(res.headers)
                if want_plt:
                    head += j2kcs.write_plt_segments(res.pkt_lengths)
                tp = j2kcs.write_tile_part(0, res.body,
                                           head_segments=head)
            else:
                tp = j2kcs.write_tile_part(0, res)
            tlm = b""
            if getattr(enc.params, "tlm_markers", False):
                # Ptlm covers the whole tile-part incl. PPT/PLT segs
                tlm = j2kcs.write_tlm(0, [(0, len(tp))])
            stream = (bytes(header) + tlm + tp
                      + j2kcs.EOC.to_bytes(2, "big"))
            if enc.params.container is not None:
                # same JP2/JPH wrapping as J2KEncoder.encode — the
                # pipelined path must emit identical bytes per params
                stream = j2kcs.wrap_jp2(stream,
                                        brand=enc.params.container)
            out.append(stream)
    _log_call("pipeline.encode", use_host, f, len(chunks))
    return out


def _log_call(name: str, use_host: bool, frames: int, chunks: int) -> None:
    from .utils.profiling import log_event
    log_event(name, {"engine": "host" if use_host else "device",
                     "frames": frames, "chunks": chunks})


def decode_frames_pipelined(streams, chunk: int = 8,
                            return_info: bool = False,
                            engine: str = "auto", reduce: int = 0, *,
                            device: torch.device):
    """Double-buffered J2K multi-frame decode.

    The host entropy-decodes (T1 + T2) chunk k+1 while the device runs
    the batched inverse DWT + inverse color transform + DC unshift for
    chunk k — the decode-side mirror of encode_frames_pipelined (same
    ``engine`` choice). Requires homogeneous single-tile streams of equal
    geometry (the shape the encode pipelines emit). Reversible output is
    bit-identical to J2KDecoder.decode per frame; irreversible streams
    (host per-band dequant + float 9/7 inverse) come back clipped to the
    declared dynamic range (what the final pixel pack does anyway) and
    match the scalar decoder within ±1 rounding ties.

    Returns a list of [H, W, C] int32 arrays. A call that returns logs a
    ``pipeline.decode`` event (utils.profiling) naming its engine.
    """
    from .codecs.jpeg2000 import (J2KEncoder, decode_to_packed,
                                  dequantize_packed)

    if not streams:
        return ([], None) if return_info else []

    use_host = _use_host(engine, device)

    global_meta = [None]  # enforced across ALL chunks, not just within

    def rdiv(v):  # reduced-grid coordinate (level-R LL window)
        return -(-v // (1 << reduce))

    def host_stage(group):
        packs = []
        for s in group:
            packed, siz, cod, qcd = decode_to_packed(s, return_qcd=True,
                                                     reduce=reduce)
            m = (packed.shape, cod.num_levels - reduce, rdiv(siz.xosiz),
                 rdiv(siz.yosiz),
                 siz.components[0][:2], cod.mct, cod.transform, qcd)
            if global_meta[0] is None:
                global_meta[0] = m
            elif m != global_meta[0]:
                raise ValueError("decode pipeline needs equal-geometry "
                                 "streams")
            if cod.transform != 1:
                # irreversible: per-band dequant on the host (QCD steps,
                # shared helper with the scalar decoder; deltas build
                # over the FULL level count — band indices are a
                # prefix-stable subset under reduce)
                _, th_, tw_ = packed.shape
                deltas = J2KEncoder._band_deltas(qcd, cod.num_levels,
                                                 siz.components[0][0])
                packed = dequantize_packed(
                    packed, (rdiv(siz.xosiz), rdiv(siz.yosiz),
                             rdiv(siz.xosiz) + tw_,
                             rdiv(siz.yosiz) + th_),
                    cod.num_levels - reduce, deltas)
            packs.append(packed)
        return np.stack(packs)

    groups = [streams[i : i + chunk] for i in range(0, len(streams), chunk)]
    out = []
    lane = None if use_host else _Lane(device)
    prev = None  # chunk pending readback
    for group in groups:
        batch = host_stage(group)  # host T1 (+dequant) for THIS chunk
        (shape, levels, x0, y0, (bits, signed), mct, transform,
         _qcd) = global_meta[0]
        if use_host:
            from .native import dwt53_inv_native, dwt97_inv_native

            recs = []
            for k in range(batch.shape[0]):
                if transform == 1:
                    rec = np.stack([
                        _host_dwt(dwt53_inv_native, inv53_multilevel_,
                                  batch[k, c], levels, x0, y0)
                        for c in range(batch.shape[1])])
                    if mct and rec.shape[0] >= 3:
                        rec = np.stack(
                            list(rct_inverse_np(rec[0], rec[1], rec[2]))
                            + [rec[i] for i in range(3, rec.shape[0])])
                else:
                    rec = np.stack([
                        _host_dwt(dwt97_inv_native, inv97_multilevel,
                                  batch[k, c].astype(np.float32), levels,
                                  x0, y0, as_int32=False)
                        for c in range(batch.shape[1])])
                    if mct and rec.shape[0] >= 3:
                        rec = np.stack(
                            list(ict_inverse_np(rec[0], rec[1], rec[2]))
                            + [rec[i] for i in range(3, rec.shape[0])])
                    rec = np.round(rec).astype(np.int32)
                if not signed:
                    rec = rec + (1 << (bits - 1))
                if transform != 1:
                    # match the device engine: lossy output is clipped to
                    # the declared range (what the final pack does)
                    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
                              if signed else (0, (1 << bits) - 1))
                    rec = np.clip(rec, lo, hi)
                recs.append(rec)
            out.extend(recs)
            continue
        # compact upload when the (host-known) coefficients fit int16
        if batch.dtype == np.int32 and np.abs(batch).max() <= 32767:
            batch = batch.astype(np.int16)
        # the narrow readback's clip is an identity only for FULL
        # reversible reconstruction; a reduced decode's LL can over/
        # undershoot the declared range (lowpass ringing), so reversible
        # reduce keeps the int32 path and stays bit-identical to
        # J2KDecoder. Irreversible output is ALWAYS clipped, matching the
        # host engine.
        narrow = bits <= 16 and (reduce == 0 or transform != 1)
        stage = (_j2k_decode_device_stage if transform == 1
                 else _j2k_decode_device_stage_97)
        pending = lane.submit(partial(stage, levels=levels, x0=x0, y0=y0,
                                      bits=bits, signed=signed,
                                      mct=bool(mct), narrow=narrow), batch)
        if prev is not None:
            out.extend(prev.result()[0])  # previous chunk's device work
        prev = pending
    if prev is not None:
        out.extend(prev.result()[0])
    frames = [np.moveaxis(np.asarray(f).astype(np.int32), 0, -1)
              for f in out]
    _log_call("pipeline.decode", use_host, len(frames), len(groups))
    if return_info:
        (bits, signed) = global_meta[0][4]
        return frames, (bits, signed)
    return frames
