"""JPEG 2000 DICOM transfer-syntax adapters.

Role of reference jpeg2000/lossless/codec.go (UIDs .90/.92) and
jpeg2000/lossy/codec.go (UIDs .91/.93): map FrameInfo + Parameters to
J2KEncodeParams, loop frames, decode with auto-detection.

Port of ``go_dicom_codec_tpu/codecs/j2k_adapters.py``: every codec holds
the ``torch.device`` its device stages run on and the transform engine
its multi-frame pipelines use (``pipeline``'s ``engine``), and
``register`` fills a registry the caller passes instead of the global
one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import uids
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..frames import FrameInfo, PixelData, frame_to_array
from ..params import Parameters, require_range
from ..pipeline import check_engine
from ..registry import Codec, CodecRegistry
from ..utils.profiling import count, span
from .jpeg2000 import (J2KDecoder, J2KEncodeParams, J2KEncoder,
                       decode_to_pixels)


class SpannedCodec(Codec):
    """A codec whose ``encode`` and ``decode`` record one ``codec.<op>``
    span each (utils.profiling; attributes ``frames`` and the ``route``
    taken, ``pipelined`` or ``scalar``) and count ``frames.<op>``, around
    its ``_encode`` / ``_decode``, which return the route."""

    def encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        n = old_pixel_data.frame_count()
        with span("codec.encode", frames=n) as sp:
            sp.set(route=self._encode(old_pixel_data, new_pixel_data,
                                      parameters))
        count("frames.encode", n)

    def decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        n = old_pixel_data.frame_count()
        with span("codec.decode", frames=n) as sp:
            sp.set(route=self._decode(old_pixel_data, new_pixel_data,
                                      parameters))
        count("frames.decode", n)


class J2KLosslessParameters(Parameters):
    """Reference jpeg2000/lossless/parameters.go:12-246 subset."""

    def __init__(self, num_levels: int = 5, progression: int = 0,
                 cb_width: int = 64, cb_height: int = 64, **kw):
        super().__init__(num_levels=num_levels, progression=progression,
                         cb_width=cb_width, cb_height=cb_height, **kw)

    def with_num_levels(self, n: int):
        return self.with_("num_levels", n)

    def with_progression(self, p: int):
        return self.with_("progression", p)

    def validate(self) -> None:
        require_range("num_levels", int(self.get_parameter("num_levels", 5)),
                      0, 6)


def openjpeg_layer_rates(rate: int, rate_levels, bits_stored: int,
                         bits_allocated: int,
                         append_lossless: bool) -> Optional[list]:
    """fo-dicom rate/rate-levels → OpenJPEG tcp_rates translation
    (reference lossless/codec.go:353-376 openJPEGLayerRates): leading
    rate-levels above the target rate become intermediate layers, the
    final layer is rate scaled by bits_stored/bits_allocated, plus an
    optional lossless (rate 0) layer."""
    if rate is None or rate <= 0:
        return None
    rates = []
    for v in (rate_levels or []):
        if v > rate:
            rates.append(float(v))
        else:
            break
    if bits_allocated <= 0:
        bits_allocated = bits_stored
    if bits_stored <= 0 or bits_allocated <= 0:
        rates.append(float(rate))
    else:
        rates.append(float(rate) * bits_stored / bits_allocated)
    if append_lossless:
        rates.append(0.0)
    return rates


def _apply_rate_levels(p: J2KEncodeParams,
                       parameters: Optional[Parameters],
                       info: FrameInfo) -> None:
    """Map the fo-dicom 'rate'/'rate_levels' convenience parameters to
    layer_rates when the caller didn't pass explicit rates."""
    if parameters is None or p.layer_rates is not None:
        return
    rate = parameters.get_parameter("rate")
    if rate is None:
        return
    rates = openjpeg_layer_rates(
        int(rate), parameters.get_parameter("rate_levels"),
        info.bits_stored, info.bits_allocated, p.append_lossless_layer)
    if rates:
        p.layer_rates = rates
        p.num_layers = len(rates)


# Default code-block style for the DICOM adapters: selective arithmetic
# bypass ("lazy", T.800 Table A-19 bit 0).  Measured on this target:
# ~25-35% faster T1 AND slightly SMALLER streams on both dense and
# textured content (raw bits beat adaptive coding on the low,
# near-incompressible bitplanes) — a strict improvement over the
# reference's style 0, which remains available via cb_style=0.  Every
# conformant decoder (incl. the reference, OpenJPEG/PIL — pinned by the
# foreign-oracle tests) decodes bypass streams.
_DEFAULT_CB_STYLE = 0x01


def _params_from(parameters: Optional[Parameters],
                 lossless: bool) -> J2KEncodeParams:
    p = J2KEncodeParams(lossless=lossless, cb_style=_DEFAULT_CB_STYLE)
    if parameters is None:
        return p
    def geti(key, default):
        v = parameters.get_parameter(key, default)
        return default if v is None else int(v)
    p.num_levels = geti("num_levels", p.num_levels)
    p.progression = geti("progression", p.progression)
    p.cb_width = geti("cb_width", p.cb_width)
    p.cb_height = geti("cb_height", p.cb_height)
    p.tile_width = geti("tile_width", 0)
    p.tile_height = geti("tile_height", 0)
    p.num_layers = geti("num_layers", 1)
    p.cb_style = geti("cb_style", _DEFAULT_CB_STYLE)
    p.quality = geti("quality", p.quality)
    p.guard_bits = geti("guard_bits", p.guard_bits)
    tr = parameters.get_parameter("target_ratio")
    if tr is not None:
        p.target_ratio = float(tr)
    if parameters.get_parameter("append_lossless_layer"):
        p.append_lossless_layer = True
    mv = parameters.get_parameter("mct")
    if mv is not None:
        p.mct = bool(mv)
    # lossy quantization overrides (reference lossy/codec.go:247-272):
    # subband_steps (alias custom_quant_steps) = explicit per-subband
    # steps, validated to 3*levels+1 at encode; quant_step_scale
    # multiplies them (or adjusts the quality curve equivalently)
    ss = parameters.get_parameter("subband_steps")
    if ss is None:
        ss = parameters.get_parameter("custom_quant_steps")
    if ss is not None:
        p.custom_quant_steps = [float(v) for v in ss]
    qs = parameters.get_parameter("quant_step_scale")
    if qs is not None:
        p.quant_step_scale = float(qs)
    # Part 2 MCT bindings (reference lossless/codec.go:187-240), layered
    # rates, ROI config and precincts pass through as-is
    for key in ("mct_matrix", "mct_inverse", "mct_offsets", "mct_bindings",
                "layer_rates", "roi_regions", "roi_shift", "roi_style",
                "precincts", "precinct_width", "precinct_height",
                "layer_budget_strategy", "packed_headers",
                "use_sop", "use_eph", "plt_markers", "tlm_markers",
                "ht_refinement", "block_encoder_factory"):
        v = parameters.get_parameter(key)
        if v is not None:
            setattr(p, key, v)
    # ROI (MaxShift) uses the SPP/MRP plane-skip schedule, which foreign
    # decoders only agree with in pure-MQ mode — drop the bypass default
    # there unless the caller explicitly forced a style
    if (getattr(p, "roi_regions", None) is not None
            and parameters.get_parameter("cb_style") is None):
        p.cb_style = 0
    return p


class J2KLosslessCodec(SpannedCodec):
    """UID .90 (reference jpeg2000/lossless/codec.go:306-322)."""

    _uid = uids.JPEG_2000_LOSSLESS

    def __init__(self, device: torch.device, engine: str = "auto") -> None:
        # checked here: the decode fallback below would swallow the
        # pipelines' ValueError for an unknown engine
        self.device, self.engine = device, check_engine(engine)

    def name(self) -> str:
        return "JPEG 2000 Lossless"

    def transfer_syntax(self) -> str:
        return self._uid

    def get_default_parameters(self) -> Parameters:
        return J2KLosslessParameters()

    def _encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
                parameters: Optional[Parameters]) -> str:
        info = old_pixel_data.get_frame_info()
        params = _params_from(parameters, lossless=True)
        _apply_rate_levels(params, parameters, info)
        nframes = old_pixel_data.frame_count()
        # multi-frame grayscale with default geometry: batch the device
        # stage (DC shift + DWT) over all frames with double-buffered
        # host↔device overlap (pipeline.encode_frames_pipelined); the
        # per-frame codestreams are byte-identical to the scalar path
        rgb_ok = (info.samples_per_pixel == 3
                  and info.planar_configuration == 0
                  and not info.is_signed
                  and (params.mct is None or params.mct))
        if (nframes > 1
                and (info.samples_per_pixel == 1 or rgb_ok)
                and params.tile_width == 0 and params.tile_height == 0
                and params.roi_regions is None
                and params.mct_matrix is None
                and params.mct_bindings is None
                and params.num_layers == 1
                and not params.htj2k
                and params.resolved_precincts(params.num_levels) is None
                and params.target_ratio == 0
                and not params.append_lossless_layer):
            from ..pipeline import encode_frames_pipelined
            dt = (np.int8 if info.is_signed else np.uint8) \
                if info.bits_allocated <= 8 else \
                (np.dtype("<i2") if info.is_signed else np.dtype("<u2"))
            nc = info.samples_per_pixel
            shape = ((info.height, info.width) if nc == 1
                     else (info.height, info.width, nc))
            frames = np.stack([
                np.frombuffer(old_pixel_data.get_frame(i), dtype=dt,
                              count=info.width * info.height * nc
                              ).reshape(shape)
                for i in range(nframes)])
            for stream in encode_frames_pipelined(
                    frames, bit_depth=info.bits_stored,
                    signed=info.is_signed, levels=params.num_levels,
                    params=params, engine=self.engine, device=self.device):
                new_pixel_data.add_frame(stream)
            return "pipelined"
        enc = J2KEncoder(params, device=self.device, engine=self.engine)
        for i in range(nframes):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(enc.encode(
                frame, info.width, info.height, info.samples_per_pixel,
                info.bits_stored, info.is_signed))
        return "scalar"

    def _decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
                parameters: Optional[Parameters]) -> str:
        info = old_pixel_data.get_frame_info()
        nframes = old_pixel_data.frame_count()
        if nframes > 1:
            # batched host-T1 / device-IDWT overlap (bit-identical to
            # the scalar path); falls back for shapes it can't batch
            try:
                from ..pipeline import decode_frames_pipelined

                streams = [old_pixel_data.get_frame(i)
                           for i in range(nframes)]
                frames, (depth, signed) = decode_frames_pipelined(
                    streams, return_info=True, engine=self.engine,
                    device=self.device)
                from .jpeg2000 import pack_decoded_pixels
                widen = info.bytes_allocated == 2 and depth <= 8
                with span("adapter.pack"):
                    for arr in frames:
                        new_pixel_data.add_frame(pack_decoded_pixels(
                            arr, depth, signed, widen16=widen))
                return "pipelined"
            except (UnsupportedFormatError, ValueError, CorruptStreamError):
                # heterogeneous/multi-tile: scalar path below
                count("adapter.fallbacks")
        for i in range(nframes):
            pix, w, h, c, depth, signed = decode_to_pixels(
                old_pixel_data.get_frame(i), device=self.device,
                engine=self.engine)
            if (info.bytes_allocated == 2 and depth <= 8):
                # widen to the container the DICOM dataset expects
                dt = np.int8 if signed else np.uint8
                wd = np.dtype("<i2") if signed else np.dtype("<u2")
                pix = np.frombuffer(pix, dtype=dt).astype(wd).tobytes()
            new_pixel_data.add_frame(pix)
        return "scalar"


class J2KMCLosslessCodec(J2KLosslessCodec):
    """UID .92 — Part 2 multi-component lossless."""

    _uid = uids.JPEG_2000_MC_LOSSLESS

    def name(self) -> str:
        return "JPEG 2000 Part 2 Multi-component Lossless"


class J2KLossyParameters(Parameters):
    """Reference jpeg2000/lossy parameter surface subset."""

    def __init__(self, quality: int = 85, num_levels: int = 5, **kw):
        super().__init__(quality=quality, num_levels=num_levels, **kw)

    @property
    def quality(self) -> int:
        return int(self.get_parameter("quality", 85))

    def with_quality(self, q: int):
        return self.with_("quality", q)

    def validate(self) -> None:
        require_range("quality", self.quality, 1, 100)


class J2KLossyCodec(SpannedCodec):
    """UID .91 (reference jpeg2000/lossy/codec.go:221-237): 9/7 + scalar
    quantization; signed pixels rejected like the reference
    (lossy/codec.go:73-180)."""

    _uid = uids.JPEG_2000_LOSSY

    def __init__(self, device: torch.device, engine: str = "auto") -> None:
        self.device, self.engine = device, check_engine(engine)

    def name(self) -> str:
        return "JPEG 2000 Lossy"

    def transfer_syntax(self) -> str:
        return self._uid

    def get_default_parameters(self) -> Parameters:
        return J2KLossyParameters()

    def _encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
                parameters: Optional[Parameters]) -> str:
        info = old_pixel_data.get_frame_info()
        if info.is_signed:
            raise UnsupportedFormatError(
                "JPEG 2000 lossy rejects signed pixel data "
                "(reference lossy/codec.go:73-180)")
        params = _params_from(parameters, lossless=False)
        _apply_rate_levels(params, parameters, info)
        # small-image level clamp (reference lossy/codec.go:392)
        enc = J2KEncoder(params, device=self.device)
        for i in range(old_pixel_data.frame_count()):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(enc.encode(
                frame, info.width, info.height, info.samples_per_pixel,
                info.bits_stored, False))
        return "scalar"

    def _decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
                parameters: Optional[Parameters]) -> str:
        nframes = old_pixel_data.frame_count()
        if nframes > 1:
            # batched host-entropy+dequant / device-9/7-inverse overlap
            # (within one rounding tie of the scalar decoder — float
            # program shapes; see pipeline.decode_frames_pipelined)
            try:
                from ..pipeline import decode_frames_pipelined
                from .jpeg2000 import pack_decoded_pixels

                streams = [old_pixel_data.get_frame(i)
                           for i in range(nframes)]
                frames, (depth, signed) = decode_frames_pipelined(
                    streams, return_info=True, engine=self.engine,
                    device=self.device)
                with span("adapter.pack"):
                    for arr in frames:
                        new_pixel_data.add_frame(pack_decoded_pixels(
                            arr, depth, signed))
                return "pipelined"
            except (UnsupportedFormatError, ValueError, CorruptStreamError):
                # heterogeneous/multi-tile: scalar path below
                count("adapter.fallbacks")
        for i in range(nframes):
            pix, *_ = decode_to_pixels(old_pixel_data.get_frame(i),
                                       device=self.device)
            new_pixel_data.add_frame(pix)
        return "scalar"


class J2KMCLossyCodec(J2KLossyCodec):
    """UID .93 — Part 2 multi-component lossy."""

    _uid = uids.JPEG_2000_MC_LOSSY

    def name(self) -> str:
        return "JPEG 2000 Part 2 Multi-component Lossy"


def register(registry: CodecRegistry, device: torch.device,
             engine: str = "auto") -> None:
    """Register the four J2K codecs, each running on ``device`` with the
    pipelines' transform ``engine``."""
    for cls in (J2KLosslessCodec, J2KMCLosslessCodec, J2KLossyCodec,
                J2KMCLossyCodec):
        codec = cls(device, engine)
        registry.register_codec(codec.transfer_syntax(), codec)
