"""HTJ2K DICOM transfer-syntax adapters — UIDs .201/.202/.203.

Role of reference jpeg2000/htj2k/codec.go:89-310: reuse the JPEG 2000
encoder with HT block coding (cb_style 0x40, CAP marker), RPCL default
progression, level clamp for small images (calculateMaxLevels :312).

Port of ``go_dicom_codec_tpu/codecs/htj2k.py``: every codec holds the
``torch.device`` its device stages run on and the transform engine its
multi-frame decode pipeline uses (``pipeline``'s ``engine``), and
``register`` fills a registry the caller passes instead of the global
one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import uids
from ..codestream import j2k
from ..errors import UnsupportedFormatError
from ..frames import FrameInfo, PixelData, frame_to_array
from ..params import Parameters, require_range
from ..pipeline import check_engine
from ..registry import CodecRegistry
from ..utils.profiling import count, span
from .j2k_adapters import SpannedCodec
from .jpeg2000 import J2KEncodeParams, J2KEncoder, decode_to_pixels


class HTJ2KParameters(Parameters):
    """Reference jpeg2000/htj2k/parameters.go:71-167 subset."""

    def __init__(self, num_levels: int = 5, progression: int = j2k.PROG_RPCL,
                 lossless: bool = True, quality: int = 85, **kw):
        super().__init__(num_levels=num_levels, progression=progression,
                         lossless=lossless, quality=quality, **kw)

    def with_num_levels(self, n: int):
        return self.with_("num_levels", n)

    def validate(self) -> None:
        require_range("num_levels",
                      int(self.get_parameter("num_levels", 5)), 0, 6)


class HTJ2KLosslessCodec(SpannedCodec):
    """UID .201 (reference htj2k/codec.go:289-310)."""

    _uid = uids.HTJ2K_LOSSLESS
    _lossless = True
    _progression = j2k.PROG_LRCP

    def __init__(self, device: torch.device, engine: str = "auto") -> None:
        # checked here: the decode fallback below would swallow the
        # pipelines' ValueError for an unknown engine
        self.device, self.engine = device, check_engine(engine)

    def name(self) -> str:
        return "HTJ2K Lossless"

    def transfer_syntax(self) -> str:
        return self._uid

    def get_default_parameters(self) -> Parameters:
        return HTJ2KParameters(progression=self._progression,
                               lossless=self._lossless)

    def _build_params(self, info: FrameInfo,
                      parameters: Optional[Parameters]) -> J2KEncodeParams:
        p = J2KEncodeParams(lossless=self._lossless, htj2k=True,
                            progression=self._progression)
        if parameters is not None:
            for key in ("num_levels", "progression", "quality",
                        "tile_width", "tile_height", "cb_width",
                        "cb_height"):
                v = parameters.get_parameter(key)
                if isinstance(v, int):
                    setattr(p, key, v)
            # SigProp+MagRef refinement (T.814 §7.3-7.5, beyond the
            # reference): 3 PCRD truncation points per code-block
            if parameters.get_parameter("ht_refinement"):
                p.ht_refinement = True
            nl = parameters.get_parameter("num_layers")
            if isinstance(nl, int) and nl > 1:
                p.num_layers = nl
                lr = parameters.get_parameter("layer_rates")
                if isinstance(lr, (list, tuple)):
                    p.layer_rates = [float(r) for r in lr]
                if parameters.get_parameter("append_lossless_layer"):
                    p.append_lossless_layer = True
        # clamp levels for small images (htj2k/codec.go:312-333)
        p.num_levels = p.clamped_levels(info.width, info.height)
        return p

    def _encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
                parameters: Optional[Parameters]) -> str:
        info = old_pixel_data.get_frame_info()
        if not self._lossless and info.is_signed:
            raise UnsupportedFormatError("HTJ2K lossy rejects signed pixels")
        enc = J2KEncoder(self._build_params(info, parameters),
                         device=self.device, engine=self.engine)
        for i in range(old_pixel_data.frame_count()):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(enc.encode(
                frame, info.width, info.height, info.samples_per_pixel,
                info.bits_stored, info.is_signed and self._lossless))
        return "scalar"

    def _decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
                parameters: Optional[Parameters]) -> str:
        nframes = old_pixel_data.frame_count()
        if nframes > 1:
            # batched host-entropy / device-inverse overlap — HT block
            # decode happens in decode_to_packed's host stage, so the
            # same pipeline carries HT streams (reversible output is
            # bit-identical to the scalar path; 9/7 within one tie)
            try:
                from ..errors import CorruptStreamError
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
            except (UnsupportedFormatError, ValueError,
                    CorruptStreamError):
                # heterogeneous/multi-tile: scalar path below
                count("adapter.fallbacks")
        for i in range(nframes):
            pix, *_ = decode_to_pixels(old_pixel_data.get_frame(i),
                                       device=self.device,
                                       engine=self.engine)
            new_pixel_data.add_frame(pix)
        return "scalar"


class HTJ2KLosslessRPCLCodec(HTJ2KLosslessCodec):
    """UID .202 — lossless with RPCL progression."""

    _uid = uids.HTJ2K_LOSSLESS_RPCL
    _progression = j2k.PROG_RPCL

    def name(self) -> str:
        return "HTJ2K Lossless RPCL"


class HTJ2KCodec(HTJ2KLosslessCodec):
    """UID .203 — HTJ2K (lossy permitted)."""

    _uid = uids.HTJ2K
    _lossless = False
    _progression = j2k.PROG_RPCL

    def name(self) -> str:
        return "HTJ2K"


def register(registry: CodecRegistry, device: torch.device,
             engine: str = "auto") -> None:
    """Register the three HTJ2K codecs, each running on ``device`` with
    the pipelines' transform ``engine``."""
    for cls in (HTJ2KLosslessCodec, HTJ2KLosslessRPCLCodec, HTJ2KCodec):
        codec = cls(device, engine)
        registry.register_codec(codec.transfer_syntax(), codec)
