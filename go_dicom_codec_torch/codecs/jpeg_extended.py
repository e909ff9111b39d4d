"""JPEG Extended (Process 2&4, SOF1) codec — UID 1.2.840.10008.1.2.4.51.

Parity with reference jpeg/extended/: 8-bit input delegates to the Baseline
encoder (encoder_simple.go:14-31), 12-bit is a native sequential-DCT path
(sequential12.go: mono only, SOF1, JFIF APP0, component ID 1, luma quant
table with byte DQT, level shift 2048, optimal Huffman). The 12-bit device
stage reuses the batched DCT/quant kernels (float32 is exact for 12-bit
sums).

Port of ``go_dicom_codec_tpu/codecs/jpeg_extended.py``: ``encode``,
``decode`` and ``JPEGExtendedCodec`` take the ``torch.device`` (a required
keyword; an explicit None means no device) and the transform engine of the
baseline port (``jpeg_baseline``), and
``register`` fills a registry the caller passes instead of the global one.
The adapter's decode is the baseline port's (``jpeg_baseline.decode_frames``)
with .51's host part of a frame (``parse_frame``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import uids
from ..codestream import jpeg_markers as mk
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..frames import FrameInfo, PixelData, frame_to_array
from ..params import Parameters, require_range
from ..pipeline import check_engine
from ..registry import Codec, CodecRegistry
from . import jpeg_baseline as jb


class JPEGExtendedParameters(Parameters):
    def __init__(self, quality: int = 90, **kw):
        super().__init__(quality=quality, **kw)

    @property
    def quality(self) -> int:
        return int(self.get_parameter("quality", 90))

    def with_quality(self, q: int) -> "JPEGExtendedParameters":
        return self.with_("quality", q)

    def validate(self) -> None:
        require_range("quality", self.quality, 1, 100)


def encode(pixels: bytes, width: int, height: int, components: int,
           bit_depth: int, quality: int = 90, *,
           device: Optional[torch.device],
           engine: str = "auto") -> bytes:
    """Byte-level encode (reference jpeg/extended/encoder_simple.go:14-31)."""
    if bit_depth == 8:
        return jb.encode(pixels, width, height, components, quality,
                         device=device, engine=engine)
    if bit_depth == 12:
        if components != 1:
            raise UnsupportedFormatError(
                "12-bit JPEG Extended supports only one monochrome component")
        return jb.encode(pixels, width, height, 1, quality,
                         sof_marker=mk.SOF1, precision=12, write_jfif=True,
                         device=device, engine=engine)
    raise UnsupportedFormatError(f"bit depth {bit_depth} not in (8, 12)")


def detect_sof(data: bytes):
    """Peek at the SOF → (marker, sample precision)."""
    r = mk.JpegReader(data)
    if r.read_marker() != mk.SOI:
        raise CorruptStreamError("missing SOI")
    while True:
        marker = r.read_marker()
        if marker in (mk.SOF0, mk.SOF1, mk.SOF2, mk.SOF3, mk.SOF55):
            return marker, r.read_segment()[0]
        if marker in (mk.SOS, mk.EOI):
            raise CorruptStreamError("no SOF before scan")
        if mk.has_length(marker):
            r.read_segment()


def detect_bit_depth(data: bytes) -> int:
    """Peek at the SOF to find the sample precision."""
    return detect_sof(data)[1]


def parse_frame(data: bytes):
    """.51's host part of one frame (``jpeg_baseline.parse_scan``): a
    ``jpeg_baseline.ScanFrame`` of a sequential stream, or the pixels bytes
    of a progressive (SOF2) 8-bit one, which the reference's Extended
    decode accepts through Go stdlib image/jpeg
    (jpeg/extended/encoder_simple.go:35-46), decoded whole on the host."""
    sof, depth = detect_sof(data)
    if sof == mk.SOF2:
        from . import jpeg_progressive as jp

        return jp.decode(data)[0]
    if depth == 12:
        return jb.parse_scan(data, (mk.SOF1,), 12)
    return jb.parse_scan(data, (mk.SOF0, mk.SOF1), 8)


def decode(data: bytes, *, device: Optional[torch.device],
           engine: str = "auto"):
    """Byte-level decode → (pixels, width, height, components, bit_depth).

    Sequential streams take their dequant + IDCT where ``device`` and
    ``engine`` say (``jpeg_baseline.idct_frame``); progressive ones the
    native IDCT (``parse_frame``)."""
    sof, depth = detect_sof(data)
    if sof == mk.SOF2:
        from . import jpeg_progressive as jp

        px, w, h, c = jp.decode(data)
        return px, w, h, c, 8
    frame = parse_frame(data)
    px, w, h, c = frame.assemble(jb.idct_frame(frame, device, engine))
    return px, w, h, c, 12 if depth == 12 else 8


class JPEGExtendedCodec(Codec):
    """Registry adapter (reference jpeg/extended/codec.go:185-192)."""

    def __init__(self, device: torch.device, engine: str = "auto",
                 quality: int = 90) -> None:
        self.device, self.engine = device, check_engine(engine)
        self._quality = quality if 1 <= quality <= 100 else 90

    def name(self) -> str:
        return f"JPEG Extended Process 2 & 4 (Quality {self._quality})"

    def transfer_syntax(self) -> str:
        return uids.JPEG_EXTENDED_12BIT

    def get_default_parameters(self) -> Parameters:
        return JPEGExtendedParameters(quality=self._quality)

    def encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        info = old_pixel_data.get_frame_info()
        if info.bits_stored > 12:
            raise UnsupportedFormatError(
                f"JPEG Extended supports at most 12 bits, got "
                f"{info.bits_stored}")
        depth = 12 if info.bits_stored > 8 else 8
        q = self._quality
        if parameters is not None:
            qv = parameters.get_parameter("quality")
            if isinstance(qv, int) and 1 <= qv <= 100:
                q = qv
        nframes = old_pixel_data.frame_count()
        if nframes > 1 and info.samples_per_pixel == 1 and depth == 12:
            # batched device DCT for multi-frame 12-bit (same policy as
            # the baseline adapter: jpeg_baseline.use_pipeline)
            from ..pipeline import encode_frames_pipelined_jpeg

            if jb.use_pipeline(self.device, self.engine):
                frames = np.stack([
                    np.frombuffer(old_pixel_data.get_frame(i),
                                  dtype="<u2").reshape(
                                      info.height, info.width)
                    for i in range(nframes)])
                for stream in encode_frames_pipelined_jpeg(
                        frames, quality=q, precision=12,
                        device=self.device, engine=self.engine):
                    new_pixel_data.add_frame(stream)
                return
        for i in range(nframes):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(encode(
                frame, info.width, info.height, info.samples_per_pixel,
                depth, q, device=self.device, engine=self.engine))

    def decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        jb.decode_frames(old_pixel_data, new_pixel_data, parse_frame,
                         self.device, self.engine)


def register(registry: CodecRegistry, device: torch.device,
             engine: str = "auto") -> None:
    """Register the extended codec, running on ``device`` with
    ``engine``."""
    registry.register_codec(uids.JPEG_EXTENDED_12BIT,
                            JPEGExtendedCodec(device, engine))
