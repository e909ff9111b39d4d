"""DICOM RLE Lossless codec (PS3.5 Annex G).

Behavioral parity with reference rle/rle.go: 64-byte little-endian header
(uint32 segment count + 15 uint32 offsets), <=15 byte segments — one per
(sample, byte-of-BitsAllocated) MSB-first — each PackBits-coded; segments
start at even offsets and the stream is padded to even length
(rle/rle.go:199-206,286-290).

The byte-plane split/interleave is a device transpose (ops/planes.py);
the run coder is host-side vectorized numpy (entropy/rlepack.py).

Port of ``go_dicom_codec_tpu/codecs/rle.py``: the batched forms take the
``torch.device`` the planes move on (one upload, the split or merge there,
one readback), ``RLECodec`` holds that device and the transform engine
("auto", "device" or "host", as the J2K pipelines' ``engine``), and
``register`` fills a registry the caller passes instead of the global
one.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from ..entropy.rlepack import packbits_decode, packbits_encode
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..frames import FrameInfo, PixelData
from ..ops.planes import (merge_byte_planes, merge_byte_planes_np,
                          split_byte_planes, split_byte_planes_np)
from ..params import Parameters
from ..pipeline import check_engine, prefer_batched_device
from ..registry import Codec, CodecRegistry
from .. import uids

_HEADER_LEN = 64
_MAX_SEGMENTS = 15


def _pack_segments(planes, info: FrameInfo) -> bytes:
    """Byte planes → RLE stream (header + even-aligned PackBits segs)."""
    num_segments = info.bytes_allocated * info.samples_per_pixel
    offsets = [0] * _MAX_SEGMENTS
    body = bytearray()
    pos = _HEADER_LEN
    for s in range(num_segments):
        if pos & 1:  # segments start at even offsets (rle/rle.go:201-203)
            body.append(0)
            pos += 1
        offsets[s] = pos
        seg = packbits_encode(planes[s])
        body += seg
        pos += len(seg)
    if pos & 1:  # total stream even length (rle/rle.go:286-290)
        body.append(0)
    header = struct.pack("<16I", num_segments, *offsets)
    return bytes(header) + bytes(body)


def _validate_encode_frame(frame: bytes, info: FrameInfo) -> None:
    if not frame:
        raise UnsupportedFormatError("source frame data must not be empty")
    num_segments = info.bytes_allocated * info.samples_per_pixel
    if num_segments > _MAX_SEGMENTS:
        raise UnsupportedFormatError(
            f"RLE supports at most 15 segments, need {num_segments}"
        )
    if len(frame) < info.uncompressed_frame_size:
        raise UnsupportedFormatError(
            f"frame buffer {len(frame)} smaller than expected "
            f"{info.uncompressed_frame_size}"
        )


def encode_frame(frame: bytes, info: FrameInfo) -> bytes:
    """Encode one raw frame to an RLE stream (reference rle/rle.go:86-128)."""
    _validate_encode_frame(frame, info)
    planes = split_byte_planes_np(frame, info)
    return _pack_segments(planes, info)


def encode_frames_batched(frames, info: FrameInfo, device: torch.device):
    """Multi-frame encode with the byte-plane transpose as one device
    call over the whole stack on ``device`` (ops/planes.split_byte_planes:
    one upload, the split, one readback); PackBits stays host-side per
    segment. Byte-identical to per-frame encode_frame. Interleaved layouts
    only (planar spp>1 callers use the host path)."""
    for f in frames:
        _validate_encode_frame(f, info)
    n = info.uncompressed_frame_size
    batch = np.stack([np.frombuffer(f, dtype=np.uint8, count=n)
                      for f in frames])
    planes = split_byte_planes(torch.as_tensor(batch).to(device),
                               info.bytes_allocated,
                               info.samples_per_pixel).cpu().numpy()
    return [_pack_segments(planes[i], info) for i in range(len(frames))]


def decode_frames_batched(datas, info: FrameInfo, device: torch.device):
    """Multi-frame decode: host PackBits per segment, then one device
    merge/interleave call over the stack on ``device`` (ops/planes.
    merge_byte_planes: one upload, the merge, one readback). Byte-identical
    to per-frame decode_frame."""
    p = info.pixel_count
    sb = info.bytes_allocated * info.samples_per_pixel
    planes = np.empty((len(datas), sb, p), dtype=np.uint8)
    for i, data in enumerate(datas):
        planes[i] = _decode_planes(data, info)
    out = merge_byte_planes(torch.as_tensor(planes).to(device),
                            info.bytes_allocated,
                            info.samples_per_pixel).cpu().numpy()
    return [out[i].tobytes() for i in range(len(datas))]


def _use_device_planes(info: FrameInfo, frame_count: int,
                       device: torch.device, engine: str) -> bool:
    """Device byte-plane transpose only for two frames or more in an
    interleaved layout (the torch forms assume it; planar spp>1 stays
    host), and then as ``engine`` says: always ("device"), never ("host"),
    or when the measured transfer policy of ``device`` prefers batched
    device work ("auto")."""
    if engine == "host" or frame_count < 2:
        return False
    if info.samples_per_pixel > 1 and info.planar_configuration != 0:
        return False
    return engine == "device" or prefer_batched_device(device)


def _decode_planes(data: bytes, info: FrameInfo) -> np.ndarray:
    """RLE stream → ``[num_segments, pixel_count]`` uint8 byte planes
    (header validation + per-segment PackBits; reference rle/rle.go:130-178)."""
    if len(data) < _HEADER_LEN:
        raise CorruptStreamError(
            f"RLE data too short: need at least 64 bytes, got {len(data)}"
        )
    fields = struct.unpack_from("<16I", data, 0)
    num_segments = fields[0]
    offsets = list(fields[1:])
    if not (1 <= num_segments <= _MAX_SEGMENTS):
        raise CorruptStreamError(
            f"invalid number of RLE segments: {num_segments} (must be 1-15)"
        )
    expected = info.bytes_allocated * info.samples_per_pixel
    if num_segments != expected:
        raise CorruptStreamError(
            f"unexpected number of RLE segments: got {num_segments}, "
            f"expected {expected}"
        )
    for s in range(num_segments):
        if offsets[s] > len(data):
            raise CorruptStreamError(
                f"RLE segment {s} offset {offsets[s]} exceeds data length"
            )

    p = info.pixel_count
    planes = np.zeros((num_segments, p), dtype=np.uint8)
    for s in range(num_segments):
        start = offsets[s]
        end = offsets[s + 1] if s < num_segments - 1 else len(data)
        planes[s] = packbits_decode(data[start:end], p)
    return planes


def decode_frame(data: bytes, info: FrameInfo) -> bytes:
    """Decode one RLE stream to a raw frame (reference rle/rle.go:130-178)."""
    return merge_byte_planes_np(_decode_planes(data, info), info)


class RLECodec(Codec):
    """RLE Lossless (1.2.840.10008.1.2.5) — reference rle/rle.go:22-84."""

    def __init__(self, device: torch.device, engine: str = "auto") -> None:
        self.device, self.engine = device, check_engine(engine)

    def name(self) -> str:
        return "RLE Lossless"

    def transfer_syntax(self) -> str:
        return uids.RLE_LOSSLESS

    def encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        info = old_pixel_data.get_frame_info()
        n = old_pixel_data.frame_count()
        if _use_device_planes(info, n, self.device, self.engine):
            frames = [old_pixel_data.get_frame(i) for i in range(n)]
            for stream in encode_frames_batched(frames, info, self.device):
                new_pixel_data.add_frame(stream)
            return
        for i in range(n):
            new_pixel_data.add_frame(encode_frame(old_pixel_data.get_frame(i), info))

    def decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        info = old_pixel_data.get_frame_info()
        n = old_pixel_data.frame_count()
        if _use_device_planes(info, n, self.device, self.engine):
            datas = [old_pixel_data.get_frame(i) for i in range(n)]
            for frame in decode_frames_batched(datas, info, self.device):
                new_pixel_data.add_frame(frame)
            return
        for i in range(n):
            new_pixel_data.add_frame(decode_frame(old_pixel_data.get_frame(i), info))


def register(registry: CodecRegistry, device: torch.device,
             engine: str = "auto") -> None:
    """Register the RLE codec, running on ``device`` with ``engine``."""
    registry.register_codec(uids.RLE_LOSSLESS, RLECodec(device, engine))
