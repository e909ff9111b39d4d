"""Frame model: FrameInfo + PixelData contract + in-memory implementation.

Mirrors the external ``imagetypes`` contract the reference codecs consume
(fields proven at reference rle/rle.go:94-97, rle/parity_test.go:18-22,
jpeg2000/htj2k/codec.go:147-153; PixelData methods at reference
codec/test_helpers.go:22-66).

TPU-first addition: ``frames_as_array`` / ``frames_from_array`` convert the
whole multi-frame pixel buffer to/from a batched ndarray ``[F, H, W, C]`` so
the per-frame loops of the reference (e.g. rle/rle.go:44-57) become a leading
batch dimension for vmap/shard_map.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from .errors import UnsupportedFormatError

MONOCHROME1 = "MONOCHROME1"
MONOCHROME2 = "MONOCHROME2"
RGB = "RGB"
YBR_FULL = "YBR_FULL"
YBR_FULL_422 = "YBR_FULL_422"
PALETTE_COLOR = "PALETTE COLOR"


@dataclass
class FrameInfo:
    """Geometry + sample format of every frame in a PixelData.

    Field set matches reference usage (rle/rle.go:94-97,
    jpeg2000/htj2k/codec.go:147-153).
    """

    width: int
    height: int
    bits_allocated: int = 8
    bits_stored: int = 0
    high_bit: int = 0
    samples_per_pixel: int = 1
    planar_configuration: int = 0  # 0 = interleaved, 1 = planar
    photometric_interpretation: str = MONOCHROME2
    pixel_representation: int = 0  # 0 = unsigned, 1 = signed (two's complement)

    def __post_init__(self) -> None:
        if self.bits_stored == 0:
            self.bits_stored = self.bits_allocated
        if self.high_bit == 0:
            self.high_bit = self.bits_stored - 1

    @property
    def bytes_allocated(self) -> int:
        # Matches reference: (BitsAllocated-1)/8 + 1 (rle/rle.go:95)
        return (self.bits_allocated - 1) // 8 + 1

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    @property
    def uncompressed_frame_size(self) -> int:
        return self.pixel_count * self.samples_per_pixel * self.bytes_allocated

    @property
    def is_signed(self) -> bool:
        return self.pixel_representation == 1

    @property
    def numpy_dtype(self) -> np.dtype:
        if self.bytes_allocated == 1:
            return np.dtype(np.int8) if self.is_signed else np.dtype(np.uint8)
        if self.bytes_allocated == 2:
            return np.dtype(np.int16) if self.is_signed else np.dtype(np.uint16)
        if self.bytes_allocated == 4:
            return np.dtype(np.int32) if self.is_signed else np.dtype(np.uint32)
        raise UnsupportedFormatError(
            f"unsupported bits_allocated={self.bits_allocated}"
        )

    def with_(self, **kwargs) -> "FrameInfo":
        return replace(self, **kwargs)


@runtime_checkable
class PixelData(Protocol):
    """Streaming pixel-data contract (reference codec/test_helpers.go:22-66)."""

    def get_frame(self, index: int) -> bytes: ...

    def add_frame(self, data: bytes) -> None: ...

    def frame_count(self) -> int: ...

    def get_frame_info(self) -> FrameInfo: ...

    def is_encapsulated(self) -> bool: ...


@dataclass
class MemoryPixelData:
    """In-memory PixelData (reference TestPixelData, codec/test_helpers.go:8-66).

    This is the production container here, not just a test fake: encoded
    streams and raw frames alike are lists of byte strings.
    """

    info: FrameInfo
    encapsulated: bool = False
    frames: List[bytes] = field(default_factory=list)

    def get_frame(self, index: int) -> bytes:
        if index < 0 or index >= len(self.frames):
            raise IndexError(f"frame index {index} out of range [0, {len(self.frames)})")
        return self.frames[index]

    def add_frame(self, data: bytes) -> None:
        self.frames.append(bytes(data))

    def frame_count(self) -> int:
        return len(self.frames)

    def get_frame_info(self) -> FrameInfo:
        return self.info

    def is_encapsulated(self) -> bool:
        return self.encapsulated


def frame_to_array(frame: bytes, info: FrameInfo) -> np.ndarray:
    """Decode one raw little-endian frame buffer into ``[H, W, C]`` ndarray.

    Handles planar_configuration 0 (interleaved RGBRGB…) and 1 (RRR…GGG…BBB…)
    like the reference's pos/offset walk (rle/rle.go:100-123).
    """
    dt = info.numpy_dtype.newbyteorder("<")
    n = info.pixel_count * info.samples_per_pixel
    arr = np.frombuffer(frame, dtype=dt, count=n)
    if info.samples_per_pixel == 1:
        return arr.reshape(info.height, info.width, 1)
    if info.planar_configuration == 0:
        return arr.reshape(info.height, info.width, info.samples_per_pixel)
    planes = arr.reshape(info.samples_per_pixel, info.height, info.width)
    return np.moveaxis(planes, 0, -1)


def array_to_frame(arr: np.ndarray, info: FrameInfo) -> bytes:
    """Inverse of frame_to_array: ``[H, W, C]`` → raw little-endian buffer."""
    dt = info.numpy_dtype.newbyteorder("<")
    arr = np.ascontiguousarray(arr.reshape(info.height, info.width, -1))
    if info.samples_per_pixel > 1 and info.planar_configuration == 1:
        arr = np.moveaxis(arr, -1, 0)
    return np.ascontiguousarray(arr, dtype=dt).tobytes()


def frames_as_array(pd: PixelData) -> np.ndarray:
    """All frames as one batched ``[F, H, W, C]`` ndarray (the TPU batch dim)."""
    info = pd.get_frame_info()
    out = [frame_to_array(pd.get_frame(i), info) for i in range(pd.frame_count())]
    return np.stack(out, axis=0)


def frames_from_array(batch: np.ndarray, info: FrameInfo) -> MemoryPixelData:
    """Pack a batched ``[F, H, W, C]`` ndarray back into a MemoryPixelData."""
    pd = MemoryPixelData(info=info)
    for i in range(batch.shape[0]):
        pd.add_frame(array_to_frame(batch[i], info))
    return pd
