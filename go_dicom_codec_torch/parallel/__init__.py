"""Frame/tile batching, device meshes, and multi-device scale-out."""

from .mesh import (FRAME_AXIS, TILE_AXIS, decode_frames_sharded,
                   encode_frames_sharded, frame_sharding,
                   frame_tile_sharding, make_mesh, pad_batch_to_devices,
                   shard_frames)

__all__ = [
    "FRAME_AXIS",
    "TILE_AXIS",
    "make_mesh",
    "frame_sharding",
    "frame_tile_sharding",
    "shard_frames",
    "pad_batch_to_devices",
    "encode_frames_sharded",
    "decode_frames_sharded",
]
