"""Fused 8×8 DCT + quantization: the counterpart of ``ops/pallas_dct.py``.

``fdct8x8_quant`` launches the hand-written kernel of
``csrc/fdct8x8_quant.cu`` for a CUDA tensor and runs the plain version,
``quantize(fdct8x8(to_blocks(x - shift)))``, for a CPU tensor. Unlike the
TPU kernel it needs only H % 8 == W % 8 == 0 (no W % 128 lane rule, no
block-diagonal Dᵀ). The kernel moves 16 bytes at a time, so a view that
does not start on a 16-byte boundary is copied first.

Like the reference kernel it is a benchmark kernel, kept off every codec
path: lossy JPEG codes through the integer islow DCT.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .dct8x8 import (_basis, fdct8x8, from_blocks, pad_replicate_to_8,
                     quantize, to_blocks)


def fdct8x8_quant_plain(x: torch.Tensor, qtable,
                        level_shift: int = 128) -> torch.Tensor:
    """[B, H, W] int samples → [B, H, W] int32 quantized DCT blocks in
    raster order within each 8×8 block; plain torch on x's device."""
    q = torch.as_tensor(qtable, device=x.device)
    blocks = to_blocks(x.to(torch.float32) - float(level_shift))
    return from_blocks(quantize(fdct8x8(blocks), q))


def fdct8x8_quant(x: torch.Tensor, qtable,
                  level_shift: int = 128) -> torch.Tensor:
    """``fdct8x8_quant_plain``'s result: the kernel for a CUDA tensor, the
    plain version for a CPU tensor. x is [B, H, W] with H, W multiples of 8.
    """
    if x.device.type == "cpu":
        return fdct8x8_quant_plain(x, qtable, level_shift)
    if x.device.type != "cuda":
        raise ValueError(f"fdct8x8_quant: no lane for device {x.device}")
    q = torch.as_tensor(qtable, dtype=torch.float32,
                        device=x.device).reshape(64).contiguous()
    x = x.to(torch.int32).contiguous()
    if not _kernels.aligned16(x):   # a view off the 16-byte grid
        x = x.clone()
    out = torch.empty_like(x)
    _kernels.fdct8x8_quant(x, out, _basis(x.device).view(64), q,
                           level_shift)
    return out


def encode_plane_blocks(plane: torch.Tensor, qtable,
                        level_shift: int = 128) -> torch.Tensor:
    """[H, W] plane → quantized coefficient blocks [nby, nbx, 8, 8] int32,
    edge-replicating H and W up to multiples of 8."""
    p = pad_replicate_to_8(plane.to(torch.int32))
    h8, w8 = p.shape
    out = fdct8x8_quant(p[None], qtable, level_shift)[0]
    return out.reshape(h8 // 8, 8, w8 // 8, 8).permute(0, 2, 1, 3)
