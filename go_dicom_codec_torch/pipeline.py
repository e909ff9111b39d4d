"""Device stages of the JPEG 2000 lossless encode and decode pipelines.

Port of the device half of ``go_dicom_codec_tpu/pipeline.py``: the encode
transform (DC shift → RCT for RGB → multilevel 5/3 → per-codeblock stats,
:22-33 and :368-379), the pipelines' encode stage with its int16 narrow
readback and max-abs flag (:42-63), the int32 redo on overflow (:280-294,
here ``fetch_coeffs``) and the decode stage (:433-457). Every stage takes
tensors on the device they should run on; the 5/3 runs through the
hand-written kernels on CUDA tensors.

The double-buffered ``encode_frames_pipelined``/``decode_frames_pipelined``
need the host entropy stage and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.blockstats import codeblock_max_abs, max_bitplane
from .ops.dwt53 import fwd53_multilevel_, inv53_multilevel_
from .ops.mct import (dc_level_shift, inv_dc_level_shift, rct_forward,
                      rct_inverse)

INT16_MAX = 32767


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
    if narrow:
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
        px = px.clamp(lo, hi)
        return px.to(torch.int16 if signed else torch.uint16)
    return px
