"""Transfer-syntax codec adapters of the port.

Fourteen UIDs: RLE (.5), JPEG baseline and extended (.50, .51), lossless
JPEG (.57, .70), JPEG-LS (.80, .81), the JPEG 2000 family (.90-.93) and
HTJ2K (.201-.203). Nothing registers at import: ``register_codecs``
fills a registry the caller made, with codecs that run on the
``torch.device`` it names. The JPEG-LS and lossless JPEG
codecs are host-only (their scans run in the native library); their
modules are copies of the reference's, whose own ``register()`` would fill
the global registry, so the port instantiates their classes instead.
"""

from __future__ import annotations

import torch

from ..registry import CodecRegistry


def register_codecs(registry: CodecRegistry, device: torch.device,
                    engine: str = "auto") -> None:
    from . import htj2k, j2k_adapters, jpeg_baseline, jpeg_extended, rle
    from .jpeg_lossless import JPEGLosslessP14Codec, JPEGLosslessSV1Codec
    from .jpegls import JPEGLSLosslessCodec, JPEGLSNearLosslessCodec

    for codec in (JPEGLSLosslessCodec(), JPEGLSNearLosslessCodec(),
                  JPEGLosslessP14Codec(), JPEGLosslessSV1Codec()):
        registry.register_codec(codec.transfer_syntax(), codec)
    j2k_adapters.register(registry, device, engine)
    htj2k.register(registry, device, engine)
    rle.register(registry, device, engine)
    jpeg_baseline.register(registry, device, engine)
    jpeg_extended.register(registry, device, engine)
