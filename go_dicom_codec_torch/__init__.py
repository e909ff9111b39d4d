"""PyTorch + CUDA port of the DICOM pixel-data codec framework.

``go_dicom_codec_tpu`` is the JAX reference; each module here mirrors the
module of the same path there. The port covers the JPEG 2000 family
(transfer syntaxes .90-.93): frames in, codestreams out, and back, with
the transforms on an NVIDIA Hopper GPU and the entropy stages on the host.

Layout:
  - ``ops/``        plain-torch functions (the CPU lane and the kernels'
                    reference) and the wrappers of the hand-written kernels.
  - ``csrc/``       the CUDA C++ kernels, built with ``nvcc`` at first use.
  - ``pipeline``    the device stages and the double-buffered multi-frame
                    encode and decode pipelines.
  - ``codecs/``     the J2K codec core and its transfer-syntax adapters.
  - ``codestream/``, ``entropy/``, ``t2/``, ``native/``, ``utils/``, and
    ``errors``, ``frames``, ``params``, ``uids``, ``registry``: the host
                    half, copied byte for byte from the reference (the
                    native T1/T2 library is built with g++ at first use).
  - ``tools/``      the device bench.

Every kernel wrapper launches its kernel for a CUDA tensor and runs the
plain version for a CPU tensor; any other device raises. Nothing picks a
device: codecs, encoders, decoders and pipelines take a ``torch.device``.
Importing the package builds nothing, registers nothing and imports
neither ``jax`` nor the JAX package.

    registry = make_registry(torch.device("cuda", 0))
    codec = registry.get_codec(uids.JPEG_2000_LOSSLESS)
"""

import torch

from .errors import (
    CodecError,
    CodecNotFoundError,
    CorruptStreamError,
    InvalidParameterError,
    InvalidQualityError,
    UnsupportedFormatError,
)
from .frames import FrameInfo, MemoryPixelData, PixelData
from .params import Parameters
from .registry import Codec, CodecRegistry
from . import uids

__version__ = "0.1.0"


def make_registry(device: torch.device,
                  engine: str = "auto") -> CodecRegistry:
    """A new registry holding the port's codecs, which run on ``device``.

    ``engine`` picks the transform engine of the multi-frame pipelines:
    "auto" (the measured transfer policy of ``device``), "device" or
    "host" (the native host transforms). Each call returns a fresh
    instance: registering a UID again replaces its entry without a word,
    so the port never shares a registry.
    """
    from .codecs import register_codecs

    registry = CodecRegistry()
    register_codecs(registry, device, engine)
    return registry


__all__ = [
    "CodecError",
    "CodecNotFoundError",
    "CorruptStreamError",
    "InvalidParameterError",
    "InvalidQualityError",
    "UnsupportedFormatError",
    "FrameInfo",
    "PixelData",
    "MemoryPixelData",
    "Parameters",
    "Codec",
    "CodecRegistry",
    "make_registry",
    "uids",
]
