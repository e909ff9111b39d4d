"""Codec interface + transfer-syntax-UID registry.

Mirrors the external go-dicom registry contract the reference plugs into:
``codec.Codec`` (Name/TransferSyntax/GetDefaultParameters/Encode/Decode —
shape proven at reference rle/rle.go:18-84) and
``codec.GetGlobalRegistry().RegisterCodec(ts, c)`` (reference rle/rle.go:411-417).
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from .errors import CodecNotFoundError
from .frames import PixelData
from .params import Parameters


class Codec(ABC):
    """A transfer-syntax codec (reference codec.Codec interface)."""

    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def transfer_syntax(self) -> str:
        """DICOM transfer syntax UID this codec implements."""

    def get_default_parameters(self) -> Parameters:
        return Parameters()

    @abstractmethod
    def encode(
        self,
        old_pixel_data: PixelData,
        new_pixel_data: PixelData,
        parameters: Optional[Parameters] = None,
    ) -> None:
        """Encode every frame of old into new (reference rle/rle.go:37-59)."""

    @abstractmethod
    def decode(
        self,
        old_pixel_data: PixelData,
        new_pixel_data: PixelData,
        parameters: Optional[Parameters] = None,
    ) -> None:
        """Decode every frame of old into new (reference rle/rle.go:62-84)."""


class CodecRegistry:
    """Thread-safe UID → Codec map (reference external GetGlobalRegistry)."""

    def __init__(self) -> None:
        self._codecs: Dict[str, Codec] = {}
        self._lock = threading.Lock()

    def register_codec(self, transfer_syntax_uid: str, codec: Codec) -> None:
        with self._lock:
            self._codecs[transfer_syntax_uid] = codec

    def unregister_codec(self, transfer_syntax_uid: str) -> None:
        with self._lock:
            self._codecs.pop(transfer_syntax_uid, None)

    def get_codec(self, transfer_syntax_uid: str) -> Codec:
        with self._lock:
            codec = self._codecs.get(transfer_syntax_uid)
        if codec is None:
            raise CodecNotFoundError(
                f"no codec registered for transfer syntax {transfer_syntax_uid!r}"
            )
        return codec

    def has_codec(self, transfer_syntax_uid: str) -> bool:
        with self._lock:
            return transfer_syntax_uid in self._codecs

    def registered_transfer_syntaxes(self) -> List[str]:
        with self._lock:
            return sorted(self._codecs)


_global_registry = CodecRegistry()


def get_global_registry() -> CodecRegistry:
    """The process-wide registry (reference codec.GetGlobalRegistry())."""
    return _global_registry
