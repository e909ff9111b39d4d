"""Shared codec error vocabulary.

Mirrors the reference sentinel errors at reference codec/errors.go:6-18
(ErrCodecNotFound, ErrInvalidParameter, ErrInvalidQuality,
ErrUnsupportedFormat) as an exception hierarchy.
"""


class CodecError(Exception):
    """Base class for all codec errors."""


class CodecNotFoundError(CodecError, KeyError):
    """No codec registered for the requested transfer syntax UID."""


class InvalidParameterError(CodecError, ValueError):
    """A codec parameter has an invalid value."""


class InvalidQualityError(InvalidParameterError):
    """Quality parameter out of range."""


class UnsupportedFormatError(CodecError, ValueError):
    """The pixel format is not supported by this codec."""


class CorruptStreamError(CodecError, ValueError):
    """The compressed stream is malformed or truncated."""
