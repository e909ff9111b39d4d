"""Codec parameter model.

Mirrors the external ``codec.Parameters`` contract consumed by the reference
adapters: string-keyed GetParameter/SetParameter plus Validate
(reference jpeg/baseline/parameters.go:33-62), and the fluent ``With*``
builders of typed parameter objects
(reference jpeg2000/lossless/parameters.go:79-246).

Here a single dict-backed ``Parameters`` class serves both roles; typed
codec-specific subclasses add validated properties and ``with_*`` builders.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

from .errors import InvalidParameterError


class Parameters:
    """String-keyed parameter bag with validation hooks."""

    def __init__(self, **kwargs: Any) -> None:
        self._values: Dict[str, Any] = {}
        for k, v in kwargs.items():
            self.set_parameter(k, v)

    # -- reference codec.Parameters surface ------------------------------
    def get_parameter(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def set_parameter(self, key: str, value: Any) -> "Parameters":
        self._values[key] = value
        return self

    def has_parameter(self, key: str) -> bool:
        return key in self._values

    def validate(self) -> None:
        """Subclasses override to range-check typed fields."""

    # -- pythonic conveniences -------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def copy(self) -> "Parameters":
        p = type(self).__new__(type(self))
        p._values = dict(self._values)
        return p

    def with_(self, key: str, value: Any) -> "Parameters":
        """Fluent builder: returns an updated copy (reference With* pattern)."""
        p = self.copy()
        p.set_parameter(key, value)
        return p

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self._values!r})"


def require_range(name: str, value: int, lo: int, hi: int) -> int:
    if not (lo <= value <= hi):
        raise InvalidParameterError(f"{name}={value} out of range [{lo}, {hi}]")
    return value


def optional_int(params: Optional[Parameters], key: str, default: int) -> int:
    if params is None:
        return default
    v = params.get_parameter(key, default)
    if v is None:
        return default
    return int(v)
