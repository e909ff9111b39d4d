"""Fluent builder for Part 2 multi-component-transform parameters.

Role of reference jpeg2000/mct_builder.go: a small chainable API that
assembles the custom-MCT fields consumed by J2KEncodeParams
(mct_matrix / mct_inverse / mct_offsets) and by the MCT/MCC/MCO marker
writers in codestream/j2k.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class MCTBinding:
    """Resolved binding parameters (reference MCTBindingParams)."""
    component_ids: List[int] = field(default_factory=list)
    matrix: Optional[List[List[float]]] = None
    inverse: Optional[List[List[float]]] = None
    offsets: Optional[List[float]] = None
    reversible: bool = False


class MCTBindingBuilder:
    """Chainable builder (reference NewMCTBinding mct_builder.go:3-28).

    >>> b = (MCTBindingBuilder().components([0, 1, 2])
    ...      .matrix(M).offsets([0.0, 0.0, 0.0]).build())
    """

    def __init__(self) -> None:
        self._b = MCTBinding()

    def components(self, ids: List[int]) -> "MCTBindingBuilder":
        self._b.component_ids = list(ids)
        return self

    def matrix(self, m) -> "MCTBindingBuilder":
        self._b.matrix = [list(map(float, row)) for row in m]
        return self

    def inverse(self, m) -> "MCTBindingBuilder":
        self._b.inverse = [list(map(float, row)) for row in m]
        return self

    def offsets(self, o) -> "MCTBindingBuilder":
        self._b.offsets = list(map(float, o))
        return self

    def reversible(self, flag: bool = True) -> "MCTBindingBuilder":
        self._b.reversible = flag
        return self

    def build(self) -> MCTBinding:
        b = self._b
        if b.matrix is not None:
            n = len(b.matrix)
            if any(len(row) != n for row in b.matrix):
                raise ValueError("MCT matrix must be square")
            if b.component_ids and len(b.component_ids) != n:
                raise ValueError("component count must match matrix size")
            if b.inverse is None:
                try:
                    b.inverse = np.linalg.inv(
                        np.asarray(b.matrix, dtype=np.float64)).tolist()
                except np.linalg.LinAlgError as e:
                    raise ValueError(
                        "MCT matrix is singular; provide inverse() "
                        "explicitly") from e
        return b

    def apply_to(self, params) -> "MCTBindingBuilder":
        """Copy the built binding onto a J2KEncodeParams-like object."""
        b = self.build()
        params.mct_matrix = b.matrix
        params.mct_inverse = b.inverse
        params.mct_offsets = b.offsets
        return self
