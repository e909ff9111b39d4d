"""Tag trees (ISO/IEC 15444-1 B.10.2; role of reference t2/tagtree.go).

Quad-tree of minima; Encode/Decode emit/consume the standard per-node
low/known bit pattern up to a threshold.
"""

from __future__ import annotations


class TagTree:
    def __init__(self, width: int, height: int) -> None:
        if width <= 0 or height <= 0:
            width = height = 1
        self.width = width
        self.height = height
        dims = []
        w, h = width, height
        while True:
            dims.append((w, h))
            if w == 1 and h == 1:
                break
            w = (w + 1) // 2
            h = (h + 1) // 2
        self.dims = dims  # level 0 = leaves … last = root (1×1)
        self.levels = len(dims)
        # root→leaf (lvl, idx) chains, precomputed once: encode/decode
        # walk a leaf's path on every packet-header bit and the
        # recomputation measured ~15% of HT-frame header decode
        self.paths = []
        for y in range(height):
            for x in range(width):
                px, py = x, y
                chain = []
                for lvl, (w, h) in enumerate(dims):
                    chain.append((lvl, py * w + px))
                    px //= 2
                    py //= 2
                chain.reverse()
                self.paths.append(chain)
        self.reset()

    def reset(self) -> None:
        self.value = [[999] * (w * h) for (w, h) in self.dims]
        self.low = [[0] * (w * h) for (w, h) in self.dims]
        self.known = [[False] * (w * h) for (w, h) in self.dims]

    def set_value(self, x: int, y: int, value: int) -> None:
        """Set a leaf and propagate the minimum upward."""
        px, py = x, y
        for lvl, (w, h) in enumerate(self.dims):
            idx = py * w + px
            if self.value[lvl][idx] > value:
                self.value[lvl][idx] = value
            else:
                break
            px //= 2
            py //= 2

    def encode(self, bw, x: int, y: int, threshold: int) -> None:
        low = 0
        for lvl, idx in self.paths[y * self.width + x]:
            if low > self.low[lvl][idx]:
                self.low[lvl][idx] = low
            else:
                low = self.low[lvl][idx]
            while low < threshold:
                if low >= self.value[lvl][idx]:
                    if not self.known[lvl][idx]:
                        bw.write_bit(1)
                        self.known[lvl][idx] = True
                    break
                bw.write_bit(0)
                low += 1
            self.low[lvl][idx] = low

    def decode(self, br, x: int, y: int, threshold: int) -> int:
        """Decode up to threshold; returns current node value knowledge."""
        low = 0
        for lvl, idx in self.paths[y * self.width + x]:
            if low > self.low[lvl][idx]:
                self.low[lvl][idx] = low
            else:
                low = self.low[lvl][idx]
            while low < threshold and low < self.value[lvl][idx]:
                if br.read_bit():
                    self.value[lvl][idx] = low
                else:
                    low += 1
            self.low[lvl][idx] = low
        leaf = self.value[0][y * self.width + x]
        return leaf
