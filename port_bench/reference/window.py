"""Window algebra of the tiled stage tensors: frozen copy of the port's
``runtime/window.py``.

``TensorWindow(size, stride, offset)`` places window index ``idx`` over the
half-open box ``[offset + idx*stride, offset + idx*stride + size)`` per
dimension.  Coordinates are integers and may be negative.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class TensorWindow:
    size: tuple
    stride: tuple
    offset: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "size", tuple(int(s) for s in self.size))
        object.__setattr__(self, "stride", tuple(int(s) for s in self.stride))
        off = self.offset if self.offset is not None else (0,) * len(self.size)
        object.__setattr__(self, "offset", tuple(int(o) for o in off))
        if not len(self.size) == len(self.stride) == len(self.offset):
            raise ValueError("size, stride and offset need one entry per dim")

    @property
    def ndim(self) -> int:
        return len(self.size)

    def box(self, idx: Sequence[int]) -> tuple:
        """((start, stop), ...) box covered by window `idx`."""
        return tuple((self.offset[d] + idx[d] * self.stride[d],
                      self.offset[d] + idx[d] * self.stride[d] + self.size[d])
                     for d in range(self.ndim))

    def index_range(self, ranges: Sequence[tuple]) -> tuple:
        """Per-dim inclusive (lo, hi) window-index range overlapping `ranges`:
        window i overlaps [a, b) iff offset + i*stride < b and
        offset + i*stride + size > a."""
        out = []
        for d, (a, b) in enumerate(ranges):
            st, sz, off = self.stride[d], self.size[d], self.offset[d]
            out.append(((a - off - sz) // st + 1, (b - off - 1) // st))
        return tuple(out)

    def windows_overlapping(self, ranges: Sequence[tuple]) -> Iterator[tuple]:
        """All window indices whose boxes intersect the given region."""
        return itertools.product(*(range(lo, hi + 1)
                                   for lo, hi in self.index_range(ranges)))
