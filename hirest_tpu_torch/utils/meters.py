"""Small training-loop utilities (reference utils.py:40-56); an own copy
of hirest_tpu/utils/meters.py."""

from __future__ import annotations

from collections import deque


class LossMeter:
    """Windowed running average of scalar losses."""

    def __init__(self, maxlen: int = 100):
        self.vals = deque(maxlen=maxlen)

    def __len__(self) -> int:
        return len(self.vals)

    def update(self, new_val: float) -> None:
        self.vals.append(float(new_val))

    @property
    def val(self) -> float:
        if not self.vals:
            return 0.0
        return sum(self.vals) / len(self.vals)

    def __repr__(self) -> str:
        return str(round(self.val, 4))
