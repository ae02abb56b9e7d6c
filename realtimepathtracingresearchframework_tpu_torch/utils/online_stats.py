"""Online (Welford) statistics with EMA.

Equivalent of ``util/online_stats.h:10-57`` used by the benchmark harness
(libapp/benchmark_info.cpp).
"""

from __future__ import annotations

import math


class OnlineStats:
    """Numerically stable streaming mean/variance/min/max + EMA."""

    def __init__(self, ema_alpha: float = 0.1):
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.minimum = math.inf
        self.maximum = -math.inf
        self.ema = 0.0
        self._ema_alpha = ema_alpha

    def add(self, x: float) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        self.minimum = min(self.minimum, x)
        self.maximum = max(self.maximum, x)
        if self.count == 1:
            self.ema = x
        else:
            self.ema += self._ema_alpha * (x - self.ema)

    @property
    def variance(self) -> float:
        if self.count < 2:
            return 0.0
        return self._m2 / (self.count - 1)

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)

    def reset(self) -> None:
        self.__init__(self._ema_alpha)
