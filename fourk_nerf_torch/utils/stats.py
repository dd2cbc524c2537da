"""Training statistics as moment triples (count, sum, sum of squares).

The port's form of the JAX package's ``utils/stats.py`` (after the
reference's ``training_stats`` collector, frozoul/4K-NeRF
torch_utils/training_stats.py:56-266). :meth:`Collector.report` keeps the
triples on the device where the step made them and adds them there, so a
training loop that reports every step never waits for the card; only
:meth:`Collector.mean` and :meth:`Collector.as_dict`, called at a print
interval, read them back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def moments(x) -> torch.Tensor:
    """``[count, sum, sum_sq]`` of a tensor, float32, on its device (the
    count is a fill, not a copy from the host, which would wait for the
    device)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    count = torch.full((), float(x.numel()), device=x.device)
    return torch.stack([count, x.sum(), (x * x).sum()])


@dataclasses.dataclass
class Stat:
    num: float = 0.0
    total: float = 0.0
    total_sq: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / max(self.num, 1e-8)

    @property
    def std(self) -> float:
        if self.num <= 1:
            return 0.0
        var = self.total_sq / self.num - self.mean ** 2
        return float(np.sqrt(max(var, 0.0)))


class Collector:
    """Moment triples by metric name, summed between :meth:`reset` calls."""

    def __init__(self):
        self._sums: dict[str, torch.Tensor] = {}

    def report(self, name: str, m) -> None:
        m = torch.as_tensor(m).to(torch.float64)
        s = self._sums.get(name)
        self._sums[name] = m if s is None else s + m

    def report_scalar(self, name: str, value: float) -> None:
        v = float(value)
        self.report(name, [1.0, v, v * v])

    def as_dict(self) -> dict[str, Stat]:
        return {k: Stat(*v.cpu().tolist()) for k, v in self._sums.items()}

    def mean(self, name: str, default: float = float("nan")) -> float:
        if name not in self._sums:
            return default
        return Stat(*self._sums[name].cpu().tolist()).mean

    def reset(self) -> None:
        self._sums.clear()
