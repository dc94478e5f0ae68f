"""Temperature schedulers for Gumbel-family prompt models.

Copy of ``summer_clip_tpu/methods/temp_schedulers.py`` (no JAX in it).

Rebuild of ``summer_clip/clip_prompt/temp_schedulers.py``: host-side
stateful schedulers whose current value feeds each train step as a scalar.
"""

from __future__ import annotations

__all__ = ["Scheduler", "ConstantScheduler", "LinearScheduler"]


class Scheduler:
    def get_val(self) -> float:
        raise NotImplementedError

    def step(self) -> None:
        pass


class ConstantScheduler(Scheduler):
    def __init__(self, value: float):
        self.value = float(value)

    def get_val(self) -> float:
        return self.value


class LinearScheduler(Scheduler):
    """Linear anneal from ``start`` to ``end`` over ``steps_num`` steps."""

    def __init__(self, start: float, end: float, steps_num: int):
        self.start = float(start)
        self.end = float(end)
        self.steps_num = int(steps_num)
        self._step = 0

    def get_val(self) -> float:
        frac = min(self._step / max(self.steps_num, 1), 1.0)
        return self.start + (self.end - self.start) * frac

    def step(self) -> None:
        self._step += 1
