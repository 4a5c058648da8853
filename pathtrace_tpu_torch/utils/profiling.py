"""Throughput instrumentation: Mrays/s counters and rolling averages
(counterpart of ``pathtrace_tpu/utils/profiling.py``; plain Python).

Analog of the reference's atomic ray counter and Mrays/s prints. Ray
counts come from the renderers' segment counts; this module adds the
wall-clock bookkeeping and the rolling window of the progressive loop
(``render/progressive.py`` logs the meter's line every 10 frames).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class RenderStats:
    elapsed_secs: float
    ray_count: int

    @property
    def mrays_per_sec(self) -> float:
        return self.ray_count / 1.0e6 / max(self.elapsed_secs, 1e-12)

    def summary(self) -> str:
        # the shape of the offline report line
        return (f"{self.elapsed_secs:.2f}secs {self.ray_count}rays "
                f"{self.mrays_per_sec:.2f}Mrays/s")


@dataclass
class RollingMraysMeter:
    """Rolling Mrays/s every ``report_every_frames`` frames or
    ``report_every_secs`` seconds, whichever comes first."""

    report_every_frames: int = 10
    report_every_secs: float = 10.0
    _window_start: float = field(default_factory=time.monotonic)
    _window_rays: int = 0
    _window_frames: int = 0
    _total_frames: int = 0
    reports: List[str] = field(default_factory=list)

    def add_frame(self, ray_count: int) -> Optional[str]:
        """Record a frame; returns a report line when the window closes."""
        self._window_rays += ray_count
        self._window_frames += 1
        self._total_frames += 1
        elapsed = time.monotonic() - self._window_start
        if (self._window_frames >= self.report_every_frames
                or elapsed >= self.report_every_secs):
            mrays_s = self._window_rays / 1.0e6 / max(elapsed, 1e-12)
            mrays_f = self._window_rays / 1.0e6 / self._window_frames
            line = (f"{mrays_s:.2f}Mrays/s {mrays_f:.2f}Mrays/frame "
                    f"{self._total_frames}frames")
            self.reports.append(line)
            self._window_start = time.monotonic()
            self._window_rays = 0
            self._window_frames = 0
            return line
        return None


class Timer:
    """Wall-clock ``with`` block: ``elapsed`` seconds after it exits."""

    def __enter__(self):
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.monotonic() - self.start
        return False
