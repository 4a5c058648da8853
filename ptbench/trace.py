"""The traced window: ``torch.profiler`` over the window, reduced to what
the per-layer metrics read.

Device intervals are the card's operations (kernels, copies, fills) by
name. ``busy_s`` is the length of their union inside the window,
``window_s`` the window's length on the host's clock (the profiler's
timestamps are on the same clock), so the idle share is ``1 - busy_s /
window_s``. The metrics' window records the card's activity alone:
recording every host operator as well doubles a short frame's host time
and with it the idle share. A second, short window records the host's
operators too, only to name each idle gap by the innermost host event open
when it began: an operator of the program, or one of the benchmark's spans
(``ptbench.frame``, ``ptbench.step``) where the host was between operators.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

SPAN_PREFIX = "ptbench."


class TraceSummary:
    def __init__(self, device: List[Tuple[int, int, str]],
                 host: List[Tuple[int, int, str]], window: Tuple[int, int]):
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        self.device = [(max(a, w0), min(b, w1), n) for a, b, n in device
                       if b > w0 and a < w1]
        self.host = host
        merged = []
        for a, b, _ in sorted(self.device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-9
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        self.launches = len(self.device)
        self.by_name: Dict[str, List[float]] = {}
        for a, b, n in self.device:
            s = self.by_name.setdefault(n, [0.0, 0])
            s[0] += (b - a) * 1e-9
            s[1] += 1

    def kernel_s(self, *fragments: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        any of ``fragments``."""
        sec, count = 0.0, 0
        for name, (s, c) in self.by_name.items():
            if any(f in name for f in fragments):
                sec += s
                count += c
        return sec, count

    def _host_at(self, t: int) -> str:
        """The innermost host event open at time ``t``."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best = None
        for a, b, n in reversed(self.host[max(0, i - 4000):i]):
            if b >= t and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "host outside any operator"

    def device_ops(self) -> list:
        """The ten device operations that took most time: [name, s]."""
        ops = sorted(((n, s) for n, (s, _) in self.by_name.items()),
                     key=lambda x: -x[1])[:10]
        return [[n[:160], s] for n, s in ops]

    def idle_gaps(self) -> list:
        """The ten longest idle gaps, by the host event open at each."""
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]
        return [[self._host_at(a)[:160], (b - a) * 1e-9] for a, b in gaps]


def _events(prof):
    """(device operations, host events): lists of (start_ns, end_ns,
    name), the host's sorted by start."""
    device, host = [], []
    # kineto's raw events: far cheaper to read than the profiler's
    # function-event tree for a window of a million operations
    for e in prof.profiler.kineto_results.events():
        a, b, n = e.start_ns(), e.end_ns(), e.name()
        if not str(e.device_type()).endswith("CUDA"):
            host.append((a, b, n))
        elif not (e.is_user_annotation() or n.startswith(SPAN_PREFIX)):
            device.append((a, b, n))  # not a span's shadow on the device
    host.sort()
    return device, host


def profiled(fn, dev, host_ops: bool = False):
    """Run ``fn`` under the profiler, the card's activity recorded, and
    with ``host_ops`` the host's operators too: (its result, the
    :class:`TraceSummary`)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if dev.cuda else []
    if host_ops or not acts:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        result = fn()
        dev.sync()
        t1 = time.time_ns()
    device, host = _events(prof)
    return result, TraceSummary(device, host, (t0, t1))
