"""What the two probes (``bf16_probe``, ``split_probe``) share: the card's
published peaks, their two clocks and the device line they print."""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Optional

import torch

# the H100 SXM5's published peaks at 700 W (NVIDIA's Hopper white paper:
# float32 and packed bf16 on the CUDA cores, not the tensor cores; HBM3)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 66.9e12
BF16_FLOP_PER_S = 133.8e12


def probe_device(name: str, prog: str) -> Optional[torch.device]:
    """The device asked for, or None (after a message on stderr) when it
    is a CUDA device and there is none: a probe never drops to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: torch.cuda.is_available() is False (pass --device "
              "cpu for the plain versions)", file=sys.stderr)
        return None
    return dev


def device_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit on a card; "cpu" otherwise."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def best_wall_ms(fn: Callable[[int], object], repeats: int = 4) -> float:
    """The reference probes' clock: host wall time of ``fn(i)`` (which
    ends in a readback), best of ``i`` = 1..``repeats`` after ``fn(0)``."""
    fn(0)
    best = float("inf")
    for i in range(1, repeats + 1):
        t0 = time.perf_counter()
        fn(i)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def event_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up,
    from CUDA events. The runs are queued behind a device-side sleep, so
    the events time the device's work back to back and not the host's
    launch cost (a kernel of ~0.04 ms launches slower than it runs). The
    sleep grows until the host has queued every run before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("event_ms: the host could not queue the runs ahead of "
                       "the device (does fn synchronise?)")
