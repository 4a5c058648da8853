"""What the probes (``bf16_probe``, ``split_probe``) and ``nearest_bench``
share: the card's published peaks, their clocks and the device line they
print."""

from __future__ import annotations

import itertools
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

# the H100 SXM's published peaks at 700 W, the one copy of them in the
# port: HBM3 and float32 on the CUDA cores from NVIDIA's data sheet, packed
# bf16 on the CUDA cores (not the tensor cores) from the Hopper white paper
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 133.8e12
# thread-instructions a second: 132 SMs x 4 sub-partitions x 32 lanes at
# 1.98 GHz, half the fp32 peak (which counts an FMA as two operations)
ISSUE_PER_S = FP32_FLOP_PER_S / 2
L2_BYTES = 50e6  # the H100's L2 cache


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


def cold_copies(first, nbytes: int, clone: Callable) -> List:
    """``first`` and enough ``clone(first)`` copies that no launch of a
    rotation over them finds its input in L2: at least 3, and at least 6
    L2 caches (300 MB) of ``nbytes`` each in all."""
    n = max(3, math.ceil(6 * L2_BYTES / max(nbytes, 1)))
    return [first] + [clone(first) for _ in range(n - 1)]


def _spread(samples: Sequence[float]) -> List[float]:
    return [min(samples), statistics.median(samples), max(samples)]


def alternated_cold_ms(kernel: Callable, library: Optional[Callable],
                       copies: Sequence, rounds: int = 5,
                       reps: int = 20) -> dict:
    """A kernel against its yardstick, timed in turns on cold inputs.

    Each round takes samples in the order kernel, library, library,
    kernel; a sample is :func:`event_ms` of ``reps`` launches queued behind
    the device-side sleep. Consecutive launches, the kernel's and the
    library's alike, take the next of ``copies`` (:func:`cold_copies`), so
    none finds its input in L2. Returns ``kernel_cold_ms`` and
    ``library_cold_ms`` as [min, median, max] over the samples, and
    ``kernel_over_library``, the ratio of the medians; without a
    ``library`` (None) the kernel alone is timed and the other two are
    None."""
    turn = itertools.count()

    def rotating(fn):
        return lambda: fn(copies[next(turn) % len(copies)])

    order = ((kernel, library, library, kernel) if library is not None
             else (kernel, kernel))
    samples = {kernel: [], library: []}
    for _ in range(rounds):
        for fn in order:
            samples[fn].append(event_ms(rotating(fn), reps))
    k_ms = _spread(samples[kernel])
    if library is None:
        return {"kernel_cold_ms": k_ms, "library_cold_ms": None,
                "kernel_over_library": None}
    l_ms = _spread(samples[library])
    return {"kernel_cold_ms": k_ms, "library_cold_ms": l_ms,
            "kernel_over_library": k_ms[1] / l_ms[1]}
