"""The yardstick: the card's published peaks and each kernel's frozen
counts of work, applied to what the window did.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3. A
card set below 700 W runs slower; every run records the card's name.

Counts (fp32 operations and bytes, counted from the renderer's plain
versions as its own benches count them, frozen here):

- closest hit K1: 16 operations a (segment, live static sphere) pair, 38
  a pair with a moving sphere (K3); 32 bytes a segment (the ray in, t and
  idx out);
- fused shade K2: ~300 operations and 114 bytes a lane (12 state planes,
  time, alive, lane, t and idx in; 12 planes and alive out);
- box and media sweep: 84 operations a (segment, box) pair, 114 a
  (segment, medium) pair; 24 bytes a segment of ray in, 4 a (segment,
  medium) flight in, 8 out per kind;
- closest-hit backward K6: 60 bytes and ~60 operations a ray a launch.
"""

from __future__ import annotations

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

K1_OPS_PAIR, K3_OPS_PAIR, K1_BYTES_RAY = 16, 38, 32
K2_OPS_LANE, K2_BYTES_LANE = 300, 114
BOX_OPS_PAIR, MEDIUM_OPS_PAIR = 84, 114
K6_OPS_RAY, K6_BYTES_RAY = 60, 60


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM bandwidth."""
    return max(ops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_pct(ops: float, nbytes: float, seconds: float):
    """A kernel's share of its roofline, in per cent; None where the
    trace holds no time for it (nothing to read)."""
    if seconds <= 0.0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * bound_s(ops, nbytes) / seconds


def sphere_ops(work: dict) -> int:
    """fp32 operations a segment needs over the live spheres."""
    static = work["spheres"] - work["moving_spheres"]
    return K1_OPS_PAIR * static + K3_OPS_PAIR * work["moving_spheres"]


def box_media_ops(work: dict) -> int:
    return BOX_OPS_PAIR * work["boxes"] + MEDIUM_OPS_PAIR * work["media"]


def box_media_bytes(work: dict) -> int:
    kinds = (work["boxes"] > 0) + (work["media"] > 0)
    return 24 + 4 * work["media"] + 8 * kinds


def train_lanes(ctx) -> int:
    """Lanes the differentiable trace sweeps in the traced steps: every
    lane of the film at each of its ``max_depth + 1`` bounces (the trace
    has no compaction)."""
    w = ctx.work
    return ctx.units * (w["max_depth"] + 1) * w["lanes"]
