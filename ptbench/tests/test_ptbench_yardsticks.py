"""The benchmark's frozen counts and peaks equal the port's own yardstick
arithmetic today (a later change to the port's benches does not move the
benchmark's yardstick; this test says when they part)."""

from __future__ import annotations

import torch

from _util import ROOT  # noqa: F401

from ptbench import yardsticks as Y


def test_peaks():
    from pathtrace_tpu_torch.tools import _probe

    assert Y.FP32_FLOP_PER_S == _probe.FP32_FLOP_PER_S
    assert Y.HBM_BYTES_PER_S == _probe.HBM_BYTES_PER_S


def test_closest_hit_shade_and_backward_counts():
    from pathtrace_tpu_torch.tools import nearest_bench as nb

    assert (Y.K1_OPS_PAIR, Y.K3_OPS_PAIR) == (nb.OPS_PAIR, nb.OPS_PAIR_MOTION)
    assert (Y.K2_OPS_LANE, Y.K2_BYTES_LANE) == (nb.K2_OPS, nb.K2_BYTES)
    assert (Y.K6_OPS_RAY, Y.K6_BYTES_RAY) == (nb.K6_OPS, nb.K6_BYTES)
    soa = torch.zeros((5, 256))
    soa[4, :200] = 1.0
    R = 1000
    sticks = nb.yardsticks(soa, R)
    ops = R * 200 * Y.K1_OPS_PAIR
    assert sticks["bound_ms"] >= Y.bound_s(ops, 0) * 1e3 * 0.999


def test_box_media_counts():
    from pathtrace_tpu_torch.ops import box_media_kernel as bm

    assert (Y.BOX_OPS_PAIR, Y.MEDIUM_OPS_PAIR) == (bm.OPS_BOX, bm.OPS_MEDIUM)
    work = {"boxes": 400, "media": 2}
    R = 3_686_400
    st = bm.yardsticks(R, 400, 2)
    assert st["operations"] == R * Y.box_media_ops(work)
    records = 4 * (bm.BOX_W * 400 + bm.MEDIA_W * 2)
    assert st["bytes"] == R * Y.box_media_bytes(work) + records


def test_roofline_reads_nothing_without_time():
    assert Y.roofline_pct(1e9, 1e9, 0.0) is None
    assert Y.roofline_pct(67e12, 0, 2.0) == 50.0
