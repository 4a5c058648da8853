"""Closest hit over the axis-aligned rects of a scene, in plain PyTorch.

Counterpart of ``pathtrace_tpu/ops/intersect.py`` ``rect_nearest_planes``
(a Python loop over the rects on [R] planes). The reference routes more
than 16 rects to an [R, N] form (``rect_nearest_cols``,
``pathtrace_tpu/ops/fastpath.py:342``); the port keeps the plane loop for
every count up to the fast path's 128, since no scene it renders has more
than 16 rects and both forms give the same winners. The reference sweeps
rects in XLA, not in a Pallas kernel; here they are PyTorch element-wise
operations on the rays' planes, on any device, and differentiable in the
rays under autograd.

Per rect: the plane crossing ``t = (k - o_n) / d_n`` (``d_n`` kept at
least 1e-12 from zero, which keeps the division finite for reverse-mode
autograd), a hit when ``t_min < t < t_max`` and the crossing lies in the
closed [a0, a1] x [b0, b1] interval of the in-plane axes. Dead rects never
hit. The winner is the first minimum (ties go to the lower index); a ray
that hits nothing gets (``MAX_T``, 0).
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import Rects

_INF = float(MAX_T)
RECT_ROWS = 128  # rows of a winner table's rect block: at most 128 rects


def rect_nearest(rects: Rects, rox, roy, roz, rdx, rdy, rdz,
                 t_min: float = MIN_T, t_max: float = MAX_T):
    """Closest rect per ray on [R] planes, one loop iteration per rect:
    (t [R] f32, idx [R] int32)."""
    R = rox.shape[0]
    tbest = torch.full((R,), _INF, dtype=rox.dtype, device=rox.device)
    ibest = torch.zeros((R,), dtype=torch.int32, device=rox.device)
    for j in range(rects.count):
        axis = rects.axis[j]
        o_n = torch.where(axis == 0, rox, torch.where(axis == 1, roy, roz))
        d_n = torch.where(axis == 0, rdx, torch.where(axis == 1, rdy, rdz))
        o_a = torch.where(axis == 0, roy, rox)
        d_a = torch.where(axis == 0, rdy, rdx)
        o_b = torch.where(axis == 2, roy, roz)
        d_b = torch.where(axis == 2, rdy, rdz)
        d_n = torch.where(torch.abs(d_n) < 1e-12, 1e-12, d_n)
        t = (rects.k[j] - o_n) / d_n
        pa = o_a + t * d_a
        pb = o_b + t * d_b
        ok = (rects.mask[j] & (t > t_min) & (t < t_max)
              & (pa >= rects.a0[j]) & (pa <= rects.a1[j])
              & (pb >= rects.b0[j]) & (pb <= rects.b1[j]))
        cand = torch.where(ok, t, _INF)
        better = cand < tbest
        tbest = torch.where(better, cand, tbest)
        ibest = torch.where(better, j, ibest)
    return tbest, ibest


def merge_winner(t: torch.Tensor, idx: torch.Tensor, t_k: torch.Tensor,
                 i_k: torch.Tensor, row0: int):
    """Merge a kind's winner (t_k, i_k) into the running winner (t, idx):
    it wins only when strictly nearer (the earlier kinds keep ties) and
    takes row ``row0 + i_k`` of the winner table, ``row0`` being the first
    row of its kind's block (see ``fastpath.table_rows``)."""
    wins = t_k < t
    return torch.where(wins, t_k, t), torch.where(wins, i_k + row0, idx)


def merge_rects(rects: Rects, rays, t: torch.Tensor, idx: torch.Tensor,
                row0: int):
    """Sweep the rects along ``rays`` (six [R] planes: ro xyz, rd xyz) and
    merge their winner into (t, idx) with :func:`merge_winner`, the rect
    block starting at row ``row0``. Returns the merged (t, idx)."""
    return merge_winner(t, idx, *rect_nearest(rects, *rays), row0)
