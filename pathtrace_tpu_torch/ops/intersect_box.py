"""Closest hit over the transformed boxes and the constant-density media
of a scene, in plain PyTorch.

Counterpart of ``pathtrace_tpu/ops/intersect.py`` ``box_nearest_planes``
and ``media_nearest_planes`` (a Python loop over the primitives on [R]
planes, with each primitive's parameters as scalars). The reference
routes more than 16 of them to an [R, N] form (``box_nearest``,
``media_nearest``); the port keeps the plane loop for every count, since
both forms give the same winners: an ascending-``j`` running minimum with
a strict ``<`` is the first-minimum argmin. The reference sweeps boxes and
media in XLA, not in a Pallas kernel; here they are PyTorch element-wise
operations on the rays' planes, on any device.

Per box: the ray mapped to object space by ``obj_from_world``, the slab
test (a direction component below 1e-12 in magnitude is replaced by
+1e-12, small negatives included, as the reference does), and the entry
distance, or the exit distance for a ray that starts inside. Per medium:
the boundary interval (the slab, or the sphere of centre ``p0`` and
``radius``) clamped to [t_min, t_max] and then to t >= 0, and a hit at
the free-flight distance ``-ln(u) / density`` when it falls inside the
interval; ``u`` is the caller's uniform for that medium. Dead entries
never hit. A ray that hits nothing gets (``MAX_T``, 0).
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import MEDIUM_SPHERE, Boxes, Media

_INF = float(MAX_T)


def _slab(p0, p1, ofw, rox, roy, roz, rdx, rdy, rdz):
    """(t_enter, t_exit) [R] of the slab test in the object space that the
    3x4 affine ``ofw`` maps to, against the box [p0, p1]."""
    ro_o = [ofw[r, 0] * rox + ofw[r, 1] * roy + ofw[r, 2] * roz + ofw[r, 3]
            for r in range(3)]
    rd_o = [ofw[r, 0] * rdx + ofw[r, 1] * rdy + ofw[r, 2] * rdz
            for r in range(3)]
    tn = tf = None
    for r in range(3):
        d = torch.where(torch.abs(rd_o[r]) < 1e-12, 1e-12, rd_o[r])
        rcp = 1.0 / d
        d0 = (p0[r] - ro_o[r]) * rcp
        d1 = (p1[r] - ro_o[r]) * rcp
        lo = torch.minimum(d0, d1)
        hi = torch.maximum(d0, d1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def box_nearest(boxes: Boxes, rox, roy, roz, rdx, rdy, rdz,
                t_min: float = MIN_T, t_max: float = MAX_T):
    """Closest box per ray on [R] planes, one loop iteration per box:
    (t [R] f32, idx [R] int32). The entry face, or the exit face of a ray
    that starts inside."""
    R = rox.shape[0]
    tbest = torch.full((R,), _INF, dtype=rox.dtype, device=rox.device)
    ibest = torch.zeros((R,), dtype=torch.int32, device=rox.device)
    for j in range(boxes.count):
        tn, tf = _slab(boxes.p0[j], boxes.p1[j], boxes.obj_from_world[j],
                       rox, roy, roz, rdx, rdy, rdz)
        crosses = (tf > tn) & boxes.mask[j]
        enter_ok = crosses & (tn > t_min) & (tn < t_max)
        exit_ok = crosses & (tn <= t_min) & (tf > t_min) & (tf < t_max)
        cand = torch.where(enter_ok, tn, torch.where(exit_ok, tf, _INF))
        better = cand < tbest
        tbest = torch.where(better, cand, tbest)
        ibest = torch.where(better, j, ibest)
    return tbest, ibest


def media_nearest(media: Media, rox, roy, roz, rdx, rdy, rdz, uniforms,
                  t_min: float = MIN_T, t_max: float = MAX_T):
    """Closest free-flight hit per ray in the media, one loop iteration
    per medium: (t [R] f32, idx [R] int32). ``uniforms[j]`` is the [R]
    uniform of medium ``j`` (the rays' directions are unit vectors)."""
    R = rox.shape[0]
    tbest = torch.full((R,), _INF, dtype=rox.dtype, device=rox.device)
    ibest = torch.zeros((R,), dtype=torch.int32, device=rox.device)
    for j in range(media.count):
        p0 = media.p0[j]
        tn, tf = _slab(p0, media.p1[j], media.obj_from_world[j],
                       rox, roy, roz, rdx, rdy, rdz)
        box_crosses = tf > tn
        # the sphere boundary (centre in p0)
        ocx, ocy, ocz = rox - p0[0], roy - p0[1], roz - p0[2]
        a = rdx * rdx + rdy * rdy + rdz * rdz
        b = ocx * rdx + ocy * rdy + ocz * rdz
        c = (ocx * ocx + ocy * ocy + ocz * ocz
             - media.radius[j] * media.radius[j])
        disc = b * b - a * c
        sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
        t_enter_s = (-b - sq) / a
        t_exit_s = (-b + sq) / a

        is_sphere = media.kind[j] == MEDIUM_SPHERE
        t1 = torch.where(is_sphere, t_enter_s, tn)
        t2 = torch.where(is_sphere, t_exit_s, tf)
        crosses = (torch.where(is_sphere, disc > 0.0, box_crosses)
                   & media.mask[j])
        t1 = torch.clamp(t1, min=t_min)
        t2 = torch.clamp(t2, max=t_max)
        ok = crosses & (t1 < t2)
        t1 = torch.clamp(t1, min=0.0)
        hit_dist = (-torch.log(torch.clamp(uniforms[j], min=1e-38))
                    / media.density[j])
        inside = hit_dist < (t2 - t1)
        cand = torch.where(ok & inside, t1 + hit_dist, _INF)
        better = cand < tbest
        tbest = torch.where(better, cand, tbest)
        ibest = torch.where(better, j, ibest)
    return tbest, ibest
