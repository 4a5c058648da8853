"""Closest hit over the transformed boxes and the constant-density media
of a scene, in plain PyTorch.

Counterpart of ``pathtrace_tpu/ops/intersect.py`` ``box_nearest_planes``
and ``media_nearest_planes`` (:func:`box_nearest`, :func:`media_nearest`:
a Python loop over the primitives on [R] planes, with each primitive's
parameters as scalars) and of its [R, N] forms ``box_nearest`` and
``media_nearest`` (:func:`box_nearest_rn`, :func:`media_nearest_rn`: the
rays in chunks of ``RN_PAIRS`` (ray, primitive) pairs, every primitive at
once on [Rc, N]). The two forms compute each pair in the same operations
in the same order and pick the same winner (an ascending-``j`` running
minimum with a strict ``<`` is ``torch.argmin``'s first minimum), so they
give the same (t, idx) bit for bit; the [R, N] form only launches fewer,
larger operations. The [R, N] form is the plain version of the box and
media kernel (:mod:`~pathtrace_tpu_torch.ops.box_media_kernel`,
``csrc/box_media_nearest.cu``), which the port's sweeps take: on the CPU
that module runs this form, on the card the kernel, with the same bits.
Its per-pair candidates (:func:`box_candidate`, :func:`media_candidate`)
broadcast, so that module recomputes a winner's t under autograd with
them too. The loop stays as their bit-for-bit reference. The reference sweeps
boxes and media in XLA, not in a Pallas kernel; here they are PyTorch
element-wise operations, on any device, and autograd flows through both
forms (the [R, N] form's t is a gather at the argmin).

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

# (ray, primitive) pairs a chunk of the [R, N] forms: each [Rc, N] float
# temporary takes 4 * RN_PAIRS bytes (32 MiB) and ~12 are live at the
# peak, ~400 MiB whatever R and N (400 boxes: 20,971 rays a chunk)
RN_PAIRS = 1 << 23


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


# ---------------------------------------------------------------------------
# the [R, N] forms
# ---------------------------------------------------------------------------

def _rn_chunks(R: int, n: int):
    step = max(1, RN_PAIRS // max(n, 1))
    return [(lo, min(lo + step, R)) for lo in range(0, R, step)]


def _slab_rn(p0, p1, ofw, ro, rd):
    """:func:`_slab`, broadcasting: the rays' planes ``ro``, ``rd`` (three
    each) against primitives whose ``p0``, ``p1`` [..., 3] and ``ofw``
    [..., 3, 4] broadcast with them, as every primitive at once ([Rc, 1]
    rays, [N] primitives: [Rc, N]) or each ray's own primitive ([R] and
    [R]): (t_enter, t_exit), each pair in :func:`_slab`'s operations and
    order (one axis at a time, so fewer temporaries are live)."""
    tn = tf = None
    for r in range(3):
        m = ofw[..., r, :]
        ro_o = m[..., 0] * ro[0] + m[..., 1] * ro[1] + m[..., 2] * ro[2] \
            + m[..., 3]
        rd_o = m[..., 0] * rd[0] + m[..., 1] * rd[1] + m[..., 2] * rd[2]
        d = torch.where(torch.abs(rd_o) < 1e-12, 1e-12, rd_o)
        rcp = 1.0 / d
        d0 = (p0[..., r] - ro_o) * rcp
        d1 = (p1[..., r] - ro_o) * rcp
        lo = torch.minimum(d0, d1)
        hi = torch.maximum(d0, d1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def box_candidate(p0, p1, ofw, mask, ro, rd, t_min: float = MIN_T,
                  t_max: float = MAX_T):
    """The [R, N] form's candidate t of each (ray, box) pair, broadcasting
    as :func:`_slab_rn` (``mask`` as ``p0[..., 0]``): the entry face, the
    exit face of a ray that starts inside, else ``MAX_T``."""
    tn, tf = _slab_rn(p0, p1, ofw, ro, rd)
    crosses = (tf > tn) & mask
    enter_ok = crosses & (tn > t_min) & (tn < t_max)
    exit_ok = crosses & (tn <= t_min) & (tf > t_min) & (tf < t_max)
    return torch.where(enter_ok, tn, torch.where(exit_ok, tf, _INF))


def media_candidate(p0, p1, ofw, r2, is_sphere, mask, density, ro, rd, u,
                    t_min: float = MIN_T, t_max: float = MAX_T):
    """The [R, N] form's candidate t of each (ray, medium) pair,
    broadcasting as :func:`_slab_rn` (the squared radius ``r2``,
    ``is_sphere``, ``mask`` and ``density`` as ``p0[..., 0]``; ``u`` the
    pair's uniform): the free-flight hit inside the boundary interval,
    else ``MAX_T``."""
    tn, tf = _slab_rn(p0, p1, ofw, ro, rd)
    box_crosses = tf > tn
    ocx, ocy, ocz = (ro[k] - p0[..., k] for k in range(3))
    a = rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]
    b = ocx * rd[0] + ocy * rd[1] + ocz * rd[2]
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    del ocx, ocy, ocz
    disc = b * b - a * c
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    t1 = torch.where(is_sphere, (-b - sq) / a, tn)
    t2 = torch.where(is_sphere, (-b + sq) / a, tf)
    crosses = torch.where(is_sphere, disc > 0.0, box_crosses) & mask
    t1 = torch.clamp(t1, min=t_min)
    t2 = torch.clamp(t2, max=t_max)
    ok = crosses & (t1 < t2)
    t1 = torch.clamp(t1, min=0.0)
    hit_dist = -torch.log(torch.clamp(u, min=1e-38)) / density
    inside = hit_dist < (t2 - t1)
    return torch.where(ok & inside, t1 + hit_dist, _INF)


def _first_min(cand: torch.Tensor):
    """(t [Rc], idx [Rc] int32) of the first minimum of each row."""
    idx = torch.argmin(cand, dim=1)
    return cand.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def _cat(parts, R: int, like: torch.Tensor):
    if not parts:
        return (torch.full((R,), _INF, dtype=like.dtype, device=like.device),
                torch.zeros((R,), dtype=torch.int32, device=like.device))
    ts, idxs = zip(*parts)
    return torch.cat(ts), torch.cat(idxs)


def _chunk(planes, lo: int, hi: int):
    """Rays ``lo:hi`` of three planes, as [Rc, 1] columns."""
    return tuple(x[lo:hi, None] for x in planes)


def box_nearest_rn(boxes: Boxes, rox, roy, roz, rdx, rdy, rdz,
                   t_min: float = MIN_T, t_max: float = MAX_T):
    """:func:`box_nearest` on [Rc, N] (the reference's ``box_nearest``):
    the same (t [R] f32, idx [R] int32) bit for bit."""
    R, N = rox.shape[0], boxes.count
    parts = []
    for lo, hi in _rn_chunks(R, N):
        parts.append(_first_min(box_candidate(
            boxes.p0, boxes.p1, boxes.obj_from_world, boxes.mask,
            _chunk((rox, roy, roz), lo, hi), _chunk((rdx, rdy, rdz), lo, hi),
            t_min, t_max)))
    return _cat(parts, R, rox)


def media_nearest_rn(media: Media, rox, roy, roz, rdx, rdy, rdz, uniforms,
                     t_min: float = MIN_T, t_max: float = MAX_T):
    """:func:`media_nearest` on [Rc, N] (the reference's
    ``media_nearest``): the same (t [R] f32, idx [R] int32) bit for bit.
    ``uniforms[j]`` is medium ``j``'s [R] uniform, as the loop takes
    them."""
    R, N = rox.shape[0], media.count
    r2 = media.radius * media.radius
    is_sphere = media.kind == MEDIUM_SPHERE
    parts = []
    for lo, hi in _rn_chunks(R, N):
        u = torch.stack([uniforms[j][lo:hi] for j in range(N)], dim=1)
        parts.append(_first_min(media_candidate(
            media.p0, media.p1, media.obj_from_world, r2, is_sphere,
            media.mask, media.density, _chunk((rox, roy, roz), lo, hi),
            _chunk((rdx, rdy, rdz), lo, hi), u, t_min, t_max)))
    return _cat(parts, R, rox)
