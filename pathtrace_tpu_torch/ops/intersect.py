"""Closest hit over a whole scene, with full hit records, in [R, 3] form
(counterpart of ``pathtrace_tpu/ops/intersect.py``): the general
integrator's intersector.

Each primitive kind gives a winner (t, idx) per ray; the kinds merge in
the reference's order (spheres, rects, boxes, media), a later kind
winning only when strictly nearer, and each winner's record (point,
normal, UV, material) is built by gathers from its index.

- World-space spheres take the port's closest-hit kernels: K1
  (:func:`~pathtrace_tpu_torch.ops.intersect_kernel.sphere_nearest`), or
  K3 (``sphere_nearest_moving``) in a scene with moving spheres, on the
  operand of ``fastpath.build_sphere_soa``; their plain versions on the
  CPU. Under autograd they go through
  :class:`~pathtrace_tpu_torch.ops.intersect_kernel.SphereNearest`, whose
  backward is K6.
- Instanced spheres and rects (per-primitive affine pairs) take the
  plain object-space branch, as the reference does: the rays map into
  each primitive's object space, where the sphere's full quadratic or the
  rect's plane test runs ([R, N] in ray chunks). t is the same in both
  frames, so their winners merge with the world-space kinds'. Normals
  map back by the inverse transpose; UV stays in object space.
- World-space rects, boxes and media take the plane-loop sweeps of
  :mod:`~pathtrace_tpu_torch.ops.intersect_rect` and
  :mod:`~pathtrace_tpu_torch.ops.intersect_box`, which give the
  reference's [R, N] winners (ascending-index running minimum with a
  strict ``<`` is the first-minimum argmin). A medium's free flight
  takes the caller's [R, n_media] uniforms.

A miss has t = MAX_T; its record's point is the ray origin (t taken as 0,
which keeps every miss lane finite for reverse mode).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import (
    Boxes,
    Media,
    Rects,
    Scene,
    SceneFeatures,
    Spheres,
)
from pathtrace_tpu_torch.ops import intersect_kernel as ik
from pathtrace_tpu_torch.ops.intersect_box import box_nearest, media_nearest
from pathtrace_tpu_torch.ops.intersect_rect import rect_nearest

_INF = float(MAX_T)
_PI = 3.14159265358979
_HALF_PI = 1.5707963267948966
_INV_PI = 1.0 / _PI
_INV_2PI = 0.5 / _PI

# (ray, primitive) pairs per chunk of the [R, N] object-space sweeps
PAIRS_PER_CHUNK = 1 << 22


class HitRecord(NamedTuple):
    t: torch.Tensor        # [R] f32, MAX_T on a miss
    point: torch.Tensor    # [R, 3]
    normal: torch.Tensor   # [R, 3]
    u: torch.Tensor        # [R]
    v: torch.Tensor        # [R]
    mat_id: torch.Tensor   # [R] int64
    hit: torch.Tensor      # [R] bool


def _planes(ro: torch.Tensor, rd: torch.Tensor):
    return (ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2])


def _chunks(R: int, n: int):
    step = max(1, PAIRS_PER_CHUNK // max(n, 1))
    return [(lo, min(lo + step, R)) for lo in range(0, R, step)]


def _to_object(ofw: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor):
    """Rays [r, 3] in each primitive's object space: [r, N, 3] each."""
    lin, trans = ofw[:, :, :3], ofw[:, :, 3]
    ro_o = torch.einsum("nij,rj->rni", lin, ro) + trans[None]
    rd_o = torch.einsum("nij,rj->rni", lin, rd)
    return ro_o, rd_o


# ---------------------------------------------------------------------------
# spheres
# ---------------------------------------------------------------------------

def sphere_nearest_instanced(spheres: Spheres, ro, rd, time,
                             has_motion: bool, t_min: float = MIN_T,
                             t_max: float = MAX_T):
    """Closest instanced sphere per ray, in object space: the full
    quadratic ``a t^2 + 2 b t + c`` of the object-space ray against the
    (time-lerped) centre, the near root if it lies in (t_min, t_max),
    else the far one. (t [R], idx [R] int64)."""
    R, N = ro.shape[0], spheres.count
    ts, idxs = [], []
    for lo, hi in _chunks(R, N):
        ro_o, rd_o = _to_object(spheres.obj_from_world, ro[lo:hi], rd[lo:hi])
        c = spheres.center[None]
        if has_motion:
            s = ((time[lo:hi, None] - spheres.time0[None])
                 * spheres.inv_time_delta[None])
            c = c + s[..., None] * spheres.center_delta[None]
        oc = ro_o - c
        a = (rd_o * rd_o).sum(-1)
        b = (oc * rd_o).sum(-1)
        cterm = (oc * oc).sum(-1) - (spheres.radius * spheres.radius)[None]
        disc = b * b - a * cterm
        valid = (disc > 0.0) & spheres.mask[None]
        sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
        inv_a = 1.0 / a
        t0 = (-b - sq) * inv_a
        t1 = (-b + sq) * inv_a
        t0_ok = valid & (t0 > t_min) & (t0 < t_max)
        t1_ok = valid & (t1 > t_min) & (t1 < t_max)
        t_cand = torch.where(t0_ok, t0, torch.where(t1_ok, t1, _INF))
        t, idx = torch.min(t_cand, dim=-1)  # the first index of the minimum
        ts.append(t)
        idxs.append(idx)
    return torch.cat(ts), torch.cat(idxs)


def sphere_nearest(spheres: Spheres, soa: Optional[torch.Tensor], ro, rd,
                   time, has_motion: bool, differentiable: bool = False):
    """Closest sphere per ray: K1 (K3 with ``has_motion``) on world-space
    spheres, through ``SphereNearest`` under autograd; the object-space
    branch on instanced ones. ``soa`` is the kernels' operand
    (``fastpath.build_sphere_soa``; unused for instances). (t [R], idx
    [R] int64)."""
    if spheres.instanced:
        return sphere_nearest_instanced(spheres, ro, rd, time, has_motion)
    if differentiable:
        extra = ((spheres.center_delta, spheres.time0,
                  spheres.inv_time_delta, time) if has_motion else ())
        t, idx = ik.SphereNearest.apply(soa, spheres.center, spheres.radius,
                                        ro, rd, *extra)
        return t, idx.long()
    rays = ik.pack_rays(ro, rd)
    if has_motion:
        t, idx = ik.sphere_nearest_moving(soa, rays,
                                          time.to(torch.float32).contiguous())
    else:
        t, idx = ik.sphere_nearest(soa, rays)
    return t, idx.long()


def _inverse_transpose_normal(lin_ofw: torch.Tensor,
                              n_o: torch.Tensor) -> torch.Tensor:
    """World normal of the object-space normal ``n_o`` [R, 3] through the
    inverse transpose of each ray's affine (``lin_ofw``: [R, 3, 3], the
    linear part of obj_from_world), unit length."""
    n_w = torch.einsum("rji,rj->ri", lin_ofw, n_o)
    norm = torch.sqrt(torch.clamp((n_w * n_w).sum(-1), min=1e-24))
    return n_w / norm[..., None]


def sphere_record(spheres: Spheres, t, idx, ro, rd, time,
                  with_uv: bool = True) -> HitRecord:
    """The record of each ray's winning sphere ``idx``: the point on the
    world ray, the normal ``(p - c) / r`` from the time-lerped centre
    (signed radius: a negative one flips it), and with ``with_uv`` the
    sphere UV of the (object-space) normal, ``u = 1 - (atan2(x, y) + pi)
    / 2 pi``, ``v = (asin(y) + pi / 2) / pi``."""
    hit = t < _INF
    t_safe = torch.where(hit, t, 0.0)
    c0 = spheres.center[idx]
    delta = spheres.center_delta[idx]
    s = (time - spheres.time0[idx]) * spheres.inv_time_delta[idx]
    center = c0 + s[..., None] * delta
    radius = spheres.radius[idx]
    point = ro + t_safe[..., None] * rd
    if spheres.instanced:
        ofw = spheres.obj_from_world[idx]
        lin_ofw = ofw[:, :, :3]
        point_o = torch.einsum("rij,rj->ri", lin_ofw, point) + ofw[:, :, 3]
        normal_o = (point_o - center) / radius[..., None]
        normal = _inverse_transpose_normal(lin_ofw, normal_o)
        uv_normal = normal_o
    else:
        normal = (point - center) / radius[..., None]
        uv_normal = normal
    if with_uv:
        phi = torch.atan2(uv_normal[..., 0], uv_normal[..., 1])
        theta = torch.asin(torch.clamp(uv_normal[..., 1], -1.0, 1.0))
        u = 1.0 - (phi + _PI) * _INV_2PI
        v = (theta + _HALF_PI) * _INV_PI
    else:
        u = torch.zeros_like(t)
        v = u
    return HitRecord(t=t, point=point, normal=normal, u=u, v=v,
                     mat_id=spheres.mat_id[idx].long(), hit=hit)


# ---------------------------------------------------------------------------
# rects
# ---------------------------------------------------------------------------

def _axes(axis: torch.Tensor):
    """The in-plane axes (ascending) of rects of normal ``axis``."""
    a_axis = torch.where(axis == 0, 1, 0)
    b_axis = torch.where(axis == 2, 1, 2)
    return a_axis, b_axis


def rect_nearest_instanced(rects: Rects, ro, rd, t_min: float = MIN_T,
                           t_max: float = MAX_T):
    """Closest instanced rect per ray: the plane test on each rect's
    object-space ray ([R, N] in ray chunks). (t [R], idx [R] int64)."""
    R, N = ro.shape[0], rects.count
    axis = rects.axis.long()
    a_axis, b_axis = _axes(axis)
    ts, idxs = [], []
    for lo, hi in _chunks(R, N):
        ro_o, rd_o = _to_object(rects.obj_from_world, ro[lo:hi], rd[lo:hi])
        r = hi - lo

        def ga(arr, ax):
            return torch.gather(arr, -1, ax[None, :, None].expand(r, N, 1))[..., 0]

        o_n, d_n = ga(ro_o, axis), ga(rd_o, axis)
        o_a, d_a = ga(ro_o, a_axis), ga(rd_o, a_axis)
        o_b, d_b = ga(ro_o, b_axis), ga(rd_o, b_axis)
        d_n = torch.where(torch.abs(d_n) < 1e-12, 1e-12, d_n)
        t = (rects.k[None] - o_n) / d_n
        pa = o_a + t * d_a
        pb = o_b + t * d_b
        ok = (rects.mask[None] & (t > t_min) & (t < t_max)
              & (pa >= rects.a0[None]) & (pa <= rects.a1[None])
              & (pb >= rects.b0[None]) & (pb <= rects.b1[None]))
        tb, ib = torch.min(torch.where(ok, t, _INF), dim=-1)
        ts.append(tb)
        idxs.append(ib)
    return torch.cat(ts), torch.cat(idxs)


def rect_hits(rects: Rects, ro, rd):
    """Closest rect per ray: the plane loop of ``intersect_rect`` for
    world-space rects, the object-space branch for instanced ones."""
    if rects.instanced:
        return rect_nearest_instanced(rects, ro, rd)
    t, idx = rect_nearest(rects, *_planes(ro, rd))
    return t, idx.long()


def rect_record(rects: Rects, t, idx, ro, rd) -> HitRecord:
    """The record of each ray's winning rect: UV over the rect's bounds
    (of the object-space point for an instance) and the axis normal times
    ``flip``, mapped back by the inverse transpose for an instance."""
    hit = t < _INF
    t_safe = torch.where(hit, t, 0.0)
    axis = rects.axis[idx].long()
    a_axis, b_axis = _axes(axis)
    point = ro + t_safe[..., None] * rd
    if rects.instanced:
        ofw = rects.obj_from_world[idx]
        lin_ofw = ofw[:, :, :3]
        point_uv = torch.einsum("rij,rj->ri", lin_ofw, point) + ofw[:, :, 3]
    else:
        point_uv = point
    pa = torch.gather(point_uv, -1, a_axis[..., None])[..., 0]
    pb = torch.gather(point_uv, -1, b_axis[..., None])[..., 0]
    a0, a1 = rects.a0[idx], rects.a1[idx]
    b0, b1 = rects.b0[idx], rects.b1[idx]
    u = (pa - a0) / (a1 - a0)
    v = (pb - b0) / (b1 - b0)
    one_hot = (torch.arange(3, device=axis.device)[None, :]
               == axis[..., None]).to(point.dtype)
    normal = one_hot * rects.flip[idx][..., None]
    if rects.instanced:
        normal = _inverse_transpose_normal(lin_ofw, normal)
    return HitRecord(t=t, point=point, normal=normal, u=u, v=v,
                     mat_id=rects.mat_id[idx].long(), hit=hit)


# ---------------------------------------------------------------------------
# boxes and media
# ---------------------------------------------------------------------------

def box_record(boxes: Boxes, t, idx, ro, rd) -> HitRecord:
    """The record of each ray's winning box: the slab test redone for that
    box in object space; the face is the entry face where t is the entry
    distance (to 1e-4 relative), else the exit face; the outward face
    normal mapped by ``world_from_obj``'s linear part, and the face's UV
    as a rect of that face parameterizes it."""
    hit = t < _INF
    t_safe = torch.where(hit, t, 0.0)
    ofw = boxes.obj_from_world[idx]
    ro_o = torch.einsum("rij,rj->ri", ofw[:, :, :3], ro) + ofw[:, :, 3]
    rd_o = torch.einsum("rij,rj->ri", ofw[:, :, :3], rd)
    p0, p1 = boxes.p0[idx], boxes.p1[idx]
    rd_o = torch.where(torch.abs(rd_o) < 1e-12, 1e-12, rd_o)
    rcp = 1.0 / rd_o
    d0 = (p0 - ro_o) * rcp
    d1 = (p1 - ro_o) * rcp
    tn = torch.minimum(d0, d1)
    tf = torch.maximum(d0, d1)
    t_enter = tn.max(dim=-1).values
    enter_axis = torch.argmax(tn, dim=-1)
    exit_axis = torch.argmin(tf, dim=-1)
    is_entry = (torch.abs(t_safe - t_enter)
                < 1e-4 * torch.clamp(torch.abs(t_safe), min=1.0))
    face_axis = torch.where(is_entry, enter_axis, exit_axis)
    sign_d = torch.sign(torch.gather(rd_o, -1, face_axis[..., None])[..., 0])
    n_sign = torch.where(is_entry, -sign_d, sign_d)
    normal_obj = ((torch.arange(3, device=ro.device)[None, :]
                   == face_axis[..., None]).to(ro.dtype) * n_sign[..., None])
    lin_wfo = boxes.world_from_obj[idx][:, :, :3]
    normal = torch.einsum("rij,rj->ri", lin_wfo, normal_obj)
    point = ro + t_safe[..., None] * rd
    p_obj = ro_o + t_safe[..., None] * rd_o
    a_axis, b_axis = _axes(face_axis)

    def ga(arr, ax):
        return torch.gather(arr, -1, ax[..., None])[..., 0]

    u = (ga(p_obj, a_axis) - ga(p0, a_axis)) / (ga(p1, a_axis) - ga(p0, a_axis))
    v = (ga(p_obj, b_axis) - ga(p0, b_axis)) / (ga(p1, b_axis) - ga(p0, b_axis))
    return HitRecord(t=t, point=point, normal=normal, u=u, v=v,
                     mat_id=boxes.mat_id[idx].long(), hit=hit)


def media_record(media: Media, t, idx, ro, rd) -> HitRecord:
    """The record of a free-flight hit: the point, an arbitrary normal
    (1, 0, 0), which the isotropic phase function never reads, UV 0."""
    hit = t < _INF
    t_safe = torch.where(hit, t, 0.0)
    point = ro + t_safe[..., None] * rd
    normal = torch.tensor([1.0, 0.0, 0.0], dtype=ro.dtype,
                          device=ro.device).expand(point.shape)
    zeros = torch.zeros_like(t)
    return HitRecord(t=t, point=point, normal=normal, u=zeros, v=zeros,
                     mat_id=media.mat_id[idx].long(), hit=hit)


# ---------------------------------------------------------------------------
# the whole scene
# ---------------------------------------------------------------------------

def _select_record(cond: torch.Tensor, a: HitRecord, b: HitRecord) -> HitRecord:
    c3 = cond[..., None]
    return HitRecord(
        t=torch.where(cond, a.t, b.t),
        point=torch.where(c3, a.point, b.point),
        normal=torch.where(c3, a.normal, b.normal),
        u=torch.where(cond, a.u, b.u),
        v=torch.where(cond, a.v, b.v),
        mat_id=torch.where(cond, a.mat_id, b.mat_id),
        hit=torch.where(cond, a.hit, b.hit),
    )


def _miss_record(ro: torch.Tensor) -> HitRecord:
    R = ro.shape[0]
    zeros = torch.zeros(R, dtype=ro.dtype, device=ro.device)
    return HitRecord(
        t=torch.full((R,), _INF, dtype=ro.dtype, device=ro.device),
        point=torch.zeros_like(ro), normal=torch.zeros_like(ro),
        u=zeros, v=zeros,
        mat_id=torch.zeros(R, dtype=torch.int64, device=ro.device),
        hit=torch.zeros(R, dtype=torch.bool, device=ro.device),
    )


def intersect_scene(scene: Scene, ro, rd, time, media_uniforms,
                    soa: Optional[torch.Tensor], features: SceneFeatures,
                    differentiable: bool = False) -> HitRecord:
    """The closest hit across every primitive kind of ``scene`` for the
    rays (ro, rd [R, 3], time [R]), with its record. ``media_uniforms``:
    [R, n_media] free-flight uniforms (media scenes); ``soa``: the sphere
    kernels' operand; ``differentiable``: the spheres go through
    ``SphereNearest`` (K6 backward). Absent kinds are skipped."""
    f = features
    rec = None
    if f.has_spheres:
        t, idx = sphere_nearest(scene.spheres, soa, ro, rd, time,
                                f.has_motion, differentiable)
        rec = sphere_record(scene.spheres, t, idx, ro, rd, time,
                            with_uv=f.has_image)
    if f.has_rects:
        t, idx = rect_hits(scene.rects, ro, rd)
        nxt = rect_record(scene.rects, t, idx, ro, rd)
        rec = nxt if rec is None else _select_record(rec.t <= t, rec, nxt)
    if f.has_boxes:
        t, idx = box_nearest(scene.boxes, *_planes(ro, rd))
        nxt = box_record(scene.boxes, t, idx.long(), ro, rd)
        rec = nxt if rec is None else _select_record(rec.t <= t, rec, nxt)
    if f.has_media:
        t, idx = media_nearest(scene.media, *_planes(ro, rd),
                               media_uniforms.T)
        nxt = media_record(scene.media, t, idx.long(), ro, rd)
        rec = nxt if rec is None else _select_record(rec.t <= t, rec, nxt)
    return _miss_record(ro) if rec is None else rec

