"""The plain path tracer the benchmark holds the renderer to.

Plain PyTorch, in the precision ``dtype`` (float32 for the check, a lower
one for the control), on any device. It takes the scene and the camera as
plain arrays (:func:`scene_arrays`, :func:`camera_arrays`: the inputs the
benchmark built) and works out everything else itself: the primary rays
from the frame's Threefry key, the bounce RNG, every closest hit (spheres
static or moving, rects, transformed boxes, constant-density media with
their free flights), the normals, textures (constant, checker, hash
marble, image atlas), the emission and sky, and the Lambertian, metal,
dielectric and isotropic scatter. Every lane is traced at full width for
``max_depth + 1`` bounces under an alive mask, with no compaction: a
lane's result depends only on its primary ray and its id, which keys its
draws, so this gives the same estimator as any lane placement.

The arithmetic follows the reference renderer's fast path (the JAX
package's ``fast_bounce``), operation for operation where rounding
decides a ray's path: the sphere roots from a float64 square root rounded
once, the slab tests, the counter hash and its draws ``0-3`` (scatter),
``8 + j`` (medium ``j``'s free flight).

:func:`trace_diff` is the differentiable form for sphere scenes: the
sweep picks each ray's winner without a gradient and the winner's
distance is recomputed from the leaves, so gradients reach the sphere
centres and radii, the texture colours and the materials' fuzz and
refractive index, as the trainer's do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import threefry

MIN_T = 0.001
MAX_T = 3.402823466e38
TWO_PI = 6.283185307179586
_M32 = 0xFFFFFFFF
SWEEP_PAIRS = 1 << 24  # (ray, primitive) pairs a chunk of a sweep

MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_LIGHT, MAT_ISOTROPIC = range(5)
TEX_CONSTANT, TEX_CHECKER, TEX_NOISE, TEX_IMAGE = range(4)
KIND_SPHERE, KIND_RECT, KIND_BOX, KIND_MEDIUM = range(4)
MEDIUM_SPHERE = 1


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def scene_arrays(scene, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The live primitives and the shading tables of a renderer ``Scene``
    as plain tensors on ``device`` (floats in ``dtype``, ids int64)."""
    def f(x):
        return x.detach().to(device=device, dtype=dtype)

    def i(x):
        return x.detach().to(device=device, dtype=torch.int64)

    sp, rc, bx, md = scene.spheres, scene.rects, scene.boxes, scene.media
    tx, mt, at = scene.textures, scene.materials, scene.atlas
    s, r, b, m = (x.mask.detach().cpu() for x in (sp, rc, bx, md))
    return {
        "sp_center": f(sp.center[s]), "sp_delta": f(sp.center_delta[s]),
        "sp_time0": f(sp.time0[s]), "sp_inv_dt": f(sp.inv_time_delta[s]),
        "sp_radius": f(sp.radius[s]), "sp_mat": i(sp.mat_id[s]),
        "rc_axis": i(rc.axis[r]), "rc_a0": f(rc.a0[r]), "rc_a1": f(rc.a1[r]),
        "rc_b0": f(rc.b0[r]), "rc_b1": f(rc.b1[r]), "rc_k": f(rc.k[r]),
        "rc_flip": f(rc.flip[r]), "rc_mat": i(rc.mat_id[r]),
        "bx_p0": f(bx.p0[b]), "bx_p1": f(bx.p1[b]),
        "bx_ofw": f(bx.obj_from_world[b]), "bx_wfo": f(bx.world_from_obj[b]),
        "bx_mat": i(bx.mat_id[b]),
        "md_kind": i(md.kind[m]), "md_p0": f(md.p0[m]), "md_p1": f(md.p1[m]),
        "md_radius": f(md.radius[m]), "md_ofw": f(md.obj_from_world[m]),
        "md_density": f(md.density[m]), "md_mat": i(md.mat_id[m]),
        "mat_kind": i(mt.kind), "mat_tex": i(mt.tex_id),
        "mat_fuzz": f(mt.fuzz), "mat_ref_idx": f(mt.ref_idx),
        "tex_kind": i(tx.kind), "tex_color": f(tx.color),
        "tex_odd": i(tx.odd_id), "tex_even": i(tx.even_id),
        "tex_scale": f(tx.scale), "tex_image": i(tx.image_id),
        "atlas": f(at.data), "atlas_y": i(at.y_offset),
        "atlas_h": f(at.height), "atlas_w": f(at.width),
        "sky": f(scene.sky.reshape(3)),
        "gradient_sky": float(scene.use_gradient_sky) > 0.5,
    }


CAMERA_FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical",
                 "u", "v", "w", "time0", "time1", "lens_radius")


def camera_arrays(camera, device, dtype=torch.float32):
    return {k: getattr(camera, k).detach().to(device=device, dtype=dtype)
            for k in CAMERA_FIELDS}


# ---------------------------------------------------------------------------
# primary rays
# ---------------------------------------------------------------------------

def _normalize(v):
    n2 = (v * v).sum(dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=1e-38))


def primary_rays(cam, width: int, height: int, samples: int,
                 key: torch.Tensor, device, dtype=torch.float32):
    """Jittered thin-lens rays of a frame keyed ``key``, in [H, W, S]
    order flattened: ro, rd [R, 3], time [R]. The jitter from
    ``split(key)[0]``, the lens and shutter uniforms from ``split(key)[1]``."""
    kj, kc = threefry.split(key)
    jitter = threefry.uniform(kj, (height, width, samples, 2), device)
    cam_u = threefry.uniform(kc, (height, width, samples, 3), device)
    jitter, cam_u = jitter.to(dtype), cam_u.to(dtype)
    x = torch.arange(width, dtype=dtype, device=device)[None, :, None]
    y = torch.arange(height, dtype=dtype, device=device)[:, None, None]
    s = (x + jitter[..., 0]) / width
    t = (y + jitter[..., 1]) / height
    r = torch.sqrt(cam_u[..., 0])
    a = cam_u[..., 1] * TWO_PI
    disk = cam["lens_radius"] * torch.stack(
        [r * torch.cos(a), r * torch.sin(a), torch.zeros_like(r)], dim=-1)
    offset = cam["u"] * disk[..., 0:1] + cam["v"] * disk[..., 1:2]
    time = cam["time0"] + cam_u[..., 2] * (cam["time1"] - cam["time0"])
    origin = cam["origin"] + offset
    direction = _normalize(cam["lower_left_corner"]
                           + s[..., None] * cam["horizontal"]
                           + t[..., None] * cam["vertical"]
                           - cam["origin"] - offset)
    R = height * width * samples
    return origin.reshape(R, 3), direction.reshape(R, 3), time.reshape(R)


# ---------------------------------------------------------------------------
# the counter-hash bounce RNG and the hash marble
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _unit24(h):
    return (h >> 8).to(torch.int32).to(torch.float32)


def counter_uniform(lane: torch.Tensor, seed: int, depth: int,
                    draw: int) -> torch.Tensor:
    """float32 uniform in [0, 1) of (lane id, seed, depth, draw)."""
    k = ((int(seed) & _M32) * 2891336453 + (int(depth) & _M32) * 1013904223
         + draw * 374761393) & _M32
    h = (_mul32(lane, 747796405) + k) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 2146121005)
    h = h ^ (h >> 15)
    h = _mul32(h, 2654435769)
    h = h ^ (h >> 13)
    return _unit24(h) * (1.0 / 16777216.0)


def _hash3(ix, iy, iz):
    h = (_mul32(ix & _M32, 374761393) + _mul32(iy & _M32, 668265263)
         + _mul32(iz & _M32, 1103515245)) & _M32
    h = h ^ (h >> 13)
    h = _mul32(h, 1274126177)
    return h ^ (h >> 16)


def _hash_unit(h):
    return _unit24(h) * (2.0 / 16777216.0) - 1.0


def _noise(px, py, pz):
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = (v.to(torch.int32).to(torch.int64) for v in (fx, fy, fz))
    u, v, w = px - fx, py - fy, pz - fz
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    acc = torch.zeros_like(px)
    for di in (0, 1):
        wu = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wv = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                h = _hash3(ix + di, iy + dj, iz + dk)
                gx = _hash_unit(h).to(px.dtype)
                gy = _hash_unit((_mul32(h, 1664525) + 1013904223)
                                & _M32).to(px.dtype)
                gz = _hash_unit((_mul32(h, 22695477) + 1) & _M32).to(px.dtype)
                dot = gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                acc = acc + wu * wv * wk * dot
    return acc


def turbulence(px, py, pz, octaves: int = 7):
    acc = torch.zeros_like(px)
    weight = 1.0
    for _ in range(octaves):
        acc = acc + weight * _noise(px, py, pz)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(acc)


# ---------------------------------------------------------------------------
# closest hits: each kind's first minimum over its live primitives
# ---------------------------------------------------------------------------

def _sqrt_rounded(x):
    """The correctly rounded square root: a float64 root rounded once
    for float32 (what an IEEE ``sqrtf`` gives)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _inf(like):
    """MAX_T in ``like``'s precision (inf where it does not fit)."""
    return torch.tensor(MAX_T, dtype=torch.float32).to(like.dtype).item()


def _tmax(like):
    """The far end of a ray's interval in ``like``'s precision."""
    return min(MAX_T, float(torch.finfo(like.dtype).max))


def _chunks(R: int, n: int):
    step = max(1, SWEEP_PAIRS // max(n, 1))
    return [(lo, min(lo + step, R)) for lo in range(0, R, step)]


def sphere_sweep(A, ro, rd, time):
    """(t [R], idx [R] int64) over the live spheres, their centres lerped
    to each ray's time."""
    c, d = A["sp_center"], A["sp_delta"]
    R, n = ro.shape[0], c.shape[0]
    inf, hi = _inf(ro), _tmax(ro)
    t_out = torch.full((R,), inf, dtype=ro.dtype, device=ro.device)
    i_out = torch.zeros((R,), dtype=torch.int64, device=ro.device)
    if n == 0:
        return t_out, i_out
    cx, cy, cz = (c[:, k][None, :] for k in range(3))
    cc = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
          - A["sp_radius"] * A["sp_radius"])[None, :]
    moving = bool((A["sp_inv_dt"] != 0).any())
    if moving:
        mx, my, mz = (d[:, k][None, :] for k in range(3))
        t0, inv_dt = A["sp_time0"][None, :], A["sp_inv_dt"][None, :]
        c_dot_d = (c[:, 0] * d[:, 0] + c[:, 1] * d[:, 1]
                   + c[:, 2] * d[:, 2])[None, :]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[None, :]
    for lo, hi in _chunks(R, n):
        ox, oy, oz = (ro[lo:hi, k][:, None] for k in range(3))
        dx, dy, dz = (rd[lo:hi, k][:, None] for k in range(3))
        b = (ox * dx + oy * dy + oz * dz) - (cx * dx + cy * dy + cz * dz)
        cq = (ox * ox + oy * oy + oz * oz) - 2.0 * (cx * ox + cy * oy
                                                    + cz * oz) + cc
        if moving:
            s = (time[lo:hi, None] - t0) * inv_dt
            b = b - s * (mx * dx + my * dy + mz * dz)
            cq = (cq - 2.0 * s * (mx * ox + my * oy + mz * oz)
                  + 2.0 * s * c_dot_d + s * s * d2)
        disc = b * b - cq
        sq = _sqrt_rounded(torch.clamp(disc, min=0.0))
        r0, r1 = -b - sq, -b + sq
        valid = disc > 0.0
        ok0 = valid & (r0 > MIN_T) & (r0 < hi)
        ok1 = valid & (r1 > MIN_T) & (r1 < hi)
        t = torch.where(ok0, r0, torch.where(ok1, r1, inf))
        tmin, imin = torch.min(t, dim=1)
        t_out[lo:hi], i_out[lo:hi] = tmin, imin
    return t_out, i_out


def rect_sweep(A, ro, rd):
    R = ro.shape[0]
    inf, hi = _inf(ro), _tmax(ro)
    tbest = torch.full((R,), inf, dtype=ro.dtype, device=ro.device)
    ibest = torch.zeros((R,), dtype=torch.int64, device=ro.device)
    o, d = ro.unbind(1), rd.unbind(1)
    for j in range(A["rc_axis"].shape[0]):
        ax = int(A["rc_axis"][j])
        n_ax, a_ax = ax, (1 if ax == 0 else 0)
        b_ax = 1 if ax == 2 else 2
        d_n = torch.where(torch.abs(d[n_ax]) < 1e-12, 1e-12, d[n_ax])
        t = (A["rc_k"][j] - o[n_ax]) / d_n
        pa = o[a_ax] + t * d[a_ax]
        pb = o[b_ax] + t * d[b_ax]
        ok = ((t > MIN_T) & (t < hi) & (pa >= A["rc_a0"][j])
              & (pa <= A["rc_a1"][j]) & (pb >= A["rc_b0"][j])
              & (pb <= A["rc_b1"][j]))
        cand = torch.where(ok, t, inf)
        better = cand < tbest
        tbest = torch.where(better, cand, tbest)
        ibest = torch.where(better, j, ibest)
    return tbest, ibest


def _slab(p0, p1, ofw, ro, rd):
    """(t_enter, t_exit) of rays [Rc, 1] planes against boxes [N] in the
    object space ``ofw`` [N, 3, 4] maps to, one axis at a time."""
    tn = tf = None
    for r in range(3):
        m = ofw[:, r, :]
        ro_o = m[:, 0] * ro[0] + m[:, 1] * ro[1] + m[:, 2] * ro[2] + m[:, 3]
        rd_o = m[:, 0] * rd[0] + m[:, 1] * rd[1] + m[:, 2] * rd[2]
        dd = torch.where(torch.abs(rd_o) < 1e-12, 1e-12, rd_o)
        rcp = 1.0 / dd
        d0 = (p0[:, r] - ro_o) * rcp
        d1 = (p1[:, r] - ro_o) * rcp
        lo, hi = torch.minimum(d0, d1), torch.maximum(d0, d1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def box_sweep(A, ro, rd):
    R, n = ro.shape[0], A["bx_p0"].shape[0]
    inf, hi = _inf(ro), _tmax(ro)
    t_out = torch.full((R,), inf, dtype=ro.dtype, device=ro.device)
    i_out = torch.zeros((R,), dtype=torch.int64, device=ro.device)
    if n == 0:
        return t_out, i_out
    for lo, hi in _chunks(R, n):
        o = [ro[lo:hi, k][:, None] for k in range(3)]
        d = [rd[lo:hi, k][:, None] for k in range(3)]
        tn, tf = _slab(A["bx_p0"], A["bx_p1"], A["bx_ofw"], o, d)
        crosses = tf > tn
        enter = crosses & (tn > MIN_T) & (tn < hi)
        leave = crosses & (tn <= MIN_T) & (tf > MIN_T) & (tf < hi)
        cand = torch.where(enter, tn, torch.where(leave, tf, inf))
        t_out[lo:hi], i_out[lo:hi] = torch.min(cand, dim=1)
    return t_out, i_out


def media_sweep(A, ro, rd, lane, seed: int, depth: int):
    """Each medium's free-flight hit inside its boundary (the slab or the
    sphere of centre p0), the flight ``-ln(u) / density`` from draw
    ``8 + j`` of medium ``j``."""
    R, n = ro.shape[0], A["md_p0"].shape[0]
    inf, hi = _inf(ro), _tmax(ro)
    t_out = torch.full((R,), inf, dtype=ro.dtype, device=ro.device)
    i_out = torch.zeros((R,), dtype=torch.int64, device=ro.device)
    if n == 0:
        return t_out, i_out
    u_all = torch.stack([counter_uniform(lane, seed, depth, 8 + j)
                         for j in range(n)], dim=1).to(ro.dtype)
    is_sphere = A["md_kind"] == MEDIUM_SPHERE
    r2 = A["md_radius"] * A["md_radius"]
    p0 = A["md_p0"]
    for lo, hi in _chunks(R, n):
        o = [ro[lo:hi, k][:, None] for k in range(3)]
        d = [rd[lo:hi, k][:, None] for k in range(3)]
        tn, tf = _slab(p0, A["md_p1"], A["md_ofw"], o, d)
        ocx, ocy, ocz = (o[k] - p0[:, k] for k in range(3))
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        b = ocx * d[0] + ocy * d[1] + ocz * d[2]
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = b * b - a * c
        sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
        t1 = torch.where(is_sphere, (-b - sq) / a, tn)
        t2 = torch.where(is_sphere, (-b + sq) / a, tf)
        crosses = torch.where(is_sphere, disc > 0.0, tf > tn)
        t1 = torch.clamp(t1, min=MIN_T)
        t2 = torch.clamp(t2, max=hi)
        ok = crosses & (t1 < t2)
        t1 = torch.clamp(t1, min=0.0)
        flight = (-torch.log(torch.clamp(u_all[lo:hi], min=1e-38))
                  / A["md_density"])
        cand = torch.where(ok & (flight < t2 - t1), t1 + flight, inf)
        t_out[lo:hi], i_out[lo:hi] = torch.min(cand, dim=1)
    return t_out, i_out


def closest_hit(A, ro, rd, time, lane, seed: int, depth: int):
    """(t, kind, idx): the spheres, then the rects, boxes and media, each
    kind winning only where strictly nearer."""
    t, idx = sphere_sweep(A, ro, rd, time)
    kind = torch.zeros_like(idx)
    others = [(KIND_RECT, "rc_axis", lambda: rect_sweep(A, ro, rd)),
              (KIND_BOX, "bx_p0", lambda: box_sweep(A, ro, rd)),
              (KIND_MEDIUM, "md_p0",
               lambda: media_sweep(A, ro, rd, lane, seed, depth))]
    for k, key, sweep in others:
        if A[key].shape[0] == 0:
            continue
        tk, ik = sweep()
        wins = tk < t
        t = torch.where(wins, tk, t)
        idx = torch.where(wins, ik, idx)
        kind = torch.where(wins, k, kind)
    return t, kind, idx


def winner_t_diff(center, radius, ro, rd, idx):
    """The winning sphere's root recomputed from the leaves (differentiable
    in the centre, the radius and the ray): the near root where it lies in
    (MIN_T, MAX_T), else the far one."""
    oc = ro - center.index_select(0, idx)
    r = radius.index_select(0, idx)
    p = oc * rd
    b = (p[:, 0] + p[:, 1]) + p[:, 2]
    q = oc.square()
    cq = ((q[:, 0] + q[:, 1]) + q[:, 2]) - r.square()
    disc = b.square() - cq
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    t0, t1 = -b - sq, -b + sq
    return torch.where(pos & (t0 > MIN_T) & (t0 < _tmax(t0)), t0, t1)


# ---------------------------------------------------------------------------
# one bounce
# ---------------------------------------------------------------------------

def _box_frame(A, bidx, ro, rd, t_safe):
    """A box winner's world normal (entry face where |t - t_enter| <
    1e-4 max(|t|, 1), else the exit face, signed against the ray), its
    face axis and the object-space ray."""
    ofw, wfo = A["bx_ofw"][bidx], A["bx_wfo"][bidx]
    p0, p1 = A["bx_p0"][bidx], A["bx_p1"][bidx]
    ro_o = [ofw[:, r, 0] * ro[:, 0] + ofw[:, r, 1] * ro[:, 1]
            + ofw[:, r, 2] * ro[:, 2] + ofw[:, r, 3] for r in range(3)]
    rd_o = [ofw[:, r, 0] * rd[:, 0] + ofw[:, r, 1] * rd[:, 1]
            + ofw[:, r, 2] * rd[:, 2] for r in range(3)]
    rd_o = [torch.where(torch.abs(v) < 1e-12, 1e-12, v) for v in rd_o]
    tn3, tf3 = [], []
    for r in range(3):
        rcp = 1.0 / rd_o[r]
        d0 = (p0[:, r] - ro_o[r]) * rcp
        d1 = (p1[:, r] - ro_o[r]) * rcp
        tn3.append(torch.minimum(d0, d1))
        tf3.append(torch.maximum(d0, d1))
    t_enter = torch.maximum(torch.maximum(tn3[0], tn3[1]), tn3[2])
    enter_axis = torch.where(tn3[1] > tn3[0], 1, 0)
    enter_axis = torch.where(tn3[2] > torch.maximum(tn3[0], tn3[1]), 2,
                             enter_axis)
    exit_axis = torch.where(tf3[1] < tf3[0], 1, 0)
    exit_axis = torch.where(tf3[2] < torch.minimum(tf3[0], tf3[1]), 2,
                            exit_axis)
    is_entry = torch.abs(t_safe - t_enter) < 1e-4 * torch.clamp(
        torch.abs(t_safe), min=1.0)
    face = torch.where(is_entry, enter_axis, exit_axis)
    fa = [(face == r).to(t_safe.dtype) for r in range(3)]
    sign_d = torch.sign(fa[0] * rd_o[0] + fa[1] * rd_o[1] + fa[2] * rd_o[2])
    n_sign = torch.where(is_entry, -sign_d, sign_d)
    n_obj = [fa[r] * n_sign for r in range(3)]
    normal = torch.stack([wfo[:, r, 0] * n_obj[0] + wfo[:, r, 1] * n_obj[1]
                          + wfo[:, r, 2] * n_obj[2] for r in range(3)], dim=1)
    return normal, face, ro_o, rd_o, p0, p1


def _trunc_clamp(x, size):
    v = torch.fmin(torch.fmax(x, x.new_tensor(-1.0)), size)
    hi = torch.clamp(size.to(torch.int32) - 1, min=0)
    return torch.minimum(torch.clamp(v.to(torch.int32), min=0), hi)


def _gather(x, idx):
    return x.index_select(0, idx) if x.shape[0] else x.new_zeros(
        (idx.shape[0],) + tuple(x.shape[1:]))


def bounce(A, state, seed: int, depth: int, max_depth: int, leaves=None):
    """One bounce of every lane. ``state``: dict of ro, rd [R, 3], time,
    radiance, throughput, alive, lane. ``leaves`` (the differentiable
    form, sphere scenes): the trainable leaves by name, which replace the
    arrays they stand for and take the gradient."""
    L = leaves or {}
    center = L.get("spheres.center", A["sp_center"])
    radius = L.get("spheres.radius", A["sp_radius"])
    color = L.get("textures.color", A["tex_color"])
    fuzz = L.get("materials.fuzz", A["mat_fuzz"])
    ref_idx_all = L.get("materials.ref_idx", A["mat_ref_idx"])
    ro, rd, time, lane = state["ro"], state["rd"], state["time"], state["lane"]
    if leaves is not None:
        A = dict(A, sp_center=center.detach(), sp_radius=radius.detach())
    with torch.no_grad():
        t, kind, idx = closest_hit(A, ro.detach(), rd.detach(), time, lane,
                                   seed, depth)
    inf = _inf(ro)
    hit = t < inf
    is_sph = kind == KIND_SPHERE
    sidx = torch.where(is_sph, idx, 0)
    if leaves is not None:
        tw = winner_t_diff(center, radius, ro, rd, sidx)
        t = torch.where(hit & is_sph, t + (tw - tw.detach()), t)
    t_safe = torch.where(hit, t, 0.0)
    point = ro + t_safe[:, None] * rd

    # per-kind attributes of the winner
    mat = _gather(A["sp_mat"], sidx)
    c = _gather(center, sidx)
    moving = bool((A["sp_inv_dt"] != 0).any())
    if moving:
        s = (time - _gather(A["sp_time0"], sidx)) * _gather(A["sp_inv_dt"],
                                                            sidx)
        c = c + s[:, None] * _gather(A["sp_delta"], sidx)
    r = _gather(radius, sidx)
    inv_r = 1.0 / torch.where(torch.abs(r) < 1e-12, 1.0, r)
    normal = (point - c) * inv_r[:, None]
    n_rc, n_bx, n_md = (A[k].shape[0] for k in ("rc_axis", "bx_p0", "md_p0"))
    if n_rc:
        is_rc = kind == KIND_RECT
        ridx = torch.where(is_rc, idx, 0)
        mat = torch.where(is_rc, A["rc_mat"][ridx], mat)
        axis = A["rc_axis"][ridx]
        one_hot = (torch.arange(3, device=ro.device) == axis[:, None]).to(
            ro.dtype)
        normal = torch.where(is_rc[:, None],
                             one_hot * A["rc_flip"][ridx][:, None], normal)
    box = None
    if n_bx:
        is_bx = kind == KIND_BOX
        bidx = torch.where(is_bx, idx, 0)
        mat = torch.where(is_bx, A["bx_mat"][bidx], mat)
        box = _box_frame(A, bidx, ro, rd, t_safe)
        normal = torch.where(is_bx[:, None], box[0], normal)
    if n_md:
        is_md = kind == KIND_MEDIUM
        midx = torch.where(is_md, idx, 0)
        mat = torch.where(is_md, A["md_mat"][midx], mat)
        normal = torch.where(is_md[:, None], normal.new_tensor([1.0, 0, 0]),
                             normal)

    # texture
    mat_kind = A["mat_kind"][mat]
    tid = A["mat_tex"][mat]
    tex_kind = A["tex_kind"][tid]
    rgb = color.index_select(0, tid)
    if bool((A["tex_kind"] == TEX_CHECKER).any()):
        with torch.no_grad():
            p = point.detach()
            sines = (torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1])
                     * torch.sin(10.0 * p[:, 2]))
        checker = torch.where(sines[:, None] < 0.0,
                              color.index_select(0, A["tex_odd"][tid]),
                              color.index_select(0, A["tex_even"][tid]))
        rgb = torch.where((tex_kind == TEX_CHECKER)[:, None], checker, rgb)
    if bool((A["tex_kind"] == TEX_NOISE).any()):
        is_noise = tex_kind == TEX_NOISE
        turb = torch.zeros_like(t)
        sel = torch.nonzero(is_noise).flatten()
        if sel.numel():
            q = point.detach()[sel]
            turb = turb.index_put((sel,), turbulence(q[:, 0], q[:, 1],
                                                     q[:, 2]))
        marble = 0.5 * (1.0 + torch.sin(A["tex_scale"][tid] * point[:, 2]
                                        + 10.0 * turb))
        rgb = torch.where(is_noise[:, None], marble[:, None], rgb)
    if bool((A["tex_kind"] == TEX_IMAGE).any()):
        rgb = torch.where((tex_kind == TEX_IMAGE)[:, None],
                          _image_rgb(A, kind, idx, tid, point, normal, t_safe,
                                     box), rgb)

    # emission, sky
    sky_t = 0.5 * (rd[:, 1] + 1.0)
    if A["gradient_sky"]:
        sky_rgb = (1.0 - sky_t)[:, None] + sky_t[:, None] * rd.new_tensor(
            [0.15, 0.21, 0.30])
    else:
        sky_rgb = A["sky"].reshape(1, 3).expand(rd.shape[0], 3)
    is_light = mat_kind == MAT_LIGHT
    emit = torch.where(hit[:, None], torch.where(is_light[:, None], rgb, 0.0),
                       sky_rgb)
    radiance = state["radiance"] + state["throughput"] * emit * \
        state["alive"].to(ro.dtype)[:, None]

    # scatter
    u1, u2, u3, uc = (counter_uniform(lane, seed, depth, k).to(ro.dtype)
                      for k in range(4))
    zz = u1 * 2.0 - 1.0
    aa = u2 * TWO_PI
    rr = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    unit = torch.stack([rr * torch.cos(aa), rr * torch.sin(aa), zz], dim=-1)
    n = normal
    rdotn = torch.sum(rd * n, dim=-1)
    reflected = rd - 2.0 * rdotn[:, None] * n
    direction = unit
    ok = torch.ones_like(hit)

    ref_idx = ref_idx_all[mat]
    exiting = rdotn > 0.0
    outward = torch.where(exiting[:, None], -n, n)
    ni = torch.where(exiting, ref_idx, 1.0 / ref_idx)
    cos_in = torch.where(exiting, rdotn, -rdotn)
    ces = 1.0 - ref_idx * ref_idx * (1.0 - cos_in * cos_in)
    cosine = torch.where(exiting, torch.sqrt(torch.where(ces > 0.0, ces, 1.0)),
                         cos_in)
    dt_ = torch.sum(rd * outward, dim=-1)
    disc = 1.0 - ni * ni * (1.0 - dt_ * dt_)
    refr_ok = disc > 0.0
    sq = torch.sqrt(torch.where(refr_ok, disc, 1.0))
    refr = ni[:, None] * (rd - outward * dt_[:, None]) - outward * sq[:, None]
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    omc = 1.0 - cosine
    omc2 = omc * omc
    schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
    reflect_prob = torch.where(refr_ok, schlick, 1.0)
    is_diel = mat_kind == MAT_DIELECTRIC
    direction = torch.where(is_diel[:, None],
                            torch.where((uc > reflect_prob)[:, None], refr,
                                        reflected), direction)

    rad3 = torch.exp(torch.log(torch.clamp(u3, min=1e-38)) * (1.0 / 3.0))
    metal_dir = reflected + (fuzz[mat] * rad3)[:, None] * unit
    is_metal = mat_kind == MAT_METAL
    direction = torch.where(is_metal[:, None], metal_dir, direction)
    ok = torch.where(is_metal, rdotn < 0.0, ok)
    is_lam = mat_kind == MAT_LAMBERTIAN
    direction = torch.where(is_lam[:, None], n + unit, direction)
    ok = ok & ~is_light

    inv_len = torch.rsqrt(torch.clamp(torch.sum(direction * direction,
                                                dim=-1), min=1e-38))
    direction = direction * inv_len[:, None]
    atten = torch.where(is_diel[:, None], 1.0, rgb)
    can = state["alive"] & hit & ok & (depth < max_depth)
    cs = can[:, None]
    return {
        "ro": torch.where(cs, point, ro), "rd": torch.where(cs, direction, rd),
        "time": time, "radiance": radiance,
        "throughput": torch.where(cs, state["throughput"] * atten,
                                  state["throughput"]),
        "alive": can, "lane": lane,
    }


def _image_rgb(A, kind, idx, tid, point, normal, t_safe, box):
    """The texel of each lane's winner: the sphere UV from its normal, a
    rect's in-plane fractions, a box's face parameterisation in object
    space; clamped into the texture's image in the atlas."""
    with torch.no_grad():
        nx, ny = normal[:, 0], normal[:, 1]
        phi = torch.atan2(nx, ny)
        theta = torch.asin(torch.clamp(ny, -1.0, 1.0))
        uu = 1.0 - (phi + 3.14159265) * (0.5 / 3.14159265)
        vv = (theta + 1.5707963) * (1.0 / 3.14159265)
        p = point
        if A["rc_axis"].shape[0]:
            is_rc = kind == KIND_RECT
            ridx = torch.where(is_rc, idx, 0)
            axis = A["rc_axis"][ridx]
            a0, a1 = A["rc_a0"][ridx], A["rc_a1"][ridx]
            b0, b1 = A["rc_b0"][ridx], A["rc_b1"][ridx]
            pa = torch.where(axis == 0, p[:, 1], p[:, 0])
            pb = torch.where(axis == 2, p[:, 1], p[:, 2])
            da, db = a1 - a0, b1 - b0
            da = torch.where(torch.abs(da) < 1e-12, 1.0, da)
            db = torch.where(torch.abs(db) < 1e-12, 1.0, db)
            uu = torch.where(is_rc, (pa - a0) / da, uu)
            vv = torch.where(is_rc, (pb - b0) / db, vv)
        if box is not None:
            _, face, ro_o, rd_o, p0, p1 = box
            p_obj = [ro_o[k] + t_safe * rd_o[k] for k in range(3)]

            def pick(planes, ax):
                return torch.where(ax == 0, planes[0],
                                   torch.where(ax == 1, planes[1], planes[2]))

            a_ax = torch.where(face == 0, 1, 0)
            b_ax = torch.where(face == 2, 1, 2)
            lo = [p0[:, k] for k in range(3)]
            hi = [p1[:, k] for k in range(3)]
            da = pick(hi, a_ax) - pick(lo, a_ax)
            db = pick(hi, b_ax) - pick(lo, b_ax)
            da = torch.where(torch.abs(da) < 1e-12, 1.0, da)
            db = torch.where(torch.abs(db) < 1e-12, 1.0, db)
            is_bx = kind == KIND_BOX
            uu = torch.where(is_bx, (pick(p_obj, a_ax) - pick(lo, a_ax)) / da,
                             uu)
            vv = torch.where(is_bx, (pick(p_obj, b_ax) - pick(lo, b_ax)) / db,
                             vv)
        img = A["tex_image"][tid]
        h, w = A["atlas_h"][img], A["atlas_w"][img]
        ii = _trunc_clamp(uu * w, w)
        jj = _trunc_clamp((1.0 - vv) * h - 0.001, h)
        atlas = A["atlas"]
        flat = (A["atlas_y"][img].to(torch.int32) + jj) * atlas.shape[1] + ii
    return atlas.reshape(-1, 3).index_select(0, flat.long())


# ---------------------------------------------------------------------------
# traces and frames
# ---------------------------------------------------------------------------

def lane_ids(lo: int, hi: int, device) -> torch.Tensor:
    """Lane ids ``lo..hi-1`` as the uint32 values the bounce RNG hashes."""
    return torch.arange(lo, hi, dtype=torch.int64, device=device) & _M32


def trace(A, ro, rd, time, lane, seed: int, max_depth: int, leaves=None):
    """Radiance [R, 3] of every lane after ``max_depth + 1`` bounces."""
    state = {"ro": ro, "rd": rd, "time": time,
             "radiance": torch.zeros_like(ro),
             "throughput": torch.ones_like(ro),
             "alive": torch.ones(ro.shape[0], dtype=torch.bool,
                                 device=ro.device), "lane": lane}
    for depth in range(max_depth + 1):
        state = bounce(A, state, seed, depth, max_depth, leaves)
    return state["radiance"]


def frame_image(A, cam, width: int, height: int, samples: int, max_depth: int,
                key: torch.Tensor, seed: int, block: int = 1 << 20):
    """The frame keyed ``key`` with bounce seed ``seed``: each pixel's
    sample mean, [H, W, 3], lane ``i`` the frame's ray ``i`` in [H, W, S]
    order. Traced in blocks of ``block`` lanes."""
    device, dtype = A["sky"].device, A["sky"].dtype
    ro, rd, time = primary_rays(cam, width, height, samples, key, device,
                                dtype)
    R = ro.shape[0]
    out = []
    with torch.no_grad():
        for lo in range(0, R, block):
            hi = min(R, lo + block)
            out.append(trace(A, ro[lo:hi], rd[lo:hi], time[lo:hi],
                             lane_ids(lo, hi, device), seed, max_depth))
    return torch.cat(out).reshape(height, width, samples, 3).mean(dim=2)


def accumulate(acc, new, frame_num: int):
    """The progressive blend of frame ``frame_num`` into the running mean."""
    n = torch.tensor(float(frame_num), dtype=new.dtype)
    mix = n / (n + 1.0)
    return acc * mix.item() + new * (1.0 - mix).item()

