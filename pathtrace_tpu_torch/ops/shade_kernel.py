"""Fused shade/scatter: the CUDA kernel ``csrc/shade.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``pathtrace_tpu/ops/shade_pallas.py``
``_shade_kernel`` together with the winner-row gather and transpose that
``pathtrace_tpu/ops/fastpath.py`` ``_fused_shade_from_winners`` ran before
it: the kernel reads each lane's winner row of the attribute table
itself, so no [R, 24] gather is materialized. Per lane: the hit point and
normal (a sphere's, from the centre lerped to the lane's time when the
scene moves, ``FLAG_MOTION``; a rect's, onehot(axis) * flip, for winner
rows of kind 1 under ``FLAG_RECT``; a box's, for rows of kind 2 under
``FLAG_BOX``: the slab test redone in object space picks the entry or
exit face, signed against the ray and mapped back through
``world_from_obj``; (1, 0, 0) for a medium, rows of kind 3 under
``FLAG_MEDIUM``), the albedo (constant, checker, hash-turbulence
marble, or under ``FLAG_IMAGE`` the texel of an image texture, read from
the atlas at the winner's UV), emission or the gradient/constant sky into the
radiance (the emission scaled by the lane's MIS weight, the 13th state
plane, under ``FLAG_EMIT_SCALE``), counter-hash draws 0-3, the Lambertian
/ metal / dielectric scatter (an isotropic medium's material takes the
default, the unit-sphere direction, attenuated by its albedo), the
normalized new direction and throughput, and
``alive = alive & hit & ok & depth < max_depth``. Under
``FLAG_EMIT_SCALE`` the output also carries the MIS plane (copied
through), the normal and the albedo: the next-event estimator's tail
reads them there.

On the card it is bound by bytes: about 120 per lane (15 state planes in,
13 out, t and idx, and the winner row, 96, 112 or 192 bytes, from L2),
against a few hundred flops (more with noise textures, ~100 more for a
box winner, ~150 and a 12-byte texel from L2 for an image winner); under
``FLAG_EMIT_SCALE`` 4 bytes more in and 28 more out. One
thread per lane; the feature flags are uniform across a launch, so their
branches diverge only where lanes of one warp hit different kinds.

Transcendentals (sin, cos, exp, log, rsqrt) may differ by a few ULPs
between CUDA, PyTorch and XLA; such differences, and the discrete
decisions they can flip (dielectric coin, metal horizon), are what the
per-lane tolerance of the tests allows.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.config import MAX_T
from pathtrace_tpu_torch.models.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
)

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)

# feature flags (runtime bitmask; must match csrc/shade.cu)
FLAG_CHECKER = 1
FLAG_NOISE = 2
FLAG_LAMBERTIAN = 4
FLAG_METAL = 8
FLAG_DIELECTRIC = 16
FLAG_LIGHT = 32
FLAG_MOTION = 64
FLAG_RECT = 128
FLAG_EMIT_SCALE = 256
FLAG_BOX = 512
FLAG_MEDIUM = 1024
FLAG_IMAGE = 2048

TWO_PI = 6.283185307179586
_INF = float(MAX_T)
_GEO = 15
# primitive kinds at column _GEO - 1 of a winner row
KIND_RECT, KIND_BOX, KIND_MEDIUM = 1.0, 2.0, 3.0
_SKY_GRADIENT = (0.15, 0.21, 0.30)
# rows of the output beside the 12 state planes under FLAG_EMIT_SCALE
ESC, NORMAL, ALBEDO = 12, slice(13, 16), slice(16, 19)


def box_frame(col, ro, rd, t_safe):
    """A box winner's normal: the slab test redone in object space from
    the row's ``obj_from_world`` columns (a direction component under
    1e-12 in magnitude becomes +1e-12), the entry face (first-max axis)
    when ``|t - t_enter| < 1e-4 * max(|t|, 1)``, else the exit face
    (first-min axis), signed against the ray (``torch.sign``: a zero
    component gives 0, as ``jnp.sign``), then mapped through
    ``world_from_obj``'s linear part. Returns (normal, face_axis [R]
    int64, ro_o, rd_o): three planes each for the normal and the
    object-space ray, which the box UV reads."""
    def ofw(r, c):
        return col[_GEO + 6 + r * 4 + c]

    ro_o = [ofw(r, 0) * ro[0] + ofw(r, 1) * ro[1] + ofw(r, 2) * ro[2]
            + ofw(r, 3) for r in range(3)]
    rd_o = [ofw(r, 0) * rd[0] + ofw(r, 1) * rd[1] + ofw(r, 2) * rd[2]
            for r in range(3)]
    rd_o = [torch.where(torch.abs(v) < 1e-12, 1e-12, v) for v in rd_o]
    tn3, tf3 = [], []
    for r in range(3):
        rcp = 1.0 / rd_o[r]
        d0 = (col[_GEO + r] - ro_o[r]) * rcp
        d1 = (col[_GEO + 3 + r] - ro_o[r]) * rcp
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
    face_axis = torch.where(is_entry, enter_axis, exit_axis)
    fa = [(face_axis == r).to(t_safe.dtype) for r in range(3)]
    rd_sel = fa[0] * rd_o[0] + fa[1] * rd_o[1] + fa[2] * rd_o[2]
    sign_d = torch.sign(rd_sel)
    n_sign = torch.where(is_entry, -sign_d, sign_d)
    n_obj = [fa[r] * n_sign for r in range(3)]

    def wfo(r, c):
        return col[_GEO + 18 + r * 3 + c]

    normal = [wfo(r, 0) * n_obj[0] + wfo(r, 1) * n_obj[1]
              + wfo(r, 2) * n_obj[2] for r in range(3)]
    return normal, face_axis, ro_o, rd_o


def normal_planes(col, ro, rd, t_safe, px, py, pz, time, flags):
    """The winner's surface normal as three [R] planes from its row's
    columns ``col``, the ray (``ro``, ``rd``: three [R] planes each), its
    hit distance ``t_safe`` (0 on a miss) and the hit point: the sphere
    normal (the centre lerped to ``time`` under ``FLAG_MOTION``); for a
    rect under ``FLAG_RECT``, onehot(axis) * flip; for a box under
    ``FLAG_BOX``, its face normal (:func:`box_frame`); for a medium
    under ``FLAG_MEDIUM``, (1, 0, 0). The twin of the JAX package's
    ``_normal_planes`` (``fastpath.py:1189``) on the branches this port
    has, in its order."""
    cx, cy, cz, r = col[_GEO], col[_GEO + 1], col[_GEO + 2], col[_GEO + 8]
    if flags & FLAG_MOTION:
        s = (time - col[_GEO + 6]) * col[_GEO + 7]
        cx = cx + s * col[_GEO + 3]
        cy = cy + s * col[_GEO + 4]
        cz = cz + s * col[_GEO + 5]
    inv_r = 1.0 / torch.where(torch.abs(r) < 1e-12, 1.0, r)
    nx = (px - cx) * inv_r
    ny = (py - cy) * inv_r
    nz = (pz - cz) * inv_r
    if flags & FLAG_RECT:
        axis, flip = col[_GEO], col[_GEO + 6]
        is_rect = col[_GEO - 1] == KIND_RECT
        nx = torch.where(is_rect, (axis == 0.0).to(px.dtype) * flip, nx)
        ny = torch.where(is_rect, (axis == 1.0).to(px.dtype) * flip, ny)
        nz = torch.where(is_rect, (axis == 2.0).to(px.dtype) * flip, nz)
    if flags & FLAG_BOX:
        is_box = col[_GEO - 1] == KIND_BOX
        bn = box_frame(col, ro, rd, t_safe)[0]
        nx = torch.where(is_box, bn[0], nx)
        ny = torch.where(is_box, bn[1], ny)
        nz = torch.where(is_box, bn[2], nz)
    if flags & FLAG_MEDIUM:
        is_med = col[_GEO - 1] == KIND_MEDIUM
        nx = torch.where(is_med, 1.0, nx)
        ny = torch.where(is_med, 0.0, ny)
        nz = torch.where(is_med, 0.0, nz)
    return nx, ny, nz


def _trunc_clamp(x, size):
    """``int(x)`` truncated toward zero and clamped to
    ``[0, max(size - 1, 0)]`` (``size`` an integral float plane), as the
    reference's ``clip(x.astype(int32), ...)``, whose conversion gives 0
    for a NaN and saturates out of range: ``x`` is first held to
    ``[-1, size]`` by ``fmax``/``fmin`` (which drop a NaN for the other
    operand, -1), so no conversion leaves int32 and every device agrees."""
    v = torch.fmin(torch.fmax(x, x.new_tensor(-1.0)), size)
    hi = torch.clamp(size.to(torch.int32) - 1, min=0)
    return torch.minimum(torch.clamp(v.to(torch.int32), min=0), hi)


def image_texel_index(col, px, py, pz, time, flags):
    """The atlas texel (ii, jj, the image's first atlas row) of each lane's
    winner, from its row's columns ``col`` and the hit point: the sphere
    UV from ``(p - c) * inv_r`` (the centre lerped to ``time`` under
    ``FLAG_MOTION``), u = 1 - (atan2(nx, ny) + pi) / (2 pi), v = (asin(ny)
    + pi / 2) / pi; under ``FLAG_RECT`` a rect row's in-plane fractions
    (no flip: both sides read the same texel). Then ii = int(u w), jj =
    int((1 - v) h - 0.001), clamped into the image whose (y-offset,
    height, width) end the row. The twin of the JAX package's
    ``_image_rgb_planes`` (``fastpath.py:1121``) up to its gather, in its
    order and with its constants."""
    cx, cy, cz, r = col[_GEO], col[_GEO + 1], col[_GEO + 2], col[_GEO + 8]
    if flags & FLAG_MOTION:
        s = (time - col[_GEO + 6]) * col[_GEO + 7]
        cx = cx + s * col[_GEO + 3]
        cy = cy + s * col[_GEO + 4]
        cz = cz + s * col[_GEO + 5]
    inv_r = 1.0 / torch.where(torch.abs(r) < 1e-12, 1.0, r)
    nx = (px - cx) * inv_r
    ny = (py - cy) * inv_r
    phi = torch.atan2(nx, ny)
    theta = torch.asin(torch.clamp(ny, -1.0, 1.0))
    uu = 1.0 - (phi + 3.14159265) * (0.5 / 3.14159265)
    vv = (theta + 1.5707963) * (1.0 / 3.14159265)
    if flags & FLAG_RECT:
        is_rect = col[_GEO - 1] == KIND_RECT
        axis = col[_GEO].to(torch.int32)
        pa = torch.where(axis == 0, py, px)
        pb = torch.where(axis == 2, py, pz)
        a0, a1, b0, b1 = (col[_GEO + k] for k in range(1, 5))
        da = a1 - a0
        db = b1 - b0
        da = torch.where(torch.abs(da) < 1e-12, 1.0, da)
        db = torch.where(torch.abs(db) < 1e-12, 1.0, db)
        uu = torch.where(is_rect, (pa - a0) / da, uu)
        vv = torch.where(is_rect, (pb - b0) / db, vv)
    img_y, img_h, img_w = col[-3], col[-2], col[-1]
    ii = _trunc_clamp(uu * img_w, img_w)
    jj = _trunc_clamp((1.0 - vv) * img_h - 0.001, img_h)
    return ii, jj, img_y.to(torch.int32)


def image_rgb_planes(col, px, py, pz, time, atlas, flags):
    """The texel of each lane's winner (:func:`image_texel_index`) read
    from ``atlas`` [H, W, 3]: three [R] planes. Every lane reads one, as
    the reference's pre-pass does; the index is clamped into the atlas."""
    ii, jj, y0 = image_texel_index(col, px, py, pz, time, flags)
    flat = (y0 + jj) * atlas.shape[1] + ii
    texel = atlas.reshape(-1, 3).index_select(0, flat.long())
    return texel.unbind(1)


def albedo_planes(col, px, py, pz, flags, img_rgb=None):
    """The winner's albedo as three [R] planes: its constant colour, the
    checker's odd or even colour, or the marble of the hash turbulence;
    under ``FLAG_IMAGE`` the texel ``img_rgb`` (three planes) on lanes
    whose texture is an image, after the checker and the noise. The twin
    of the JAX package's ``_albedo_planes`` (``fastpath.py:1263``) and of
    the fused kernel's image override (``shade_pallas.py:231-236``)."""
    from pathtrace_tpu_torch.ops.fastpath import fast_turb_c

    tex_kind = col[3]
    rgb = [col[4], col[5], col[6]]
    if flags & FLAG_CHECKER:
        sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
                 * torch.sin(10.0 * pz))
        is_chk = tex_kind == float(TEX_CHECKER)
        neg = sines < 0.0
        rgb = [torch.where(is_chk, torch.where(neg, col[7 + c], col[10 + c]),
                           rgb[c]) for c in range(3)]
    if flags & FLAG_NOISE:
        marble = 0.5 * (1.0 + torch.sin(col[13] * pz
                                        + 10.0 * fast_turb_c(px, py, pz)))
        is_noise = tex_kind == float(TEX_NOISE)
        rgb = [torch.where(is_noise, marble, rgb[c]) for c in range(3)]
    if flags & FLAG_IMAGE:
        is_img = tex_kind == float(TEX_IMAGE)
        rgb = [torch.where(is_img, img_rgb[c], rgb[c]) for c in range(3)]
    return rgb


def shade_from_winners_plain(table, idx, t, planes, time, alive, lane, seed,
                             depth, max_depth, sky4, flags, atlas=None):
    """Plain PyTorch version; same arguments and results as
    :func:`shade_from_winners`."""
    from pathtrace_tpu_torch.ops.fastpath import cbrt_pos, counter_uniform

    a = table.index_select(0, idx.long())            # [R, K] winner rows
    col = [a[:, k] for k in range(a.shape[1])]
    rox, roy, roz, rdx, rdy, rdz = (planes[k] for k in range(6))
    rads = [planes[6 + c] for c in range(3)]
    thrs = [planes[9 + c] for c in range(3)]
    alive_f = alive.to(torch.float32)

    hit = t < _INF
    t_safe = torch.where(hit, t, 0.0)
    px = rox + t_safe * rdx
    py = roy + t_safe * rdy
    pz = roz + t_safe * rdz
    nx, ny, nz = normal_planes(col, (rox, roy, roz), (rdx, rdy, rdz), t_safe,
                               px, py, pz, time, flags)
    img_rgb = None
    if flags & FLAG_IMAGE:
        img_rgb = image_rgb_planes(col, px, py, pz, time, atlas, flags)
    rgb = albedo_planes(col, px, py, pz, flags, img_rgb)

    mat_kind = col[0]
    sky_t = 0.5 * (rdy + 1.0)
    use_grad = sky4[3] > 0.5
    is_light = mat_kind == float(MAT_DIFFUSE_LIGHT)
    nee = bool(flags & FLAG_EMIT_SCALE)
    rad_out = []
    for c in range(3):
        grad_c = (1.0 - sky_t) + sky_t * _SKY_GRADIENT[c]
        sky_c = torch.where(use_grad, grad_c, sky4[c])
        prim_c = torch.where(is_light, rgb[c], 0.0)
        if nee:
            prim_c = prim_c * planes[ESC]
        emit_c = torch.where(hit, prim_c, sky_c)
        rad_out.append(rads[c] + thrs[c] * emit_c * alive_f)

    u1 = counter_uniform(lane, seed, depth, 0)
    u2 = counter_uniform(lane, seed, depth, 1)
    u3 = counter_uniform(lane, seed, depth, 2)
    uc = counter_uniform(lane, seed, depth, 3)
    zz = u1 * 2.0 - 1.0
    aa = u2 * TWO_PI
    rr = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    ux = rr * torch.cos(aa)
    uy = rr * torch.sin(aa)
    uz = zz

    rdotn = rdx * nx + rdy * ny + rdz * nz
    refl_x = rdx - 2.0 * rdotn * nx
    refl_y = rdy - 2.0 * rdotn * ny
    refl_z = rdz - 2.0 * rdotn * nz

    dir_x, dir_y, dir_z = ux, uy, uz
    ok = torch.ones_like(hit)

    if flags & FLAG_DIELECTRIC:
        ref_idx = col[2]
        exiting = rdotn > 0.0
        sgn = torch.where(exiting, -1.0, 1.0)
        ox, oy, oz = sgn * nx, sgn * ny, sgn * nz
        ni = torch.where(exiting, ref_idx, 1.0 / ref_idx)
        cos_in = torch.where(exiting, rdotn, -rdotn)
        ces = 1.0 - ref_idx * ref_idx * (1.0 - cos_in * cos_in)
        cosine = torch.where(
            exiting, torch.sqrt(torch.where(ces > 0.0, ces, 1.0)), cos_in)
        dt_ = rdx * ox + rdy * oy + rdz * oz
        disc = 1.0 - ni * ni * (1.0 - dt_ * dt_)
        refr_ok = disc > 0.0
        sq = torch.sqrt(torch.where(refr_ok, disc, 1.0))
        refr_x = ni * (rdx - ox * dt_) - ox * sq
        refr_y = ni * (rdy - oy * dt_) - oy * sq
        refr_z = ni * (rdz - oz * dt_) - oz * sq
        r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
        r0 = r0 * r0
        omc = 1.0 - cosine
        omc2 = omc * omc
        schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
        reflect_prob = torch.where(refr_ok, schlick, 1.0)
        tr = uc > reflect_prob
        is_diel = mat_kind == float(MAT_DIELECTRIC)
        dir_x = torch.where(is_diel, torch.where(tr, refr_x, refl_x), dir_x)
        dir_y = torch.where(is_diel, torch.where(tr, refr_y, refl_y), dir_y)
        dir_z = torch.where(is_diel, torch.where(tr, refr_z, refl_z), dir_z)

    if flags & FLAG_METAL:
        fr = col[1] * cbrt_pos(u3)
        is_metal = mat_kind == float(MAT_METAL)
        dir_x = torch.where(is_metal, refl_x + fr * ux, dir_x)
        dir_y = torch.where(is_metal, refl_y + fr * uy, dir_y)
        dir_z = torch.where(is_metal, refl_z + fr * uz, dir_z)
        ok = torch.where(is_metal, rdotn < 0.0, ok)

    if flags & FLAG_LAMBERTIAN:
        is_lam = mat_kind == float(MAT_LAMBERTIAN)
        dir_x = torch.where(is_lam, nx + ux, dir_x)
        dir_y = torch.where(is_lam, ny + uy, dir_y)
        dir_z = torch.where(is_lam, nz + uz, dir_z)

    if flags & FLAG_LIGHT:
        ok = ok & ~is_light  # lights never scatter

    inv_len = torch.rsqrt(torch.clamp(
        dir_x * dir_x + dir_y * dir_y + dir_z * dir_z, min=1e-38))
    dir_x, dir_y, dir_z = dir_x * inv_len, dir_y * inv_len, dir_z * inv_len

    atten = rgb
    if flags & FLAG_DIELECTRIC:
        atten = [torch.where(is_diel, 1.0, rgb[c]) for c in range(3)]

    can = alive & hit & ok & (depth < max_depth)
    rows = [
        torch.where(can, px, rox), torch.where(can, py, roy),
        torch.where(can, pz, roz),
        torch.where(can, dir_x, rdx), torch.where(can, dir_y, rdy),
        torch.where(can, dir_z, rdz),
        rad_out[0], rad_out[1], rad_out[2],
        torch.where(can, thrs[0] * atten[0], thrs[0]),
        torch.where(can, thrs[1] * atten[1], thrs[1]),
        torch.where(can, thrs[2] * atten[2], thrs[2]),
    ]
    if nee:
        rows += [planes[ESC], nx, ny, nz, *rgb]
    return torch.stack(rows), can


def _int32(x: int) -> int:
    """The int32 whose bit pattern is ``x mod 2**32``."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _check(table, idx, t, planes, time, alive, lane, sky4, atlas,
           n_planes: int, k_min: int) -> None:
    dev = t.device
    R = t.shape[0]
    for name, x, dtype, shape in (
        ("table", table, torch.float32, None),
        ("idx", idx, torch.int32, (R,)),
        ("t", t, torch.float32, (R,)),
        ("planes", planes, torch.float32, None),
        ("time", time, torch.float32, (R,)),
        ("alive", alive, torch.bool, (R,)),
        ("lane", lane, torch.int32, (R,)),
        ("sky4", sky4, torch.float32, (4,)),
        ("atlas", atlas, torch.float32, None),
    ):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, t on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if name != "planes" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 2 or table.shape[1] < k_min:
        raise ValueError(f"table must be [N, >={k_min}], got "
                         f"{tuple(table.shape)}")
    if planes.dim() != 2 or planes.shape[0] < n_planes or planes.shape[1] != R:
        raise ValueError(f"planes must be [>={n_planes}, R], got "
                         f"{tuple(planes.shape)}")
    if planes.stride(1) != 1:
        raise ValueError("planes rows must be unit-stride")
    if atlas is not None and (atlas.dim() != 3 or atlas.shape[2] != 3):
        raise ValueError(f"atlas must be [H, W, 3], got {tuple(atlas.shape)}")


def shade_from_winners(table, idx, t, planes, time, alive, lane, seed: int,
                       depth: int, max_depth: int, sky4, flags: int,
                       atlas=None):
    """Shade and scatter one wavefront.

    ``table`` [N, 24] winner rows (spheres, then with ``FLAG_RECT`` the
    rect block; [N, 48] with ``FLAG_BOX`` or ``FLAG_MEDIUM``, the box and
    medium blocks after it; [N, 28] with ``FLAG_IMAGE``, whose rows end in
    their texture's atlas entry); ``atlas`` [H, W, 3] the scene's image
    atlas, which ``FLAG_IMAGE`` needs (its width is the row stride of the
    texel reads); ``idx`` [R] int32 and ``t`` [R] f32 from
    the closest hit; ``planes`` [12, R] (ro xyz, rd xyz, radiance rgb,
    throughput rgb; [13, R] with the MIS weight under ``FLAG_EMIT_SCALE``),
    ``time`` [R], ``alive`` [R] bool, ``lane`` [R] int32 (the 15 state
    planes);
    ``seed`` the int32 bounce seed; ``sky4`` [4] (sky rgb,
    use_gradient_sky); ``flags`` the FLAG_* bitmask.
    Returns (planes [12, R] f32, alive [R] bool): 13 output planes. Under
    ``FLAG_EMIT_SCALE`` the planes are [19, R]: the 12, the MIS weight
    copied through (row ``ESC``), the normal (rows ``NORMAL``) and the
    albedo (rows ``ALBEDO``).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot launch)."""
    global LAUNCHES, PLAIN_CALLS
    n_out = 19 if flags & FLAG_EMIT_SCALE else 12
    if flags & FLAG_IMAGE and atlas is None:
        raise ValueError("FLAG_IMAGE needs the atlas")
    # a box row reads up to its world_from_obj at columns 33-41; an image
    # row ends in its three atlas columns
    _check(table, idx, t, planes, time, alive, lane, sky4,
           atlas if flags & FLAG_IMAGE else None,
           13 if flags & FLAG_EMIT_SCALE else 12,
           _GEO + 27 if flags & FLAG_BOX
           else _GEO + 13 if flags & FLAG_IMAGE else _GEO + 9)
    if t.device.type == "cpu":
        PLAIN_CALLS += 1
        return shade_from_winners_plain(table, idx, t, planes, time, alive,
                                        lane, seed, depth, max_depth, sky4,
                                        flags, atlas)
    if t.device.type != "cuda":
        raise ValueError(f"shade_from_winners: unsupported device {t.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R = t.shape[0]
    out = torch.empty((n_out, R), dtype=torch.float32, device=t.device)
    alive_out = torch.empty(R, dtype=torch.bool, device=t.device)
    if R == 0:
        return out, alive_out
    stream = torch.cuda.current_stream(t.device).cuda_stream
    image = bool(flags & FLAG_IMAGE)
    code = lib.pt_shade_from_winners(
        table.data_ptr(), table.shape[1],
        atlas.data_ptr() if image else None, atlas.shape[1] if image else 0,
        idx.data_ptr(), t.data_ptr(), planes.data_ptr(), planes.stride(0),
        time.data_ptr(), alive.data_ptr(), lane.data_ptr(), R,
        _int32(seed), int(depth), int(max_depth), sky4.data_ptr(), int(flags),
        out.data_ptr(), alive_out.data_ptr(), stream,
    )
    _cuda_build.check(code, "shade_from_winners launch")
    LAUNCHES += 1
    return out, alive_out
