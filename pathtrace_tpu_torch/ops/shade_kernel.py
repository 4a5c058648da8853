"""Fused shade/scatter: the CUDA kernel ``csrc/shade.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``pathtrace_tpu/ops/shade_pallas.py``
``_shade_kernel`` together with the winner-row gather and transpose that
``pathtrace_tpu/ops/fastpath.py`` ``_fused_shade_from_winners`` ran before
it: the kernel reads each lane's winner row of the attribute table
itself, so no [R, 24] gather is materialized. Per lane: the hit point and
sphere normal, the albedo (constant, checker, or hash-turbulence marble),
emission or the gradient/constant sky into the radiance, counter-hash
draws 0-3, the Lambertian / metal / dielectric scatter, the normalized
new direction and throughput, and
``alive = alive & hit & ok & depth < max_depth``.

On the card it is bound by bytes: about 120 per lane (15 state planes in,
13 out, t and idx, and the 96-byte winner row from L2), against a few
hundred flops (more with noise textures). One thread per lane; the
feature flags are uniform across a launch, so their branches do not
diverge.

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

TWO_PI = 6.283185307179586
_INF = float(MAX_T)
_GEO = 15
_SKY_GRADIENT = (0.15, 0.21, 0.30)


def shade_from_winners_plain(table, idx, t, planes, time, alive, lane, seed,
                             depth, max_depth, sky4, flags):
    """Plain PyTorch version; same arguments and results as
    :func:`shade_from_winners`."""
    from pathtrace_tpu_torch.ops.fastpath import (
        cbrt_pos, counter_uniform, fast_turb_c,
    )

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
    cx, cy, cz, r = col[_GEO], col[_GEO + 1], col[_GEO + 2], col[_GEO + 8]
    inv_r = 1.0 / torch.where(torch.abs(r) < 1e-12, 1.0, r)
    nx = (px - cx) * inv_r
    ny = (py - cy) * inv_r
    nz = (pz - cz) * inv_r

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

    mat_kind = col[0]
    sky_t = 0.5 * (rdy + 1.0)
    use_grad = sky4[3] > 0.5
    is_light = mat_kind == float(MAT_DIFFUSE_LIGHT)
    rad_out = []
    for c in range(3):
        grad_c = (1.0 - sky_t) + sky_t * _SKY_GRADIENT[c]
        sky_c = torch.where(use_grad, grad_c, sky4[c])
        prim_c = torch.where(is_light, rgb[c], 0.0)
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
    out = torch.stack([
        torch.where(can, px, rox), torch.where(can, py, roy),
        torch.where(can, pz, roz),
        torch.where(can, dir_x, rdx), torch.where(can, dir_y, rdy),
        torch.where(can, dir_z, rdz),
        rad_out[0], rad_out[1], rad_out[2],
        torch.where(can, thrs[0] * atten[0], thrs[0]),
        torch.where(can, thrs[1] * atten[1], thrs[1]),
        torch.where(can, thrs[2] * atten[2], thrs[2]),
    ])
    return out, can


def _int32(x: int) -> int:
    """The int32 whose bit pattern is ``x mod 2**32``."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _check(table, idx, t, planes, time, alive, lane, sky4) -> None:
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
    ):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, t on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if name != "planes" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 2 or table.shape[1] < _GEO + 9:
        raise ValueError(f"table must be [N, >=24], got {tuple(table.shape)}")
    if planes.dim() != 2 or planes.shape[0] < 12 or planes.shape[1] != R:
        raise ValueError(f"planes must be [>=12, R], got {tuple(planes.shape)}")
    if planes.stride(1) != 1:
        raise ValueError("planes rows must be unit-stride")


def shade_from_winners(table, idx, t, planes, time, alive, lane, seed: int,
                       depth: int, max_depth: int, sky4, flags: int):
    """Shade and scatter one wavefront.

    ``table`` [N, 24] winner rows; ``idx`` [R] int32 and ``t`` [R] f32
    from the closest hit; ``planes`` [12, R] (ro xyz, rd xyz, radiance
    rgb, throughput rgb), ``time`` [R], ``alive`` [R] bool, ``lane`` [R]
    int32 (the 15 state planes); ``seed`` the int32 bounce seed; ``sky4``
    [4] (sky rgb, use_gradient_sky); ``flags`` the FLAG_* bitmask.
    Returns (planes [12, R] f32, alive [R] bool): 13 output planes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot launch)."""
    global LAUNCHES, PLAIN_CALLS
    _check(table, idx, t, planes, time, alive, lane, sky4)
    if t.device.type == "cpu":
        PLAIN_CALLS += 1
        return shade_from_winners_plain(table, idx, t, planes, time, alive,
                                        lane, seed, depth, max_depth, sky4,
                                        flags)
    if t.device.type != "cuda":
        raise ValueError(f"shade_from_winners: unsupported device {t.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R = t.shape[0]
    out = torch.empty((12, R), dtype=torch.float32, device=t.device)
    alive_out = torch.empty(R, dtype=torch.bool, device=t.device)
    if R == 0:
        return out, alive_out
    stream = torch.cuda.current_stream(t.device).cuda_stream
    code = lib.pt_shade_from_winners(
        table.data_ptr(), table.shape[1],
        idx.data_ptr(), t.data_ptr(), planes.data_ptr(), planes.stride(0),
        time.data_ptr(), alive.data_ptr(), lane.data_ptr(), R,
        _int32(seed), int(depth), int(max_depth), sky4.data_ptr(), int(flags),
        out.data_ptr(), alive_out.data_ptr(), stream,
    )
    _cuda_build.check(code, "shade_from_winners launch")
    LAUNCHES += 1
    return out, alive_out
