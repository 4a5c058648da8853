"""The light table and light sampling of next-event estimation (NEE).

Counterpart of ``pathtrace_tpu/ops/lights.py``: :func:`build_light_table`
collects the emissive spheres and rects on the host, and the plane forms
:func:`sample_light_dirs_planes` and :func:`light_dir_pdf_planes` sample
one light per lane and give the density of a direction, on [R] planes,
with a Python loop over the (one or two) lights. :func:`sample_light_dirs`
and :func:`light_dir_pdf`, the general integrator's [R, 3] forms, run
the plane forms on the columns (the reference's array forms select the
same values). Each lane picks light
``min(int(u0 * L), L - 1)``; a sphere light samples the cone of its
visible cap, a rect light a uniform point of its area (double-sided).
The densities are solid-angle densities including the 1/L light choice.

The table is numpy on the host, static for a trace. Each light's kind and
axis choose its branch in Python (the reference computes both branches and
selects; the values it keeps are the same), and the constants that
depend on the light alone are computed once, in float32, as the reference
rounds them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pathtrace_tpu_torch.models.types import (
    MAT_DIFFUSE_LIGHT,
    TEX_CONSTANT,
    Scene,
)

_TWO_PI = 2.0 * np.pi
_PDF_INF = 3.0e38
# in-plane axes of a rect whose normal is axis n (as in the rect sweep)
_RECT_AXES = ((1, 2), (0, 2), (0, 1))
_f32 = np.float32


class LightTable(NamedTuple):
    """[L] host arrays of the emissive primitives (kind 0: sphere, 1:
    rect). ``color`` is the emission, resolved when every light's texture
    is a constant, else None."""

    kind: np.ndarray    # [L] int32
    center: np.ndarray  # [L, 3] f32 (zeros for rects)
    radius: np.ndarray  # [L] f32 (|radius|)
    axis: np.ndarray    # [L] int32, a rect's normal axis
    a0: np.ndarray      # [L] f32
    a1: np.ndarray
    b0: np.ndarray
    b1: np.ndarray
    k: np.ndarray
    tex_id: np.ndarray  # [L] int32
    color: Optional[np.ndarray] = None  # [L, 3] f32

    @property
    def count(self) -> int:
        return int(self.kind.shape[0])


def build_light_table(scene: Scene) -> Optional[LightTable]:
    """The live emissive spheres, then the live emissive rects, in index
    order; None when the scene has none (its render then needs no NEE)."""
    mats = scene.materials.kind.cpu().numpy()
    mat_tex = scene.materials.tex_id.cpu().numpy()
    rows = []
    sp = scene.spheres
    sp_mat = sp.mat_id.cpu().numpy()
    centers = sp.center.detach().cpu().numpy()
    radii = sp.radius.detach().cpu().numpy()
    for i in np.nonzero(sp.mask.cpu().numpy())[0]:
        if mats[sp_mat[i]] == MAT_DIFFUSE_LIGHT:
            rows.append(dict(kind=0, center=centers[i],
                             radius=abs(float(radii[i])), axis=0, a0=0.0,
                             a1=0.0, b0=0.0, b1=0.0, k=0.0,
                             tex_id=int(mat_tex[sp_mat[i]])))
    rc = scene.rects
    rc_mat = rc.mat_id.cpu().numpy()
    leaves = {n: getattr(rc, n).detach().cpu().numpy()
              for n in ("axis", "a0", "a1", "b0", "b1", "k")}
    for i in np.nonzero(rc.mask.cpu().numpy())[0]:
        if mats[rc_mat[i]] == MAT_DIFFUSE_LIGHT:
            rows.append(dict(kind=1, center=np.zeros(3), radius=0.0,
                             **{n: (int if n == "axis" else float)(v[i])
                                for n, v in leaves.items()},
                             tex_id=int(mat_tex[rc_mat[i]])))
    if not rows:
        return None
    tex_kinds = scene.textures.kind.cpu().numpy()
    tex_colors = scene.textures.color.cpu().numpy()
    all_const = all(tex_kinds[r["tex_id"]] == TEX_CONSTANT for r in rows)

    def col(name, dtype):
        return np.asarray([r[name] for r in rows], dtype)

    return LightTable(
        kind=col("kind", np.int32),
        center=np.stack([r["center"] for r in rows]).astype(_f32),
        radius=col("radius", _f32), axis=col("axis", np.int32),
        a0=col("a0", _f32), a1=col("a1", _f32), b0=col("b0", _f32),
        b1=col("b1", _f32), k=col("k", _f32), tex_id=col("tex_id", np.int32),
        color=(np.stack([tex_colors[r["tex_id"]] for r in rows]).astype(_f32)
               if all_const else None),
    )


def _sphere_consts(lights: LightTable, l: int):
    """(cx, cy, cz, r^2, r^2 (1 + 1e-4)) of sphere light ``l``, each
    rounded to float32 as the reference computes it."""
    r = _f32(lights.radius[l])
    r2 = r * r
    return (*(float(c) for c in lights.center[l]), float(r2),
            float(r2 * _f32(1.0 + 1e-4)))


def _rect_consts(lights: LightTable, l: int):
    """(axis, a axis, b axis, a0, a1 - a0, b0, b1 - b0, k, area) of rect
    light ``l`` (float32 differences and area)."""
    ax = int(lights.axis[l])
    a0, a1, b0, b1 = (_f32(v[l]) for v in (lights.a0, lights.a1, lights.b0,
                                            lights.b1))
    da, db = a1 - a0, b1 - b0
    return (ax, *_RECT_AXES[ax], float(a0), float(da), float(b0), float(db),
            float(lights.k[l]), float(np.abs(da * db)))


def sample_light_dirs_planes(lights: LightTable, px, py, pz, u0, u1, u2):
    """One light sample per lane from the points (px, py, pz) with the
    uniforms u0 (which light), u1, u2 (where on it): (wix, wiy, wiz,
    distance, pdf, light index int32, valid). ``valid`` is False where the
    sample means nothing (inside a sphere light, a zero solid angle or a
    grazing rect); the caller drops those lanes."""
    L = lights.count
    idx = torch.clamp((u0 * L).to(torch.int32), max=L - 1)
    zero = torch.zeros_like(px)
    wix = wiy = wiz = dist = pdf = zero
    valid = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for l in range(L):
        sel = idx == l
        if lights.kind[l] == 1:
            ax, a_ax, b_ax, a0, da, b0, db, kk, area = _rect_consts(lights, l)
            pa = a0 + u1 * da
            pb = b0 + u2 * db
            lp = [None] * 3
            lp[ax], lp[a_ax], lp[b_ax] = kk, pa, pb
            d = [lp[c] - p for c, p in enumerate((px, py, pz))]
            dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            ld = torch.sqrt(torch.clamp(dist2, min=1e-12))
            lx, ly, lz = d[0] / ld, d[1] / ld, d[2] / ld
            cos_l = torch.abs((lx, ly, lz)[ax])
            lpdf = dist2 / torch.clamp(cos_l * area, min=1e-9)
            lval = cos_l > 1e-6
            if not area > 1e-12:
                lval = torch.zeros_like(lval)
        else:
            cx, cy, cz, r2, r2k = _sphere_consts(lights, l)
            tcx, tcy, tcz = cx - px, cy - py, cz - pz
            d2 = tcx * tcx + tcy * tcy + tcz * tcz
            d = torch.sqrt(torch.clamp(d2, min=1e-12))
            outside = d2 > r2k
            sin2_max = torch.clamp(r2 / torch.clamp(d2, min=1e-12), 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
            cos_t = 1.0 - u1 * (1.0 - cos_max)
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            phi = _TWO_PI * u2
            wx, wy, wz = tcx / d, tcy / d, tcz / d
            # v1 = normalize(cross(w, a)), a = y if |wx| > 0.9 else x
            big_x = torch.abs(wx) > 0.9
            ax_ = torch.where(big_x, 0.0, 1.0)
            ay_ = torch.where(big_x, 1.0, 0.0)
            c1x = -wz * ay_
            c1y = wz * ax_
            c1z = wx * ay_ - wy * ax_
            inv1 = 1.0 / torch.sqrt(torch.clamp(
                c1x * c1x + c1y * c1y + c1z * c1z, min=1e-24))
            v1x, v1y, v1z = c1x * inv1, c1y * inv1, c1z * inv1
            v2x = wy * v1z - wz * v1y
            v2y = wz * v1x - wx * v1z
            v2z = wx * v1y - wy * v1x
            cp, sp = torch.cos(phi) * sin_t, torch.sin(phi) * sin_t
            lx = wx * cos_t + v1x * cp + v2x * sp
            ly = wy * cos_t + v1y * cp + v2y * sp
            lz = wz * cos_t + v1z * cp + v2z * sp
            solid_angle = _TWO_PI * (1.0 - cos_max)
            lpdf = 1.0 / torch.clamp(solid_angle, min=1e-12)
            cos_ray = lx * tcx + ly * tcy + lz * tcz
            disc = torch.clamp(cos_ray * cos_ray - (d2 - r2), min=0.0)
            ld = cos_ray - torch.sqrt(disc)
            lval = outside & (solid_angle > 1e-9)
        wix = torch.where(sel, lx, wix)
        wiy = torch.where(sel, ly, wiy)
        wiz = torch.where(sel, lz, wiz)
        dist = torch.where(sel, ld, dist)
        pdf = torch.where(sel, lpdf, pdf)
        valid = torch.where(sel, lval, valid)
    return wix, wiy, wiz, dist, pdf / L, idx, valid


def light_dir_pdf_planes(lights: LightTable, px, py, pz, wx, wy, wz):
    """The density with which :func:`sample_light_dirs_planes` would give
    the unit direction (wx, wy, wz) from (px, py, pz), for the nearest
    light along it (1/L included); 0 where no light lies along it."""
    t_best = torch.full_like(px, _PDF_INF)
    pdf_best = torch.zeros_like(px)
    any_hit = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    p, w = (px, py, pz), (wx, wy, wz)
    for l in range(lights.count):
        if lights.kind[l] == 1:
            ax, a_ax, b_ax, a0, da, b0, db, kk, area = _rect_consts(lights, l)
            w_n = w[ax]
            t = (kk - p[ax]) / torch.where(torch.abs(w_n) > 1e-9, w_n, 1e-9)
            pa = p[a_ax] + w[a_ax] * t
            pb = p[b_ax] + w[b_ax] * t
            a1, b1 = float(lights.a1[l]), float(lights.b1[l])
            lo_a, hi_a = min(a0, a1), max(a0, a1)
            lo_b, hi_b = min(b0, b1), max(b0, b1)
            in_rect = (pa >= lo_a) & (pa <= hi_a) & (pb >= lo_b) & (pb <= hi_b)
            cos_l = torch.abs(w_n)
            pdf = (t * t) / torch.clamp(cos_l * area, min=1e-9)
            hit = in_rect & (t > 1e-4) & (cos_l > 1e-6)
            if not area > 1e-12:
                hit = torch.zeros_like(hit)
        else:
            cx, cy, cz, r2, r2k = _sphere_consts(lights, l)
            tcx, tcy, tcz = cx - px, cy - py, cz - pz
            d2 = tcx * tcx + tcy * tcy + tcz * tcz
            outside = d2 > r2k
            sin2_max = torch.clamp(r2 / torch.clamp(d2, min=1e-12), 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
            cos_ray = wx * tcx + wy * tcy + wz * tcz
            d = torch.sqrt(torch.clamp(d2, min=1e-12))
            in_cone = cos_ray > cos_max * d
            solid_angle = _TWO_PI * (1.0 - cos_max)
            pdf = 1.0 / torch.clamp(solid_angle, min=1e-12)
            disc = torch.clamp(cos_ray * cos_ray - (d2 - r2), min=0.0)
            t = cos_ray - torch.sqrt(disc)
            hit = outside & in_cone & (solid_angle > 1e-9) & (t > 1e-4)
        t = torch.where(hit, t, _PDF_INF)
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        pdf_best = torch.where(better, pdf, pdf_best)
        any_hit = any_hit | hit
    return torch.where(any_hit, pdf_best / lights.count, 0.0)


def sample_light_dirs(lights: LightTable, point: torch.Tensor,
                      u: torch.Tensor):
    """[R, 3] form of :func:`sample_light_dirs_planes`: ``point`` [R, 3],
    ``u`` [R, 3] uniforms; (wi [R, 3], distance, pdf, light index,
    valid)."""
    wix, wiy, wiz, dist, pdf, idx, valid = sample_light_dirs_planes(
        lights, point[:, 0], point[:, 1], point[:, 2], u[:, 0], u[:, 1],
        u[:, 2])
    return torch.stack([wix, wiy, wiz], dim=-1), dist, pdf, idx, valid


def light_dir_pdf(lights: LightTable, point: torch.Tensor,
                  wd: torch.Tensor) -> torch.Tensor:
    """[R, 3] form of :func:`light_dir_pdf_planes`: [R]."""
    return light_dir_pdf_planes(lights, point[:, 0], point[:, 1],
                                point[:, 2], wd[:, 0], wd[:, 1], wd[:, 2])
