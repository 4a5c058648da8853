"""Material scatter for the ray wavefront (counterpart of
``pathtrace_tpu/ops/bsdf.py``), the general integrator's shading.

Every lobe is computed for every lane and the material kind selects:
Lambertian ``normalize(n + unit vector)``; metal ``reflect(d, n) + fuzz
* in-unit-sphere``, absorbed when the unfuzzed reflection is below the
horizon; dielectric, refraction or reflection by Schlick's probability
(reflection where refraction is impossible); isotropic, a uniform
direction; diffuse light, no scatter and its texture as emission. One
texture evaluation serves every lobe (a dielectric's attenuation is
white). The four uniforms of a lane are, in column order, the two of the
unit vector, the third of the in-unit-sphere radius and the dielectric's
choice. The dielectric's choice is detached from autograd, so gradients
flow through the chosen branch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtrace_tpu_torch.models.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    Scene,
    SceneFeatures,
)
from pathtrace_tpu_torch.ops import math as pmath
from pathtrace_tpu_torch.ops.intersect import HitRecord
from pathtrace_tpu_torch.ops.texture import texture_value


class ScatterResult(NamedTuple):
    attenuation: torch.Tensor  # [R, 3]
    direction: torch.Tensor    # [R, 3] unit
    ok: torch.Tensor           # [R] bool, False: absorbed or a light
    emitted: torch.Tensor      # [R, 3]


def scatter(scene: Scene, rec: HitRecord, ray_dir: torch.Tensor,
            uniforms: torch.Tensor, features: SceneFeatures) -> ScatterResult:
    """Scatter the lanes at their hit points. ``ray_dir``: [R, 3] unit
    incoming directions; ``uniforms``: [R, 4]."""
    f = features
    mats = scene.materials
    mat_id = rec.mat_id
    kind = mats.kind[mat_id]
    fuzz = mats.fuzz[mat_id]
    ref_idx = mats.ref_idx[mat_id]
    tex_id = mats.tex_id[mat_id]
    tex_rgb = texture_value(scene, tex_id, rec.u, rec.v, rec.point, f)

    u1, u2, u3, u_choice = (uniforms[..., i] for i in range(4))
    n = rec.normal
    d = ray_dir
    unit_vec = pmath.random_unit_vector(u1, u2)

    is_lam = kind == MAT_LAMBERTIAN
    is_metal = kind == MAT_METAL
    is_diel = kind == MAT_DIELECTRIC
    is_light = kind == MAT_DIFFUSE_LIGHT

    # the isotropic phase function is the default lobe
    direction = unit_vec
    ok = torch.ones(kind.shape, dtype=torch.bool, device=kind.device)

    if f.has_dielectric:
        rdotn = pmath.dot(d, n, keepdims=False)
        exiting = rdotn > 0.0
        outward_n = torch.where(exiting[..., None], -n, n)
        ni_over_nt = torch.where(exiting, ref_idx, 1.0 / ref_idx)
        cos_in = torch.where(exiting, rdotn, -rdotn)
        # the exit-side cosine folds the index in
        cos_exit_sq = 1.0 - ref_idx * ref_idx * (1.0 - cos_in * cos_in)
        safe_sq = torch.where(cos_exit_sq > 0.0, cos_exit_sq, 1.0)
        cosine = torch.where(exiting, torch.sqrt(safe_sq), cos_in)
        refr, refr_ok = pmath.refract(d, outward_n, ni_over_nt)
        reflect_prob = torch.where(refr_ok, pmath.schlick(cosine, ref_idx), 1.0)
        take_refract = u_choice > reflect_prob.detach()
        diel_dir = torch.where(take_refract[..., None], refr,
                               pmath.reflect(d, n))
        direction = torch.where(is_diel[..., None], diel_dir, direction)

    if f.has_metal:
        reflected = pmath.reflect(d, n)
        metal_ok = pmath.dot(reflected, n, keepdims=False) > 0.0
        metal_dir = reflected + fuzz[..., None] * pmath.random_in_unit_sphere(
            u1, u2, u3)
        direction = torch.where(is_metal[..., None], metal_dir, direction)
        ok = torch.where(is_metal, metal_ok, ok)

    if f.has_lambertian:
        direction = torch.where(is_lam[..., None], n + unit_vec, direction)

    # one normalize after the select (normalize of a select = select of
    # the normalized lobes)
    direction = pmath.normalize(direction)

    attenuation = (torch.where(is_diel[..., None], torch.ones_like(tex_rgb),
                               tex_rgb) if f.has_dielectric else tex_rgb)
    if f.has_light:
        ok = torch.where(is_light, False, ok)
        emitted = torch.where(is_light[..., None], tex_rgb,
                              torch.zeros_like(tex_rgb))
    else:
        emitted = torch.zeros_like(tex_rgb)
    return ScatterResult(attenuation=attenuation, direction=direction, ok=ok,
                         emitted=emitted)
