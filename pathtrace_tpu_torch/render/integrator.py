"""The general wavefront integrator (counterpart of
``pathtrace_tpu/render/integrator.py``).

One bounce advances the whole [R] wavefront: the closest hit over every
primitive kind with its record (:mod:`~pathtrace_tpu_torch.ops.intersect`:
K1 or K3 on world-space spheres), emission or sky, the material scatter
(:mod:`~pathtrace_tpu_torch.ops.bsdf`, textures included), then the next
rays. The running throughput carries the attenuation product, so
``radiance += throughput * (emitted or sky)`` at each bounce.

Two drivers share the bounce:

* :func:`trace`, the forward renderer: bounces while ``depth <=
  max_depth`` and some lane is alive, reading the alive flag back once a
  bounce, as the reference's ``while_loop`` exits early. A bounce sweeps
  and shades only the alive lanes (their indices come with that one
  readback); a dead lane's state stays as it was, as the reference's
  masked lanes do, so the result is the same. On the card this is
  faster than sweeping and shading every lane with the dead ones masked
  (``tools/general_ab.py`` times the two in turns).
* :func:`trace_diff`, differentiable: a fixed ``max_depth + 1`` bounces
  over every lane, under autograd (the spheres through
  ``SphereNearest``, whose backward is K6).

Both take an ``intersect_fn`` in place of the per-kind sweep (``-B``:
``models.bvh.make_bvh_intersect_fn``, the whole-scene tree's traversal
kernel and the winners' records), for the bounce's hit and the NEE
shadow rays, as the reference's ``_bounce`` does.

Both run next-event estimation with MIS (``nee_lights``: one light sample
and shadow ray per diffuse vertex, the power heuristic between light and
BSDF sampling, the BSDF side's weight carried to the next emission hit)
and Russian roulette from ``rr_start``. The draws are the reference's:
``jax.random.uniform`` under ``kb = fold_in(key, depth)``: ``fold_in(kb,
0)`` the [R, n_media] free-flight uniforms, ``fold_in(kb, 1)`` the [R, 4]
scatter uniforms, ``fold_in(kb, 2)`` the [R, 3] light samples,
``fold_in(kb, 3)`` the shadow rays' free flights and ``fold_in(kb, 4)``
the roulette's [R] uniforms, drawn by the Threefry twin (on the card its
kernel) over the whole wavefront, so lane i draws what the reference's
lane i draws. ``ray_count`` counts the segments traced plus the shadow
rays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pathtrace_tpu_torch.models.types import (
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    Scene,
    SceneFeatures,
)
from pathtrace_tpu_torch.ops import bsdf
from pathtrace_tpu_torch.ops import intersect as isect
from pathtrace_tpu_torch.ops import lights as plights
from pathtrace_tpu_torch.ops.texture import texture_value
from pathtrace_tpu_torch.utils import threefry

_INV_PI = 1.0 / 3.141592653589793

READBACKS = 0  # alive-lane readbacks of trace (one a bounce, and the last)
BOUNCES = 0    # bounces trace ran (each over its alive lanes)


def sky_color(scene: Scene, rd: torch.Tensor) -> torch.Tensor:
    """Sky radiance of escaped rays: the gradient ``(1 - t) white + t *
    0.3 (0.5, 0.7, 1.0)``, ``t = 0.5 (dir.y + 1)``, or the constant
    ``scene.sky``, by ``use_gradient_sky``."""
    t = 0.5 * (rd[..., 1] + 1.0)
    tint = torch.tensor([0.5, 0.7, 1.0], dtype=rd.dtype, device=rd.device) * 0.3
    grad = (1.0 - t)[..., None] + t[..., None] * tint
    const = scene.sky.to(rd.dtype).expand(rd.shape)
    return torch.where(scene.use_gradient_sky > 0.5, grad, const)


class GeneralTables(NamedTuple):
    """Per-trace operands: the sphere kernels' operand (None without
    world-space spheres) and the NEE lights' texture ids on the device."""

    soa: Optional[torch.Tensor]
    light_tex: Optional[torch.Tensor]


def prep_tables(scene: Scene, features: SceneFeatures,
                nee_lights: Optional[plights.LightTable] = None) -> GeneralTables:
    """The operands of a trace, on the scene's device: K1's [5, N] (K3's
    [12, N] in a scene with moving spheres) from the scene's spheres."""
    from pathtrace_tpu_torch.ops.fastpath import build_sphere_soa

    soa = None
    if features.has_spheres and not scene.spheres.instanced:
        soa = build_sphere_soa(scene, motion=features.has_motion)
    light_tex = None
    if nee_lights is not None:
        light_tex = torch.from_numpy(nee_lights.tex_id.astype("int64")).to(
            scene.sky.device)
    return GeneralTables(soa=soa, light_tex=light_tex)


class WavefrontState(NamedTuple):
    depth: int
    ro: torch.Tensor          # [R, 3]
    rd: torch.Tensor          # [R, 3]
    time: torch.Tensor        # [R]
    radiance: torch.Tensor    # [R, 3]
    throughput: torch.Tensor  # [R, 3]
    alive: torch.Tensor       # [R] bool
    ray_count: torch.Tensor   # [] int64: segments plus shadow rays
    # the MIS weight of this lane's next emission hit (1 where the last
    # vertex ran no NEE)
    emit_scale: torch.Tensor  # [R]


def _initial_state(ro, rd, time) -> WavefrontState:
    live = time == time  # NaN-padded lanes are born dead
    return WavefrontState(
        depth=0, ro=ro, rd=rd, time=time,
        radiance=torch.zeros_like(ro), throughput=torch.ones_like(ro),
        alive=live,
        ray_count=torch.zeros((), dtype=torch.int64, device=ro.device),
        emit_scale=live.to(ro.dtype),
    )


def _bounce(scene: Scene, tables: GeneralTables, state: WavefrontState,
            key: torch.Tensor, max_depth: int, features: SceneFeatures,
            nee_lights=None, rr_start: int = 0,
            lanes: Optional[torch.Tensor] = None,
            differentiable: bool = False,
            intersect_fn=None) -> WavefrontState:
    """One bounce. ``lanes`` (int64 indices of the alive lanes): sweep and
    shade those only and write them back; None: every lane, dead ones
    masked, as the reference computes. ``intersect_fn`` (``-B``:
    ``models.bvh.make_bvh_intersect_fn``) replaces the per-kind sweep as
    the closest hit of the bounce and of the NEE shadow rays."""
    f = features
    R = state.time.shape[0]
    dev = state.ro.device
    kb = threefry.fold_in(key, state.depth)

    def draw(j, shape):
        return threefry.uniform(threefry.fold_in(kb, j), shape, dev)

    n_media = scene.media.count
    med_u = draw(0, (R, n_media)) if f.has_media else None
    scat_u = draw(1, (R, 4))
    if nee_lights is not None:
        lu = draw(2, (R, 3))
        smed_u = draw(3, (R, n_media)) if f.has_media else None
    if rr_start > 0:
        rr_u = draw(4, (R,))

    if lanes is not None:
        def sub(x):
            return None if x is None else x.index_select(0, lanes)
    else:
        def sub(x):
            return x
    ro, rd, time = sub(state.ro), sub(state.rd), sub(state.time)
    throughput, emit_scale = sub(state.throughput), sub(state.emit_scale)
    alive = (torch.ones(lanes.shape[0], dtype=torch.bool, device=dev)
             if lanes is not None else state.alive)

    if intersect_fn is not None:
        rec = intersect_fn(scene, ro, rd, time, sub(med_u))
    else:
        rec = isect.intersect_scene(scene, ro, rd, time, sub(med_u),
                                    tables.soa, f, differentiable)
    sc = bsdf.scatter(scene, rec, rd, sub(scat_u), f)

    alive_f = alive.to(ro.dtype)[..., None]
    sky = sky_color(scene, rd)
    emitted = sc.emitted
    if nee_lights is not None:
        # the previous vertex's light sample owns (1 - emit_scale) of this
        # emission; the sky is untouched
        emitted = emitted * emit_scale[..., None]
    emit_term = torch.where(rec.hit[..., None], emitted, sky)
    radiance = sub(state.radiance) + throughput * emit_term * alive_f

    can_scatter = alive & rec.hit & sc.ok & (state.depth < max_depth)
    emit_scale_next = (time == time).to(ro.dtype)
    shadow_rays = None
    if nee_lights is not None:
        mat_kind = scene.materials.kind[rec.mat_id]
        is_lam = mat_kind == MAT_LAMBERTIAN
        diffuse = is_lam | (mat_kind == MAT_ISOTROPIC)
        nee_mask = can_scatter & diffuse
        safe_p = torch.where(nee_mask[..., None], rec.point,
                             torch.zeros_like(rec.point))
        wi, ldist, lpdf, lidx, lvalid = plights.sample_light_dirs(
            nee_lights, safe_p, sub(lu))
        nee_mask = nee_mask & lvalid
        with torch.no_grad():
            if intersect_fn is not None:
                srec = intersect_fn(scene, safe_p, wi, time, sub(smed_u))
            else:
                srec = isect.intersect_scene(scene, safe_p, wi, time,
                                             sub(smed_u), tables.soa, f)
        # unoccluded unless something lands strictly before the sample
        unoccluded = ~(srec.hit & (srec.t < ldist * (1.0 - 1e-3)))
        light_p = safe_p + wi * ldist[..., None]
        half = torch.full_like(ldist, 0.5)
        le = texture_value(scene, tables.light_tex[lidx.long()], half, half,
                           light_p, f)
        safe_n = torch.where(nee_mask[..., None], rec.normal,
                             torch.zeros_like(rec.normal))
        cos_s = torch.clamp((wi * safe_n).sum(-1), min=0.0)
        # Lambertian f cos = albedo cos / pi; isotropic = albedo / (4 pi)
        f_term = torch.where(is_lam[..., None],
                             sc.attenuation * (cos_s * _INV_PI)[..., None],
                             sc.attenuation * (0.25 * _INV_PI))
        p_b_nee = torch.where(is_lam, cos_s * _INV_PI, 0.25 * _INV_PI)
        w_light = lpdf * lpdf / torch.clamp(lpdf * lpdf + p_b_nee * p_b_nee,
                                            min=1e-20)
        contrib = throughput * f_term * le * (
            w_light / torch.clamp(lpdf, min=1e-12))[..., None]
        radiance = radiance + torch.where((nee_mask & unoccluded)[..., None],
                                          contrib, torch.zeros_like(contrib))
        # the BSDF side's weight on the emission the scattered ray meets
        cos_b = torch.clamp((sc.direction * safe_n).sum(-1), min=0.0)
        p_b_next = torch.where(is_lam, cos_b * _INV_PI, 0.25 * _INV_PI)
        p_l_next = plights.light_dir_pdf(nee_lights, safe_p, sc.direction)
        w_bsdf = p_b_next * p_b_next / torch.clamp(
            p_b_next * p_b_next + p_l_next * p_l_next, min=1e-20)
        emit_scale_next = torch.where(nee_mask & (p_l_next > 0.0), w_bsdf,
                                      emit_scale_next)
        shadow_rays = nee_mask.sum()

    cs = can_scatter[..., None]
    throughput = torch.where(cs, throughput * sc.attenuation, throughput)
    if rr_start > 0:
        # survive with p = the largest throughput channel (floored at
        # 0.05), dividing it back out
        p = torch.clamp(throughput.max(dim=-1).values, 0.05, 1.0)
        if state.depth >= rr_start:
            survive = sub(rr_u) < p
            throughput = torch.where(survive[..., None],
                                     throughput / p[..., None], throughput)
            can_scatter = can_scatter & survive
            cs = can_scatter[..., None]
    ro = torch.where(cs, rec.point, ro)
    rd = torch.where(cs, sc.direction, rd)
    segs = alive.sum() if lanes is None else lanes.shape[0]
    ray_count = state.ray_count + segs
    if shadow_rays is not None:
        ray_count = ray_count + shadow_rays

    if lanes is not None:
        def put(full, part):
            return full.index_copy(0, lanes, part)

        return WavefrontState(
            depth=state.depth + 1,
            ro=put(state.ro, ro), rd=put(state.rd, rd), time=state.time,
            radiance=put(state.radiance, radiance),
            throughput=put(state.throughput, throughput),
            alive=put(torch.zeros_like(state.alive), can_scatter),
            ray_count=ray_count,
            emit_scale=put((state.time == state.time).to(state.ro.dtype),
                           emit_scale_next),
        )
    return WavefrontState(
        depth=state.depth + 1, ro=ro, rd=rd, time=time, radiance=radiance,
        throughput=throughput, alive=can_scatter, ray_count=ray_count,
        emit_scale=emit_scale_next,
    )


def trace(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
          time: torch.Tensor, key: torch.Tensor, max_depth: int,
          features: Optional[SceneFeatures] = None, nee_lights=None,
          rr_start: int = 0,
          tables: Optional[GeneralTables] = None,
          intersect_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward trace with whole-wavefront early exit: (radiance [R, 3],
    ray_count [] int64). ``key``: the Threefry key of the bounces;
    ``intersect_fn``: as :func:`_bounce`'s."""
    features = features or SceneFeatures.from_scene(scene)
    tables = tables or prep_tables(scene, features, nee_lights)
    global READBACKS, BOUNCES
    state = _initial_state(ro, rd, time)
    with torch.no_grad():
        for _ in range(max_depth + 1):
            lanes = torch.nonzero(state.alive).flatten()
            READBACKS += 1
            if lanes.numel() == 0:  # the bounce's one readback
                break
            BOUNCES += 1
            state = _bounce(scene, tables, state, key, max_depth, features,
                            nee_lights, rr_start, lanes=lanes,
                            intersect_fn=intersect_fn)
    return state.radiance, state.ray_count


def trace_diff(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
               time: torch.Tensor, key: torch.Tensor, max_depth: int,
               features: Optional[SceneFeatures] = None, nee_lights=None,
               rr_start: int = 0,
               tables: Optional[GeneralTables] = None,
               intersect_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable trace: the full ``max_depth + 1`` bounces over every
    lane; the same estimator as :func:`trace`. Through an
    ``intersect_fn`` (a BVH) t carries no gradient; the records' points
    still do, through the rays."""
    features = features or SceneFeatures.from_scene(scene)
    tables = tables or prep_tables(scene, features, nee_lights)
    state = _initial_state(ro, rd, time)
    for _ in range(max_depth + 1):
        state = _bounce(scene, tables, state, key, max_depth, features,
                        nee_lights, rr_start, differentiable=True,
                        intersect_fn=intersect_fn)
    return state.radiance, state.ray_count
