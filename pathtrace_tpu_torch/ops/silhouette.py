"""Silhouette (visibility) gradients by edge sampling (counterpart of
``pathtrace_tpu/ops/silhouette.py``).

The interior autodiff of the differentiable traces differentiates the
integrand but not the integration domain: moving a sphere moves the
visibility discontinuity, and that boundary term is invisible to
autograd. This module adds it by explicit edge sampling (Li et al. 2018,
"redner"). For a pixel-area-normalized image I and scene parameter θ,

    dI_p/dθ = (interior term)
            + ∮_edges (L_in − L_out)(x) · (n̂_⊥ · dP(x)/dθ) h_p(P(x)) dl,

with P the film projection, n̂_⊥ the image-space outward edge normal and
h_p the box pixel filter. Three edge families are sampled under primary
visibility: the visible contour of a sphere (a closed-form circle; moving
spheres at per-sample shutter times, an aperture camera at per-sample
lens points), the four boundary segments of a rect, and the twelve edges
of a box where one adjacent face is front-facing. (L_in − L_out) comes
from ray pairs straddling the edge, traced through the general
integrator (:func:`~pathtrace_tpu_torch.render.integrator.trace`: the
closest-hit kernel on world-space spheres); occluded edge segments
cancel (L_in ≈ L_out). The image-space cotangent is pulled back through
the projection chain by one ``torch.autograd.grad``.

Every draw is the reference's: ``threefry.uniform(fold_in(key, i), ...)``
with its ``i`` (angles 0, pair bounces 1, lens points 2, shutter times
3), so a key gives the reference's samples. Indirect silhouettes (shadow
and reflection edges) are not sampled, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pathtrace_tpu_torch.camera import Camera, get_rays
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops import math as pmath
from pathtrace_tpu_torch.render import integrator
from pathtrace_tpu_torch.utils import threefry

TWO_PI = 6.283185307179586


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Last-axis 3-vector dot product, summed x, y, z in that order."""
    return pmath.dot(a, b, keepdims=False)


def _film_scale(width: int, height: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([float(width), float(height)], dtype=like.dtype,
                        device=like.device)


def project_to_film(camera: Camera, x: torch.Tensor,
                    offset: Optional[torch.Tensor] = None):
    """World point -> film coordinates (s, t) in [0, 1]^2 and the
    in-front mask. Inverts ``get_rays``: the ray (origin + offset) -> x
    meets the focus plane, expressed in the film basis. ``x`` is
    [..., 3]; ``offset`` (broadcastable [..., 3]) is a lens-disk offset."""
    o = camera.origin if offset is None else camera.origin + offset
    dw = x - o
    plane = _dot(camera.lower_left_corner - o, camera.w)
    denom = _dot(dw, camera.w)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    k = plane / denom
    q = o + k[..., None] * dw
    rel = q - camera.lower_left_corner
    s = _dot(rel, camera.u) / _dot(camera.horizontal, camera.u)
    t = _dot(rel, camera.v) / _dot(camera.vertical, camera.v)
    in_front = denom < 0.0  # w points backward from the view direction
    return s, t, in_front


def _contour_points(origin: torch.Tensor, center: torch.Tensor,
                    radius: torch.Tensor, phis: torch.Tensor) -> torch.Tensor:
    """Visible-contour circles of spheres: ``center`` [S, M, 3] (each
    sample's centre), ``radius`` [S], ``phis`` [M], ``origin`` [3] or
    [M, 3] (per-sample lens points) -> [S, M, 3]. Differentiable in
    centre and radius."""
    r = torch.abs(radius)[:, None]                           # [S, 1]
    g = (center - origin).expand(center.shape[0], phis.shape[0], 3)
    d = torch.sqrt(torch.clamp((g * g).sum(-1, keepdim=True), min=1e-12))
    gh = g / d
    d = d[..., 0]
    # a stable in-plane basis per sample
    y_axis = gh.new_tensor([0.0, 1.0, 0.0])
    x_axis = gh.new_tensor([1.0, 0.0, 0.0])
    up = torch.where(torch.abs(gh[..., 1:2]) < 0.9, y_axis, x_axis)
    e1 = torch.linalg.cross(gh, up)
    e1 = e1 / torch.sqrt(torch.clamp((e1 * e1).sum(-1, keepdim=True),
                                     min=1e-12))
    e2 = torch.linalg.cross(gh, e1)
    frac = torch.clamp(1.0 - (r * r) / (d * d), 1e-6, 1.0)
    c_s = center - (r * r / d)[..., None] * gh
    r_s = (r * torch.sqrt(frac))[..., None]
    cs, sn = torch.cos(phis)[:, None], torch.sin(phis)[:, None]
    return c_s + r_s * (cs * e1 + sn * e2)


def _film_points(camera: Camera, centers: torch.Tensor, radii: torch.Tensor,
                 phis: torch.Tensor, offsets: Optional[torch.Tensor] = None):
    """[S, M, 3] per-sample centres x [M] angles -> film points P [S, M, 2]
    and the in-front mask [S, M]. ``offsets`` [M, 3]: per-sample lens
    offsets (aperture > 0); None is the pinhole."""
    o = camera.origin if offsets is None else camera.origin + offsets
    x = _contour_points(o, centers, radii, phis)
    s, t, ok = project_to_film(camera, x, offset=offsets)
    return torch.stack([s, t], dim=-1), ok


def _pixel(x: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(int(x), 0, n - 1)`` with int32 truncation, a NaN giving 0 as
    XLA's conversion does: ``x`` is first held to [-1, n]."""
    v = torch.fmin(torch.fmax(x, x.new_tensor(-1.0)), x.new_tensor(float(n)))
    return torch.clamp(v.to(torch.int32), 0, n - 1).long()


def _edge_radiance_pairs(scene: Scene, camera: Camera, s: torch.Tensor,
                         t: torch.Tensor, n_hat_px: torch.Tensor,
                         eps_px: float, width: int, height: int,
                         key: torch.Tensor, max_depth: int,
                         features: SceneFeatures,
                         lens_uni: Optional[torch.Tensor] = None,
                         time_uni: Optional[torch.Tensor] = None):
    """(L_in − L_out) [K, 3] of ray pairs straddling the edge at film
    points (s, t) [K], ``eps_px`` pixels along the outward normal
    ``n_hat_px`` [K, 2] each way. ``lens_uni`` [K, 2] and ``time_uni``
    [K]: the lens and shutter uniforms the points were projected with,
    which both rays of a pair ride. Both rays of every pair go through one
    ``integrator.trace`` keyed ``key``."""
    duv = torch.stack([n_hat_px[..., 0] / width, n_hat_px[..., 1] / height],
                      dim=-1) * eps_px
    ss = torch.cat([s - duv[..., 0], s + duv[..., 0]])
    tt = torch.cat([t - duv[..., 1], t + duv[..., 1]])
    if lens_uni is None:
        lens2 = torch.full(ss.shape + (2,), 0.5, dtype=ss.dtype,
                           device=ss.device)
    else:
        lens2 = torch.cat([lens_uni, lens_uni])
    if time_uni is None:
        t2 = torch.full(ss.shape + (1,), 0.5, dtype=ss.dtype, device=ss.device)
    else:
        t2 = torch.cat([time_uni, time_uni])[:, None]
    ro, rd, tm = get_rays(camera, ss, tt, torch.cat([lens2, t2], dim=-1))
    radiance, _ = integrator.trace(scene, ro, rd, tm, key, max_depth,
                                   features=features)
    K = s.shape[0]
    return radiance[:K] - radiance[K:]


def _pullback(fn, leaves, cotangent: torch.Tensor):
    """The vector-Jacobian product of ``fn(*leaves)`` with ``cotangent``:
    one ``torch.autograd.grad`` on detached copies of the leaves that
    require grad (zeros for a leaf ``fn`` does not reach)."""
    with torch.enable_grad():
        xs = [x.detach().clone().requires_grad_(True) for x in leaves]
        grads = torch.autograd.grad(fn(*xs), xs, grad_outputs=cotangent,
                                    allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(xs, grads)]


def silhouette_grads(scene: Scene, camera: Camera, width: int, height: int,
                     grad_img: torch.Tensor, key: torch.Tensor,
                     max_depth: int = 4,
                     features: Optional[SceneFeatures] = None,
                     n_samples: int = 128, eps_px: float = 0.5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boundary-term gradients of sphere centres, centre deltas and radii
    (d_center [N, 3], d_center_delta [N, 3], d_radius [N]), to be added
    to the interior gradients. ``grad_img``: [H, W, 3] dLoss/dimage (row 0
    at the bottom). ``n_samples`` stratified jittered angles are shared by
    every sphere; moving spheres are evaluated at per-sample shutter times
    (the pairs ride the same time), an aperture camera at per-sample lens
    points."""
    features = features or SceneFeatures.from_scene(scene)
    sp = scene.spheres
    centers, deltas = sp.center.detach(), sp.center_delta.detach()
    radii = sp.radius.detach()
    dev = centers.device
    S, M = centers.shape[0], n_samples
    jitter = threefry.uniform(threefry.fold_in(key, 0), (M,), dev)
    phis = (torch.arange(M, dtype=torch.float32, device=dev) + jitter) * (
        TWO_PI / M)

    motion = bool(features.has_motion)
    tau = None
    if motion:
        tau = threefry.uniform(threefry.fold_in(key, 3), (M,), dev)
        t_ray = camera.time0 + tau * (camera.time1 - camera.time0)
        sfac = ((t_ray[None, :] - sp.time0.detach()[:, None])
                * sp.inv_time_delta.detach()[:, None])            # [S, M]
    else:
        sfac = torch.zeros((S, M), dtype=torch.float32, device=dev)

    def eff_centers(c, d):
        return c[:, None, :] + sfac[..., None] * d[:, None, :]   # [S, M, 3]

    lens_uni = threefry.uniform(threefry.fold_in(key, 2), (M, 2), dev)
    disk = pmath.random_in_unit_disk(lens_uni[:, 0], lens_uni[:, 1])
    offsets = camera.lens_radius * (disk[:, 0:1] * camera.u
                                    + disk[:, 1:2] * camera.v)  # [M, 3]

    wh = _film_scale(width, height, centers)
    with torch.no_grad():
        # the projected contour's geometry
        c_eff = eff_centers(centers, deltas)
        P, in_front = _film_points(camera, c_eff, radii, phis, offsets)
        Ppx = P * wh
        # the tangent dP/dphi by a central difference at the same (time,
        # lens point) per sample
        eps_phi = 1e-3
        Pp, _ = _film_points(camera, c_eff, radii, phis + eps_phi, offsets)
        Pm, _ = _film_points(camera, c_eff, radii, phis - eps_phi, offsets)
        tangent = (Pp - Pm) * wh / (2.0 * eps_phi)                # [S, M, 2]
        speed = torch.sqrt(torch.clamp((tangent ** 2).sum(-1), min=1e-12))
        n_hat = torch.stack([tangent[..., 1], -tangent[..., 0]],
                            dim=-1) / speed[..., None]
        # outward: away from the projected (per-sample-time) centre
        pc_s, pc_t, _ = project_to_film(camera, c_eff)
        pc = torch.stack([pc_s * width, pc_t * height], dim=-1)
        flip = torch.sign((n_hat * (Ppx - pc)).sum(-1, keepdim=True) + 1e-12)
        n_hat = n_hat * flip

        # the radiance jump across the edge
        dL = _edge_radiance_pairs(
            scene, camera, P[..., 0].reshape(S * M), P[..., 1].reshape(S * M),
            n_hat.reshape(S * M, 2), eps_px, width, height,
            threefry.fold_in(key, 1), max_depth, features,
            lens_uni=lens_uni.repeat(S, 1),
            time_uni=tau.repeat(S) if motion else None,
        ).reshape(S, M, 3)

        # the pixel cotangent at each edge sample
        xi = _pixel(P[..., 0] * width, width)
        yi = _pixel(P[..., 1] * height, height)
        g = grad_img[yi, xi]                                     # [S, M, 3]
        inside = ((P[..., 0] >= 0.0) & (P[..., 0] < 1.0)
                  & (P[..., 1] >= 0.0) & (P[..., 1] < 1.0)
                  & in_front & sp.mask[:, None])
        # (dLoss/dI_p . (L_in - L_out)) |dP/dphi| 2 pi / M per sample
        w = (g * dL).sum(-1) * speed * (TWO_PI / M)
        w = torch.where(inside, w, 0.0)
        cotangent = w[..., None] * n_hat                         # [S, M, 2]

    def film_px(c, d, r):
        Pf, _ = _film_points(camera, eff_centers(c, d), r, phis, offsets)
        return Pf * wh

    d_center, d_delta, d_radius = _pullback(film_px, (centers, deltas, radii),
                                            cotangent)
    return d_center, d_delta, d_radius


# ---------------------------------------------------------------------------
# rect boundary edges and box silhouette edges
# ---------------------------------------------------------------------------
#
# A rect is an open surface: its whole boundary (4 segments) is a visibility
# discontinuity. A box is a convex solid: an edge silhouettes where exactly
# one adjacent face is front-facing, the sign test (n1.(x - o)) (n2.(x - o))
# < 0, evaluated per sample. Both families share the sphere estimator:
# project the samples, trace straddling pairs, weight by the line measure,
# pull the cotangent back through the projection.


def _edge_us(key: torch.Tensor, n_per_edge: int, device):
    """Strictly interior jittered samples [M] and the secant's step."""
    M = n_per_edge
    jit = threefry.uniform(key, (M,), device)
    us = (torch.arange(M, dtype=torch.float32, device=device) + 0.05
          + 0.9 * jit) / M
    return us, 0.04 / M


def _rect_boundary_ab(a0, a1, b0, b1, us):
    """The boundary of [a0, a1] x [b0, b1]: 4 edges x M samples -> (a, b)
    [S, 4M], in the order b = b0 run, a = a1 run, b = b1 run (reversed),
    a = a0 run (reversed): a closed loop in the (a, b) plane."""
    al = a0[:, None] + us[None, :] * (a1 - a0)[:, None]
    bl = b0[:, None] + us[None, :] * (b1 - b0)[:, None]
    ar = a1[:, None] - us[None, :] * (a1 - a0)[:, None]
    br = b1[:, None] - us[None, :] * (b1 - b0)[:, None]
    S, M = al.shape
    a = torch.cat([al, a1[:, None].expand(S, M), ar, a0[:, None].expand(S, M)],
                  dim=1)
    b = torch.cat([b0[:, None].expand(S, M), bl, b1[:, None].expand(S, M), br],
                  dim=1)
    return a, b


def _one_hot(ax: torch.Tensor, dtype) -> torch.Tensor:
    return (torch.arange(3, device=ax.device)[None, :]
            == ax[:, None]).to(dtype)


def _rect_world_pts(axis, k, a0, a1, b0, b1, us):
    """[S, 4M, 3] world points on the rect boundaries (the (axis, a, b)
    frame of the rect sweep)."""
    a, b = _rect_boundary_ab(a0, a1, b0, b1, us)
    a_axis = torch.where(axis == 0, 1, 0)
    b_axis = torch.where(axis == 2, 1, 2)
    return (a[..., None] * _one_hot(a_axis, a.dtype)[:, None, :]
            + b[..., None] * _one_hot(b_axis, a.dtype)[:, None, :]
            + k[:, None, None] * _one_hot(axis, a.dtype)[:, None, :])


def _box_edge_obj(p0, p1, us):
    """Object-space points on the 12 box edges [S, 12M, 3] and the two
    adjacent faces' object normals per sample ([S, 12M, 3] each)."""
    pts, n1s, n2s = [], [], []
    eye = torch.eye(3, dtype=p0.dtype, device=p0.device)
    for e in range(3):
        oa, ob = (e + 1) % 3, (e + 2) % 3
        run = p0[:, e:e + 1] + us[None, :] * (p1[:, e:e + 1] - p0[:, e:e + 1])
        S, M = run.shape
        for sa in (0, 1):
            va = (p1 if sa else p0)[:, oa:oa + 1].expand(S, M)
            for sb in (0, 1):
                vb = (p1 if sb else p0)[:, ob:ob + 1].expand(S, M)
                comps = [None] * 3
                comps[e], comps[oa], comps[ob] = run, va, vb
                pts.append(torch.stack(comps, dim=-1))
                n1s.append(((1.0 if sa else -1.0) * eye[oa]).expand(S, M, 3))
                n2s.append(((1.0 if sb else -1.0) * eye[ob]).expand(S, M, 3))
    return torch.cat(pts, dim=1), torch.cat(n1s, dim=1), torch.cat(n2s, dim=1)


def _edge_family_term(scene, camera, width, height, grad_img, key, max_depth,
                      features, film_px_of, params, center_world, extra_mask,
                      n_samples_total):
    """The shared edge estimator of one primitive family: the
    image-space cotangent [S, K, 2] to pull back through ``film_px_of``.

    ``film_px_of(*params, h)`` -> (Ppx [S, K, 2], in_front [S, K]) at the
    samples shifted by ``h`` steps along the edge parameter (0: the
    samples; 1: the secant's far end). ``center_world`` [S, 3]: a point
    inside each shape, for the outward orientation."""
    wh = _film_scale(width, height, center_world)
    with torch.no_grad():
        P0, in_front = film_px_of(*params, 0.0)
        P1, _ = film_px_of(*params, 1.0)
        tangent = P1 - P0                                    # ∝ dP/du
        speed = torch.sqrt(torch.clamp((tangent ** 2).sum(-1), min=1e-12))
        n_hat = torch.stack([tangent[..., 1], -tangent[..., 0]],
                            dim=-1) / speed[..., None]
        pc_s, pc_t, _ = project_to_film(camera, center_world)
        pc = torch.stack([pc_s * width, pc_t * height], dim=-1)
        flip = torch.sign((n_hat * (P0 - pc[:, None, :])).sum(-1, keepdim=True)
                          + 1e-12)
        n_hat = n_hat * flip

        S, K = P0.shape[:2]
        Pu = P0 / wh                                         # film units
        dL = _edge_radiance_pairs(
            scene, camera, Pu[..., 0].reshape(S * K), Pu[..., 1].reshape(S * K),
            n_hat.reshape(S * K, 2), 0.5, width, height,
            threefry.fold_in(key, 1), max_depth, features,
        ).reshape(S, K, 3)

        xi = _pixel(P0[..., 0], width)
        yi = _pixel(P0[..., 1], height)
        g = grad_img[yi, xi]
        inside = ((Pu[..., 0] >= 0.0) & (Pu[..., 0] < 1.0)
                  & (Pu[..., 1] >= 0.0) & (Pu[..., 1] < 1.0)
                  & in_front & extra_mask)
        # u in [0, 1) per edge with M samples: the secant over h is
        # |dP/du| and the measure is 1/M a sample
        w = (g * dL).sum(-1) * speed * (1.0 / n_samples_total)
        w = torch.where(inside, w, 0.0)
        return w[..., None] * n_hat


def rect_silhouette_grads(scene: Scene, camera: Camera, width: int,
                          height: int, grad_img: torch.Tensor,
                          key: torch.Tensor, max_depth: int = 4,
                          features: Optional[SceneFeatures] = None,
                          n_per_edge: int = 32) -> Dict[str, torch.Tensor]:
    """Boundary-term gradients of the rects' a0, a1, b0, b1 and k."""
    features = features or SceneFeatures.from_scene(scene)
    rc = scene.rects
    params = [x.detach() for x in (rc.a0, rc.a1, rc.b0, rc.b1, rc.k)]
    us, h = _edge_us(threefry.fold_in(key, 0), n_per_edge, params[0].device)

    def film_pts(a0, a1, b0, b1, k, uss=us):
        x = _rect_world_pts(rc.axis, k, a0, a1, b0, b1, uss)
        s, t, ok = project_to_film(camera, x)
        return torch.stack([s * width, t * height], dim=-1), ok

    extra = rc.mask[:, None].expand(rc.count, 4 * n_per_edge)
    cot = _edge_family_term(
        scene, camera, width, height, grad_img, key, max_depth, features,
        lambda *p: film_pts(*p[:5], us + p[5] * h), params,
        _rect_center_world(rc), extra, n_per_edge)
    # the secant is h |dP/du|: divide by h for the line measure
    cot = cot / h
    grads = _pullback(lambda *p: film_pts(*p)[0], params, cot)
    return dict(zip(("rects.a0", "rects.a1", "rects.b0", "rects.b1",
                     "rects.k"), grads))


def _rect_center_world(rc) -> torch.Tensor:
    a_axis = torch.where(rc.axis == 0, 1, 0)
    b_axis = torch.where(rc.axis == 2, 1, 2)
    k = rc.k.detach()
    return ((0.5 * (rc.a0.detach() + rc.a1.detach()))[:, None]
            * _one_hot(a_axis, k.dtype)
            + (0.5 * (rc.b0.detach() + rc.b1.detach()))[:, None]
            * _one_hot(b_axis, k.dtype)
            + k[:, None] * _one_hot(rc.axis, k.dtype))


def _affine_apply(lin: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``lin`` [..., 3, 3] times ``x`` [..., 3], each row summed x, y, z in
    that order."""
    return (lin[..., 0] * x[..., 0:1] + lin[..., 1] * x[..., 1:2]
            + lin[..., 2] * x[..., 2:3])


def box_silhouette_grads(scene: Scene, camera: Camera, width: int,
                         height: int, grad_img: torch.Tensor,
                         key: torch.Tensor, max_depth: int = 4,
                         features: Optional[SceneFeatures] = None,
                         n_per_edge: int = 32) -> Dict[str, torch.Tensor]:
    """Boundary-term gradients of the boxes' p0, p1 and world_from_obj:
    the 12 transformed edges, weighted only where an edge silhouettes (one
    adjacent face front-facing, one back-facing)."""
    features = features or SceneFeatures.from_scene(scene)
    bx = scene.boxes
    p0, p1 = bx.p0.detach(), bx.p1.detach()
    wfo, ofw = bx.world_from_obj.detach(), bx.obj_from_world.detach()
    us, h = _edge_us(threefry.fold_in(key, 0), n_per_edge, p0.device)

    def world_pts(p0_, p1_, wfo_, uss):
        x_obj, _, _ = _box_edge_obj(p0_, p1_, uss)
        return _affine_apply(wfo_[:, None, :, :3], x_obj) + wfo_[:, None, :, 3]

    # the silhouette mask: the adjacent faces' normals through
    # obj_from_world's transpose (valid for general affines)
    _, n1o, n2o = _box_edge_obj(p0, p1, us)
    ofw_t = ofw[:, None, :, :3].transpose(-1, -2)
    n1, n2 = _affine_apply(ofw_t, n1o), _affine_apply(ofw_t, n2o)
    view = world_pts(p0, p1, wfo, us) - camera.origin
    sil = ((n1 * view).sum(-1) * (n2 * view).sum(-1)) < 0.0
    extra = sil & bx.mask[:, None]

    def film_pts(p0_, p1_, wfo_, uss=us):
        s, t, ok = project_to_film(camera, world_pts(p0_, p1_, wfo_, uss))
        return torch.stack([s * width, t * height], dim=-1), ok

    center = _affine_apply(wfo[:, :, :3], 0.5 * (p0 + p1)) + wfo[:, :, 3]
    cot = _edge_family_term(
        scene, camera, width, height, grad_img, key, max_depth, features,
        lambda *p: film_pts(*p[:3], us + p[3] * h), (p0, p1, wfo), center,
        extra, n_per_edge)
    cot = cot / h
    grads = _pullback(lambda *p: film_pts(*p)[0], (p0, p1, wfo), cot)
    return dict(zip(("boxes.p0", "boxes.p1", "boxes.world_from_obj"), grads))


def silhouette_grads_all(scene: Scene, camera: Camera, width: int,
                         height: int, grad_img: torch.Tensor,
                         key: torch.Tensor, max_depth: int = 4,
                         features: Optional[SceneFeatures] = None,
                         n_samples: int = 128) -> Dict[str, torch.Tensor]:
    """Every boundary term of the scene, keyed by leaf name (the names of
    ``parallel.inverse.split_scene``): the spheres' from ``fold_in(key,
    1)`` (``spheres.center_delta`` too when they move), the rects' from
    ``fold_in(key, 2)`` and the boxes' from ``fold_in(key, 3)``, each
    family with ``max(n_samples // 4, 8)`` samples an edge. Instanced
    spheres hold object-space centres the contour would misread, so their
    term is skipped (the interior gradient still flows through the
    affine)."""
    features = features or SceneFeatures.from_scene(scene)
    out = {}
    if features.has_spheres and not scene.spheres.instanced:
        d_center, d_delta, d_radius = silhouette_grads(
            scene, camera, width, height, grad_img,
            threefry.fold_in(key, 1), max_depth=max_depth,
            features=features, n_samples=n_samples)
        out["spheres.center"] = d_center
        out["spheres.radius"] = d_radius
        if features.has_motion:
            out["spheres.center_delta"] = d_delta
    n_edge = max(n_samples // 4, 8)
    if features.has_rects:
        out.update(rect_silhouette_grads(
            scene, camera, width, height, grad_img, threefry.fold_in(key, 2),
            max_depth=max_depth, features=features, n_per_edge=n_edge))
    if features.has_boxes:
        out.update(box_silhouette_grads(
            scene, camera, width, height, grad_img, threefry.fold_in(key, 3),
            max_depth=max_depth, features=features, n_per_edge=n_edge))
    return out
