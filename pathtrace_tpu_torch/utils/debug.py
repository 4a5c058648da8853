"""Single-ray debug tracing, the CLI's ``-X`` (counterpart of
``pathtrace_tpu/utils/debug.py``).

The camera's centre ray is traced bounce by bounce; each bounce prints
every primitive kind's nearest candidate, the winning record (t, point,
normal, material) and the scatter decision. With ``-B`` the whole-scene
BVH's descent of the centre ray comes first: every node visited, Miss or
Hit, a leaf with its primitive's test, then the visit census.

The reference moves this trace to its CPU backend; the port runs it on
the caller's device, the card by default: the sphere candidate is K1's
(K3's in a scene with moving spheres), which equals its plain version
bit for bit, so the lines are the CPU's. The uniforms are the
reference's: ``fold_in(PRNGKey(seed), 0)`` the centre ray's lens/time,
per bounce ``kb = fold_in(PRNGKey(seed), depth)``, ``fold_in(kb, 0)`` the
media's free flights and ``fold_in(kb, 1)`` the scatter's; the BVH
descent draws its ray from ``PRNGKey(seed)`` and gives every medium the
uniform 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera, get_rays
from pathtrace_tpu_torch.config import MAX_T
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops import bsdf
from pathtrace_tpu_torch.ops import intersect as isect
from pathtrace_tpu_torch.ops.intersect_box import box_nearest, media_nearest
from pathtrace_tpu_torch.render.integrator import prep_tables
from pathtrace_tpu_torch.utils import threefry


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _center_ray(camera: Camera, key: torch.Tensor, dev: torch.device):
    u = threefry.uniform(key, (1, 3), dev)
    half = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    return get_rays(camera, half, half, u)


def print_bvh_ray_trace(scene: Scene, camera: Camera, seed: int = 0,
                        log=print, device="cuda") -> None:
    """Print the whole-scene BVH descent of the camera's centre ray: every
    node visited, Miss or Hit with its id (a leaf also tests its
    primitive, :func:`~pathtrace_tpu_torch.models.bvh.leaf_candidate`),
    then the visit census."""
    from pathtrace_tpu_torch.models.bvh import build_scene_bvh, leaf_candidate

    dev = torch.device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    features = SceneFeatures.from_scene(scene)
    flat, stats, offsets = build_scene_bvh(scene, seed=seed)
    log(f"bvh stats: {stats}")

    ro, rd, time = _center_ray(camera, threefry.PRNGKey(seed), dev)
    ro_np, rd_np = _np(ro)[0], _np(rd)[0]
    log(f"bvh trace: center ray origin={ro_np} dir={rd_np}")
    med_u = torch.full((1, scene.media.count), 0.5, device=dev)

    rcp = 1.0 / np.where(np.abs(rd_np) < 1e-12, 1e-12, rd_np)
    census = {"visited": 0, "miss": 0, "leaf_tests": 0, "leaf_hits": 0}

    def node_hit(i: int) -> bool:
        d0 = (flat.bb_min[i] - ro_np) * rcp
        d1 = (flat.bb_max[i] - ro_np) * rcp
        tn = np.minimum(d0, d1).max()
        tf = np.maximum(d0, d1).min()
        return bool(tf > max(tn, 1e-3))

    def walk(i: int, depth: int) -> None:
        census["visited"] += 1
        prim = int(flat.prim[i])
        tag = f"leaf(prim {prim})" if prim >= 0 else "inner"
        indent = "  " * depth
        if not node_hit(i):
            census["miss"] += 1
            log(f"{indent}node {i} {tag}: Miss")
            return
        if prim < 0:
            log(f"{indent}node {i} {tag}: Hit")
            left = i + 1
            walk(left, depth + 1)
            walk(int(flat.escape[left]), depth + 1)
            return
        census["leaf_tests"] += 1
        cand = leaf_candidate(
            flat, scene, torch.full((1,), prim, dtype=torch.int64, device=dev),
            ro, rd, time, med_u, t_min=1e-3, features=features,
            offsets=offsets)
        t = float(cand[0])
        if t < MAX_T:
            census["leaf_hits"] += 1
            log(f"{indent}node {i} {tag}: Hit t={t:.6f}")
        else:
            log(f"{indent}node {i} {tag}: prim Miss")

    walk(0, 0)
    log(f"bvh visit census: visited={census['visited']}"
        f" aabb_miss={census['miss']} leaf_tests={census['leaf_tests']}"
        f" leaf_hits={census['leaf_hits']}")


def print_ray_trace(scene: Scene, camera: Camera, max_depth: int,
                    seed: int = 0, use_bvh: bool = False, log=print,
                    device="cuda") -> None:
    """Trace the camera's centre ray on ``device``, logging every bounce
    (``use_bvh``: the BVH descent first, :func:`print_bvh_ray_trace`)."""
    dev = torch.device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    if use_bvh:
        print_bvh_ray_trace(scene, camera, seed=seed, log=log, device=dev)
    f = SceneFeatures.from_scene(scene)
    key = threefry.PRNGKey(seed)
    ro, rd, time = _center_ray(camera, threefry.fold_in(key, 0), dev)
    soa = prep_tables(scene, f).soa
    planes = isect._planes

    log(f"center ray: origin={_np(ro)[0]} dir={_np(rd)[0]}")
    for depth in range(max_depth + 1):
        kb = threefry.fold_in(key, depth)
        med_u = (threefry.uniform(threefry.fold_in(kb, 0),
                                  (1, scene.media.count), dev)
                 if f.has_media else None)
        scat_u = threefry.uniform(threefry.fold_in(kb, 1), (1, 4), dev)

        candidates = {}
        with torch.no_grad():
            if f.has_spheres:
                candidates["sphere"] = isect.sphere_nearest(
                    scene.spheres, soa, ro, rd, time, f.has_motion)
            if f.has_rects:
                candidates["rect"] = isect.rect_hits(scene.rects, ro, rd)
            if f.has_boxes:
                candidates["box"] = box_nearest(scene.boxes, *planes(ro, rd))
            if f.has_media:
                candidates["media"] = media_nearest(
                    scene.media, *planes(ro, rd), med_u.T)
            rec = isect.intersect_scene(scene, ro, rd, time, med_u, soa, f)
            sc = bsdf.scatter(scene, rec, rd, scat_u, f)

        for kind, (t, i) in candidates.items():
            t, i = float(t[0]), int(i[0])
            status = f"Hit t={t:.6f} idx={i}" if t < MAX_T else "Miss"
            log(f"  depth {depth}: {kind:7s} {status}")

        if not bool(rec.hit[0]):
            log(f"  depth {depth}: escaped to sky")
            break
        log(f"  depth {depth}: HIT t={float(rec.t[0]):.6f}"
            f" p={_np(rec.point)[0]} n={_np(rec.normal)[0]}"
            f" mat={int(rec.mat_id[0])}"
            f" scatter={'yes' if bool(sc.ok[0]) else 'absorbed'}")
        if not bool(sc.ok[0]):
            break
        ro = rec.point
        rd = sc.direction
