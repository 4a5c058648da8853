"""First-hit AOVs (arbitrary output variables): normals, albedo, depth
(counterpart of ``pathtrace_tpu/render/aov.py``).

One primary-ray intersection pass per pixel gives the geometry buffers
that denoisers and compositing expect, and that
:mod:`~pathtrace_tpu_torch.render.denoise` takes as its edge guides. The
record is the general integrator's
(:func:`~pathtrace_tpu_torch.ops.intersect.intersect_scene`: K1, or K3 in
a scene with moving spheres, on world-space spheres; the plain sweeps of
the other kinds), so on the card the pass launches the closest-hit
kernel once and no bounce loop.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops import intersect as isect
from pathtrace_tpu_torch.ops.texture import texture_value
from pathtrace_tpu_torch.render import film
from pathtrace_tpu_torch.render.frame import generate_primary_rays
from pathtrace_tpu_torch.render.integrator import prep_tables, sky_color
from pathtrace_tpu_torch.utils import threefry


def render_aovs(scene: Scene, camera, width: int, height: int,
                key: torch.Tensor, features: Optional[SceneFeatures] = None,
                samples: int = 1) -> Dict[str, torch.Tensor]:
    """First-hit AOVs averaged over ``samples`` jittered primaries, on the
    scene's device. ``key`` (a Threefry key): ``kray, kmed = split(key)``,
    the primary rays from ``kray``
    (:func:`~pathtrace_tpu_torch.render.frame.generate_primary_rays`) and
    the media's [R, n_media] free-flight uniforms from ``kmed``, as the
    reference draws them.

    Returns a dict of [H, W, ...] tensors:
      * ``normal``: the record's normal, zero where nothing is hit;
      * ``albedo``: the winner's texture colour (a light's emission, a
        medium's phase albedo), the sky colour where nothing is hit;
      * ``depth``: the hit distance t (0 where nothing is hit);
      * ``hit``: the hit coverage in [0, 1].
    """
    f = features or SceneFeatures.from_scene(scene)
    dev = scene.sky.device
    kray, kmed = threefry.split(key)
    ro, rd, time = generate_primary_rays(camera, width, height, samples,
                                         kray, device=dev)
    R = height * width * samples
    ro, rd, time = ro.reshape(R, 3), rd.reshape(R, 3), time.reshape(R)
    med_u = (threefry.uniform(kmed, (R, scene.media.count), dev)
             if f.has_media else None)
    tables = prep_tables(scene, f)
    with torch.no_grad():
        rec = isect.intersect_scene(scene, ro, rd, time, med_u, tables.soa,
                                    f, box_media=tables.box_media)
        tex_id = scene.materials.tex_id[rec.mat_id]
        hit3 = rec.hit[..., None]
        safe_p = torch.where(hit3, rec.point, torch.zeros_like(rec.point))
        albedo = texture_value(scene, tex_id, rec.u, rec.v, safe_p, f)
        albedo = torch.where(hit3, albedo, sky_color(scene, rd))
        normal = torch.where(hit3, rec.normal, torch.zeros_like(rec.normal))
        depth = torch.where(rec.hit, rec.t, torch.zeros_like(rec.t))

    def avg(x):
        return x.reshape((height, width, samples) + x.shape[1:]).mean(dim=2)

    return {"normal": avg(normal), "albedo": avg(albedo), "depth": avg(depth),
            "hit": avg(rec.hit.to(ro.dtype))}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_aov_pngs(aovs: Dict[str, torch.Tensor], out_prefix: str) -> None:
    """Write the AOVs as ``<out_prefix>.normal.png``, ``.albedo.png`` and
    ``.depth.png`` (normals mapped to [0, 1], depth over its maximum)."""
    normal = (_np(aovs["normal"]) * 0.5 + 0.5).clip(0.0, 1.0)
    film.save_frame_png(f"{out_prefix}.normal.png", normal ** 2.2)  # undo sRGB
    film.save_frame_png(f"{out_prefix}.albedo.png", _np(aovs["albedo"]))
    d = _np(aovs["depth"])
    dmax = d.max() or 1.0
    dn = (d / dmax)[..., None].repeat(3, axis=-1)
    film.save_frame_png(f"{out_prefix}.depth.png", dn ** 2.2)
