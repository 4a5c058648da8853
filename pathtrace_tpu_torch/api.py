"""One-call library API (counterpart of ``pathtrace_tpu/api.py``).

The CLI (``python -m pathtrace_tpu_torch``) is the reference-parity
surface; this module is the Python one: build or pick a scene, call
:func:`render`, get a numpy image back. The drivers' choices (the path,
the BVH, progressive accumulation, checkpoints) take the keywords the CLI
exposes.

    import pathtrace_tpu_torch as pt

    img = pt.render_image(preset="small", width=320, height=180, samples=16)

    b = pt.SceneBuilder()
    b.sphere((0, 0, -1), 0.5, b.lambertian_color((0.4, 0.8, 0.4)))
    cam = pt.make_camera((0, 1, 3), (0, 0, -1), (0, 1, 0), 60.0, 16 / 9,
                         aperture=0.0, focus_dist=3.0)
    img = pt.render_image(scene=b.finish(), camera=cam, width=640, height=360)

(``render_image`` is this module's :func:`render`; the package exports it
under the longer name because the ``render/`` subpackage owns
``pt.render``.) It renders on ``device``, the card by default.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import Params
from pathtrace_tpu_torch.models import presets as _presets
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures


def render(preset: Optional[str] = None, scene: Optional[Scene] = None,
           camera: Optional[Camera] = None, width: int = 1280,
           height: int = 720, samples: int = 4, max_depth: int = 10,
           frames: int = 1, seed: int = 0, mode: str = "auto",
           use_bvh: bool = False, group: Optional[int] = None,
           compaction: bool = True, stratify: bool = False,
           nee: bool = False, rr_start: int = 0, denoise: bool = False,
           out: Optional[str] = None, device="cuda",
           **progressive_kwargs) -> np.ndarray:
    """Render ``frames`` progressive frames on ``device`` and return the
    [H, W, 3] linear image (float32). Pass EITHER ``preset`` (a name of
    :func:`preset_names`) OR ``scene`` and ``camera`` from
    :class:`~pathtrace_tpu_torch.models.build.SceneBuilder` and
    :func:`~pathtrace_tpu_torch.camera.make_camera`. ``denoise``: the
    à-trous filter guided by 2-sample AOVs keyed ``PRNGKey(seed)``, as
    the CLI's ``--denoise``. ``out`` also writes the image (a ``.png`` in
    sRGB, a ``.npy`` as is). Other keywords go to
    :func:`~pathtrace_tpu_torch.render.progressive.render_progressive`
    (``checkpoint_path``, ``on_frame``, ``preview``, ...). The image is
    the CLI's for the same flags, bit for bit."""
    from pathtrace_tpu_torch.render.progressive import (
        render_progressive,
        save_image,
    )

    if (preset is None) == (scene is None):
        raise ValueError("pass exactly one of preset= or scene=")
    if preset is not None:
        # unknown names raise ValueError
        scene, camera = _presets.from_name(preset, aspect=width / height,
                                           seed=seed)
    elif camera is None:
        raise ValueError("a custom scene= needs a camera= as well")

    params = Params(width=width, height=height, samples=samples,
                    max_depth=max_depth, seed=seed, use_bvh=use_bvh)
    features = SceneFeatures.from_scene(scene)
    result = render_progressive(
        scene, camera, params, max_frames=frames, device=device,
        features=features, mode=mode, group=group, compaction=compaction,
        stratify=stratify, nee=nee, rr_start=rr_start,
        log=lambda _s: None, **progressive_kwargs)
    image = result.image
    if denoise:
        image = denoise_image(scene, camera, params, features, image, device)
    if out is not None:
        save_image(out, image)
    return image


def denoise_image(scene: Scene, camera: Camera, params: Params,
                  features: SceneFeatures, image: np.ndarray,
                  device) -> np.ndarray:
    """The à-trous filter of ``image`` guided by the first-hit AOVs of 2
    samples a pixel, keyed ``PRNGKey(params.resolve_seed())`` (the
    reference's ``--denoise``), on ``device``."""
    import torch

    from pathtrace_tpu_torch.render.aov import render_aovs
    from pathtrace_tpu_torch.render.denoise import atrous_denoise
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    dev = torch.device(device)
    aovs = render_aovs(scene.to(dev), camera.to(dev), params.width,
                       params.height, PRNGKey(params.resolve_seed()),
                       features=features, samples=2)
    out = atrous_denoise(torch.from_numpy(np.asarray(image)).to(dev),
                         aovs["normal"], aovs["albedo"], aovs["depth"])
    return out.cpu().numpy()


def preset_names() -> list:
    """Names accepted by ``render(preset=...)``."""
    return list(_presets.names())
