"""Progressive render loop (counterpart of
``pathtrace_tpu/render/progressive.py``), routed as the reference routes
it.

Each frame renders ``params.samples`` spp and blends into the running
average with ``mix_prev = n/(n+1)``. Frame ``n`` draws from
``fold_in(PRNGKey(seed), n)``. ``mode`` picks the path:

* ``"auto"``: the fast path (:func:`~pathtrace_tpu_torch.ops.fastpath.render_frame_fast`,
  bounce seed ``seed * 1000003 + n``, as the reference's fast mode) when
  it takes the scene, else the general integrator
  (:func:`~pathtrace_tpu_torch.render.frame.render_frame`): more than 128
  rects, instanced spheres or rects, checkers with non-constant
  children (the reference's own fallbacks), an image texture in a scene
  with boxes or media, or NEE lights whose texture is not a constant;
* ``"fast"`` and ``"general"`` force their path (``"fast"`` raises for a
  scene it cannot take);
* ``"compacted"`` and ``"sharded"`` are not ported yet and raise.

So a frame's image is the reference's up to the closest hit's rounding.
On CUDA each frame is timed with CUDA events around its work; the ray
count is read back once per frame, after the frame's last kernel.
``nee`` builds the scene's light table once and renders with next-event
estimation; a scene without lights renders with the plain estimator, as
the reference's does. A checkpoint resumes and saves the accumulation as
the reference's loop does (``progressive.py:247-252, 307-320``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import Params
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops.fastpath import (
    fastpath_refusal,
    fastpath_supported,
    render_frame_fast,
)
from pathtrace_tpu_torch.ops.lights import build_light_table
from pathtrace_tpu_torch.render import film, integrator
from pathtrace_tpu_torch.render.frame import accumulate, render_frame
from pathtrace_tpu_torch.utils import checkpoint as ckpt
from pathtrace_tpu_torch.utils import threefry

MODES = ("auto", "fast", "general", "compacted", "sharded")


@dataclasses.dataclass
class ProgressiveResult:
    image: np.ndarray        # [H, W, 3] linear accumulated
    frames: int
    total_rays: int          # segments traced, all frames
    frame_ms: List[float]    # per frame: CUDA-event time (host clock on CPU)
    readbacks: List[int]     # per frame: alive-count readbacks (host syncs)
    timer: str               # "cuda-events" or "host-clock"
    path: str = ""           # the path that ran: "fast" or "general"


def route(scene: Scene, features: SceneFeatures, mode: str = "auto",
          nee_lights=None) -> str:
    """The path ``mode`` takes for ``scene``: "fast" or "general". Raises
    ``ValueError`` for a mode that is not ported yet or unknown, and for
    ``"fast"`` on a scene the fast path cannot take."""
    if mode in ("compacted", "sharded"):
        raise ValueError(f"--mode {mode}: not ported yet")
    if mode not in MODES:
        raise ValueError(f"unknown mode '{mode}' (one of {', '.join(MODES)})")
    if mode == "general":
        return "general"
    if mode == "fast":
        fastpath_supported(features, scene)
        return "fast"
    refused = fastpath_refusal(features, scene)
    if refused is None and nee_lights is not None and nee_lights.color is None:
        refused = "NEE lights whose texture is not a constant"
    return "general" if refused is not None else "fast"


def save_image(path: str, image) -> None:
    """Write ``image`` [H, W, 3] linear to ``path``: a ``.npy`` as is, any
    other name as an sRGB PNG (flipped like the reference's)."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    if path.endswith(".npy"):
        np.save(path, image)
    else:
        film.save_frame_png(path, image)


def render_progressive(scene: Scene, camera: Camera, params: Params,
                       max_frames: int, device, features: Optional[SceneFeatures] = None,
                       log: Callable[[str], None] = print, nee: bool = False,
                       rr_start: int = 0, stratify: bool = False,
                       mode: str = "auto",
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 50,
                       snapshot_path: Optional[str] = None,
                       snapshot_every: int = 0) -> ProgressiveResult:
    """Render ``max_frames`` accumulated frames on ``device`` by the path
    ``mode`` routes to (:func:`route`); ``nee``: next-event estimation;
    ``rr_start`` > 0: Russian roulette from that depth; ``stratify``:
    Latin-hypercube samples in each pixel.

    ``checkpoint_path``: resume from it when it holds this seed's render
    at this film size (frames ``n..n + max_frames - 1`` follow its ``n``
    frames), save to it every ``checkpoint_every`` frames and at the end
    (:mod:`~pathtrace_tpu_torch.utils.checkpoint`), as the reference's
    loop does, so ``-F 2`` twice equals ``-F 4`` bit for bit.
    ``snapshot_path``: write the accumulated image there every
    ``snapshot_every`` frames (:func:`save_image`)."""
    device = torch.device(device)
    seed = params.resolve_seed()
    features = features or SceneFeatures.from_scene(scene)
    nee_lights = build_light_table(scene) if nee else None
    path = route(scene, features, mode, nee_lights)
    scene = scene.to(device)
    camera = camera.to(device)
    base_key = threefry.PRNGKey(seed)
    on_cuda = device.type == "cuda"

    acc = None
    start_frame = 0
    resumed = ckpt.try_load(checkpoint_path)
    if resumed is not None:
        acc_np, saved_frame, saved_seed = resumed
        if (saved_seed == seed
                and acc_np.shape == (params.height, params.width, 3)):
            acc = torch.from_numpy(acc_np).to(device)
            start_frame = saved_frame
            log(f"resumed from {checkpoint_path} at frame {start_frame}")
    total_rays = 0
    frame_ms, readbacks = [], []
    for frame in range(start_frame, start_frame + max_frames):
        if on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        else:
            t0 = time.perf_counter()
        key = threefry.fold_in(base_key, frame)
        if path == "fast":
            res = render_frame_fast(
                scene, camera, params.width, params.height, params.samples,
                params.max_depth, key, seed * 1000003 + frame, features,
                nee_lights=nee_lights, rr_start=rr_start, stratify=stratify,
            )
            image, count, n_read = res.image, res.ray_count, res.readbacks
        else:
            before = integrator.READBACKS
            image, count = render_frame(
                scene, camera, params.width, params.height, params.samples,
                params.max_depth, key, features=features, stratify=stratify,
                nee_lights=nee_lights, rr_start=rr_start,
            )
            n_read = integrator.READBACKS - before
        acc = image if acc is None else accumulate(acc, image, frame)
        if on_cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        rays = int(count)
        total_rays += rays
        frame_ms.append(ms)
        readbacks.append(n_read)
        log(f"frame {frame + 1}/{start_frame + max_frames}: {ms:.2f} ms, "
            f"{rays} rays, {rays / 1e3 / max(ms, 1e-9):.2f} Mrays/s, "
            f"{n_read} readbacks ({path} path)")
        done = frame + 1
        if checkpoint_path and done % checkpoint_every == 0:
            ckpt.save(checkpoint_path, acc, done, seed)
        if snapshot_path and snapshot_every and done % snapshot_every == 0:
            save_image(snapshot_path, acc)
    image = (acc.cpu().numpy() if acc is not None else
             np.zeros((params.height, params.width, 3), np.float32))
    if checkpoint_path:
        ckpt.save(checkpoint_path, image, start_frame + max_frames, seed)
    return ProgressiveResult(
        image=image, frames=max_frames, total_rays=total_rays,
        frame_ms=frame_ms, readbacks=readbacks,
        timer="cuda-events" if on_cuda else "host-clock", path=path,
    )
