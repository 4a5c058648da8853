"""Progressive render loop, fast mode only (counterpart of
``pathtrace_tpu/render/progressive.py``).

Each frame renders ``params.samples`` spp through the fast path and blends
into the running average with ``mix_prev = n/(n+1)``. On CUDA each frame is
timed with CUDA events around its work; the ray count is read back once
per frame, after the frame's last kernel.
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
from pathtrace_tpu_torch.ops.fastpath import fastpath_supported, render_frame_fast
from pathtrace_tpu_torch.render.frame import accumulate


@dataclasses.dataclass
class ProgressiveResult:
    image: np.ndarray        # [H, W, 3] linear accumulated
    frames: int
    total_rays: int          # segments traced, all frames
    frame_ms: List[float]    # per frame: CUDA-event time (host clock on CPU)
    readbacks: List[int]     # per frame: alive-count readbacks (host syncs)
    timer: str               # "cuda-events" or "host-clock"


def render_progressive(scene: Scene, camera: Camera, params: Params,
                       max_frames: int, device, features: Optional[SceneFeatures] = None,
                       log: Callable[[str], None] = print) -> ProgressiveResult:
    """Render ``max_frames`` accumulated frames on ``device``."""
    device = torch.device(device)
    seed = params.resolve_seed()
    features = features or SceneFeatures.from_scene(scene)
    fastpath_supported(features)
    scene = scene.to(device)
    camera = camera.to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    on_cuda = device.type == "cuda"

    acc = None
    total_rays = 0
    frame_ms, readbacks = [], []
    for frame in range(max_frames):
        if on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        else:
            t0 = time.perf_counter()
        res = render_frame_fast(
            scene, camera, params.width, params.height, params.samples,
            params.max_depth, generator, seed * 1000003 + frame, features,
        )
        acc = res.image if acc is None else accumulate(acc, res.image, frame)
        if on_cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        rays = int(res.ray_count)
        total_rays += rays
        frame_ms.append(ms)
        readbacks.append(res.readbacks)
        log(f"frame {frame + 1}/{max_frames}: {ms:.2f} ms, {rays} rays, "
            f"{rays / 1e3 / max(ms, 1e-9):.2f} Mrays/s, "
            f"{res.readbacks} readbacks")
    image = (acc.cpu().numpy() if acc is not None else
             np.zeros((params.height, params.width, 3), np.float32))
    return ProgressiveResult(
        image=image, frames=max_frames, total_rays=total_rays,
        frame_ms=frame_ms, readbacks=readbacks,
        timer="cuda-events" if on_cuda else "host-clock",
    )
