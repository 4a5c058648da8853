"""Adaptive sampling: variance-guided per-pixel sample allocation
(counterpart of ``pathtrace_tpu/render/adaptive.py``).

After a uniform warmup, each round re-renders only the pixels of highest
variance (a fraction ``frac`` of them), so samples gather where the
estimator is noisy (light edges, penumbrae, glass). A round's wavefront
is a gather of pixel ids: ``K`` pixels times ``S`` samples, the same
size every round whichever pixels are chosen. Between rounds the host
reads the [H*W] variance metric back once and picks the pixels with
``np.argpartition``, as the reference does. Accumulation is per pixel
(sum, sum of squares, count), so each pixel's estimate stays its plain
sample mean: the allocation uses only earlier rounds' samples, which
keeps every pixel's mean unbiased.

Keys are the reference's: round ``rnd`` draws from ``fold_in(PRNGKey(seed),
rnd)``; its ``split`` gives the [K, S, 2] pixel jitter and the [K, S, 3]
lens/time uniforms (the general route splits in three, the third key
keying the bounces); the fast route's bounce seed is ``seed * 1000003 +
rnd + 17``. So the port's rounds draw what the reference's draw, and its
images equal them up to the closest hit's rounding.

Routes: ``mode="auto"`` traces each round on the fast path
(:func:`~pathtrace_tpu_torch.ops.fastpath.trace_fast`: K1/K3/K4/K5 and K2
on the gathered pixel wavefront, or its non-fused bounce for an image
texture in a scene with boxes or media, the ladder from 4096 lanes)
where the fast path takes the scene, as the reference's does, else on the
general integrator (``"general"`` forces it).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera, get_rays
from pathtrace_tpu_torch.config import Params
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops.fastpath import fastpath_refusal, trace_fast
from pathtrace_tpu_torch.render import integrator
from pathtrace_tpu_torch.utils import threefry


def _pixel_film(ids: torch.Tensor, width: int, height: int, samples: int,
                kj: torch.Tensor, kc: torch.Tensor, camera: Camera):
    """Primary rays [K * S] of the pixels ``ids`` [K]: film coordinates
    ``(x + U) / W`` and ``(y + U) / H`` from the [K, S, 2] jitter of
    ``kj``, the lens/time uniforms [K, S, 3] from ``kc``."""
    dev = ids.device
    K = ids.shape[0]
    px = (ids % width).to(torch.float32)
    py = torch.div(ids, width, rounding_mode="floor").to(torch.float32)
    jit_u = threefry.uniform(kj, (K, samples, 2), dev)
    cam_u = threefry.uniform(kc, (K, samples, 3), dev)
    s = (px[:, None] + jit_u[..., 0]) / width
    t = (py[:, None] + jit_u[..., 1]) / height
    ro, rd, tm = get_rays(camera, s, t, cam_u)
    R = K * samples
    return ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R)


def _gen_pixel_rays(camera: Camera, ids: torch.Tensor, width: int,
                    height: int, samples: int, key: torch.Tensor):
    """Primary rays for the K chosen pixels ``ids``: ``kj, kc =
    split(key)`` (the fast route's front half)."""
    kj, kc = threefry.split(key)
    return _pixel_film(ids, width, height, samples, kj, kc, camera)


def _pixel_sums(rad: torch.Tensor, K: int, samples: int):
    rad = rad.reshape(K, samples, 3)
    return rad.sum(dim=1), (rad * rad).sum(dim=1)


def _render_pixels(scene: Scene, camera: Camera, ids: torch.Tensor,
                   width: int, height: int, samples: int, max_depth: int,
                   key: torch.Tensor, features: SceneFeatures,
                   nee_lights=None):
    """``samples`` fresh paths for each of the K pixels ``ids`` through the
    general integrator: ``kj, kc, kt = split(key, 3)``, the bounces keyed
    by ``kt``. Returns (sum [K, 3], sum of squares [K, 3], rays [])."""
    kj, kc, kt = threefry.split(key, 3)
    ro, rd, tm = _pixel_film(ids, width, height, samples, kj, kc, camera)
    rad, rays = integrator.trace(scene, ro, rd, tm, kt, max_depth,
                                 features=features, nee_lights=nee_lights)
    s1, s2 = _pixel_sums(rad, ids.shape[0], samples)
    return s1, s2, rays


def _render_pixels_fast(scene: Scene, camera: Camera, ids: torch.Tensor,
                        width: int, height: int, samples: int,
                        max_depth: int, key: torch.Tensor, seed: int,
                        features: SceneFeatures, nee_lights=None):
    """Fast-path twin of :func:`_render_pixels`: the gathered pixel
    wavefront through :func:`~pathtrace_tpu_torch.ops.fastpath.trace_fast`
    (``min_size`` 4096, as the reference's), bounces keyed by ``seed``."""
    ro, rd, tm = _gen_pixel_rays(camera, ids, width, height, samples, key)
    res = trace_fast(scene, ro, rd, tm, seed, max_depth, features,
                     nee_lights=nee_lights, min_size=1 << 12)
    s1, s2 = _pixel_sums(res.radiance, ids.shape[0], samples)
    return s1, s2, res.ray_count


def _metric(ssum: torch.Tensor, ssq: torch.Tensor,
            cnt: torch.Tensor) -> torch.Tensor:
    """Variance of each pixel's mean, summed over the channels."""
    mean = ssum / cnt[:, None]
    var = torch.clamp(ssq / cnt[:, None] - mean * mean, min=0.0)
    return (var[:, 0] + var[:, 1] + var[:, 2]) / cnt


def render_adaptive(scene: Scene, camera: Camera, params: Params,
                    budget_spp: int, device="cuda",
                    features: Optional[SceneFeatures] = None,
                    warmup_frames: int = 2, frac: float = 0.25,
                    nee_lights=None, mode: str = "auto",
                    log: Callable[[str], None] = print,
                    timings: Optional[Dict[str, float]] = None,
                    ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Render with a total budget of ``budget_spp * W * H`` paths on
    ``device``: a warmup of ``max(warmup_frames, 2)`` uniform rounds of
    ``params.samples`` spp, then rounds over the ``frac`` of the pixels
    whose mean has the largest variance while the budget lasts.

    Returns (image [H, W, 3], total rays, spp map [H, W]), numpy.
    ``timings`` (a dict): filled with the wall seconds of the warmup, the
    refinement rounds' device work, the metric readbacks and the host's
    ``argpartition``, and the round count.

    The order of a round's pixel ids matters, not only their set: id
    ``j`` of a round takes the round's draws ``j``. So a metric that
    differs from the reference's in a last bit can reorder two ids of
    nearly equal variance and hand them each other's samples, and the
    renders part from there (statistically the same)."""
    dev = torch.device(device)
    f = features or SceneFeatures.from_scene(scene)
    use_fast = mode != "general" and fastpath_refusal(f, scene) is None
    W, H, S = params.width, params.height, params.samples
    n_pix = W * H
    scene = scene.to(dev)
    camera = camera.to(dev)
    on_cuda = dev.type == "cuda"

    seed = params.resolve_seed()
    base_key = threefry.PRNGKey(seed)
    all_ids = torch.arange(n_pix, dtype=torch.int64, device=dev)
    ssum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    ssq = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    rays_dev = torch.zeros((), dtype=torch.int64, device=dev)
    spent = 0          # samples drawn so far
    budget = budget_spp * n_pix
    rnd = 0
    t = {"warmup_s": 0.0, "rounds_s": 0.0, "readback_s": 0.0,
         "argpartition_s": 0.0}

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def render_round(ids, key, rnd):
        if use_fast:
            return _render_pixels_fast(
                scene, camera, ids, W, H, S, params.max_depth, key,
                seed * 1000003 + rnd + 17, f, nee_lights)
        return _render_pixels(scene, camera, ids, W, H, S, params.max_depth,
                              key, f, nee_lights)

    # uniform warmup: the variance estimate needs >= 2 samples everywhere
    t0 = time.perf_counter()
    for _ in range(max(warmup_frames, 2)):
        key = threefry.fold_in(base_key, rnd)
        s1, s2, rays = render_round(all_ids, key, rnd)
        ssum, ssq = ssum + s1, ssq + s2
        cnt = cnt + S
        rays_dev = rays_dev + rays
        spent += S * n_pix
        rnd += 1
    sync()
    t["warmup_s"] = time.perf_counter() - t0

    K = max(int(n_pix * frac), 1)
    while spent + K * S <= budget:
        t0 = time.perf_counter()
        metric = _metric(ssum, ssq, cnt).cpu().numpy()   # the one readback
        t1 = time.perf_counter()
        ids_np = np.argpartition(metric, n_pix - K)[-K:]
        t2 = time.perf_counter()
        ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
        key = threefry.fold_in(base_key, rnd)
        s1, s2, rays = render_round(ids, key, rnd)
        # the ids are unique, so each pixel gains one round's sums
        ssum = ssum.index_add(0, ids, s1)
        ssq = ssq.index_add(0, ids, s2)
        cnt = cnt.index_add(0, ids, torch.full((K,), float(S),
                                               dtype=torch.float32,
                                               device=dev))
        rays_dev = rays_dev + rays
        spent += K * S
        rnd += 1
        sync()  # the next metric readback waits for the round anyway
        t["readback_s"] += t1 - t0
        t["argpartition_s"] += t2 - t1
        t["rounds_s"] += time.perf_counter() - t2

    img = (ssum / cnt[:, None]).reshape(H, W, 3).cpu().numpy()
    spp_map = cnt.reshape(H, W).cpu().numpy()
    total_rays = int(rays_dev)
    t["rounds"] = rnd
    if timings is not None:
        timings.update(t)
    log(f"adaptive: {rnd} rounds, spp min/mean/max "
        f"{spp_map.min():.0f}/{spp_map.mean():.1f}/{spp_map.max():.0f}")
    return img, total_rays, spp_map
