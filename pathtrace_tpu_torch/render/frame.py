"""Primary rays, whole-frame renders and progressive accumulation
(counterpart of ``pathtrace_tpu/render/frame.py``).

The in-pixel jitter and the lens/time uniforms come from the Threefry
twin of ``jax.random`` (:mod:`pathtrace_tpu_torch.utils.threefry`): the
same key gives the reference's uniforms bit for bit, drawn on the render
device (the kernel of ``csrc/threefry.cu`` on a CUDA device).
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.camera import Camera, get_rays
from pathtrace_tpu_torch.utils import threefry


def pixel_jitter(key: torch.Tensor, height: int, width: int, samples: int,
                 stratify: bool, device="cpu") -> torch.Tensor:
    """In-pixel sample offsets [H, W, S, 2] in [0, 1) on ``device``.

    Uniform iid by default; with ``stratify`` each pixel's S samples are
    Latin-hypercube placed: one per 1/S stratum on each axis, the two axes
    permuted independently by a stable argsort of iid uniforms (as
    ``jnp.argsort`` sorts), keyed by ``split(fold_in(key, 1))``."""
    jitter = threefry.uniform(key, (height, width, samples, 2), device)
    if not stratify or samples <= 1:
        return jitter
    ka, kb = threefry.split(threefry.fold_in(key, 1))
    px, py = (torch.argsort(threefry.uniform(k, (height, width, samples),
                                             device), dim=-1,
                            stable=True).to(torch.float32)
              for k in (ka, kb))
    return torch.stack([(px + jitter[..., 0]) / samples,
                        (py + jitter[..., 1]) / samples], dim=-1)


def generate_primary_rays(camera: Camera, width: int, height: int,
                          samples: int, key: torch.Tensor,
                          stratify: bool = False, device=None):
    """Jittered primary rays for the full frame: ``u = (x + U) / W,
    v = (y + U) / H``, row y = 0 at the bottom of the image, the jitter
    from ``split(key)[0]`` and the lens/time uniforms from
    ``split(key)[1]``, as the reference draws them. Drawn and traced on
    ``device`` (default: the camera's). Returns ro, rd [H, W, S, 3] and
    time [H, W, S]."""
    dev = torch.device(device) if device is not None else camera.origin.device
    kj, kc = threefry.split(key)
    jitter = pixel_jitter(kj, height, width, samples, stratify, dev)
    cam_u = threefry.uniform(kc, (height, width, samples, 3), dev)
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None, None]
    s = (x + jitter[..., 0]) / width
    t = (y + jitter[..., 1]) / height
    return get_rays(camera.to(dev), s, t, cam_u)


def accumulate(acc_image: torch.Tensor, new_image: torch.Tensor,
               frame_num: int) -> torch.Tensor:
    """Progressive blend ``acc * n/(n+1) + new * (1 - n/(n+1))``."""
    n = torch.tensor(float(frame_num), dtype=new_image.dtype)
    mix_prev = n / (n + 1.0)
    return acc_image * mix_prev.item() + new_image * (1.0 - mix_prev).item()


def render_frame(scene, camera: Camera, width: int, height: int,
                 samples: int, max_depth: int, key: torch.Tensor,
                 differentiable: bool = False, features=None,
                 ray_chunk: int = 0, stratify: bool = False,
                 nee_lights=None, rr_start: int = 0, intersect_fn=None):
    """One frame through the general integrator: (image [H, W, 3] linear
    RGB, ray_count [] int64), on the scene's device.

    ``kray, ktrace = split(key)``: the primary rays from ``kray``, the
    bounces keyed by ``ktrace``, as the reference keys them.
    ``differentiable`` takes :func:`~pathtrace_tpu_torch.render.integrator.trace_diff`
    (under autograd, to the scene's and the camera's leaves), else the
    early-exit :func:`~pathtrace_tpu_torch.render.integrator.trace`.
    ``ray_chunk`` > 0 traces the wavefront in chunks of that many rays,
    chunk ``c`` keyed ``fold_in(ktrace, c)``; the last chunk is padded
    with lanes born dead (a NaN time), or, when differentiable, with
    copies of ray 0 (its image pixels are cut off). The image is each
    pixel's sample mean (a mesh's frame, each shard keyed as the
    reference's: :func:`~pathtrace_tpu_torch.parallel.mesh.render_frame_sharded`).
    ``intersect_fn`` (``-B``: ``models.bvh.make_bvh_intersect_fn``)
    replaces the per-kind sweep as every bounce's closest hit."""
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.render import integrator

    features = features or SceneFeatures.from_scene(scene)
    kray, ktrace = threefry.split(key)
    dev = scene.sky.device
    ro, rd, time = generate_primary_rays(camera, width, height, samples,
                                         kray, stratify=stratify, device=dev)
    R = height * width * samples
    ro, rd, time = ro.reshape(R, 3), rd.reshape(R, 3), time.reshape(R)
    trace_fn = integrator.trace_diff if differentiable else integrator.trace
    tables = integrator.prep_tables(scene, features, nee_lights)
    kw = dict(features=features, nee_lights=nee_lights, rr_start=rr_start,
              tables=tables, intersect_fn=intersect_fn)
    if ray_chunk and ray_chunk < R:
        n_chunks = -(-R // ray_chunk)
        pad = n_chunks * ray_chunk - R
        if pad:
            pad_time = (time[:1].expand(pad) if differentiable
                        else torch.full((pad,), float("nan"),
                                        dtype=time.dtype, device=dev))
            ro = torch.cat([ro, ro[:1].expand(pad, 3)])
            rd = torch.cat([rd, rd[:1].expand(pad, 3)])
            time = torch.cat([time, pad_time])
        parts, count = [], torch.zeros((), dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            sl = slice(c * ray_chunk, (c + 1) * ray_chunk)
            rad_c, cnt_c = trace_fn(scene, ro[sl], rd[sl], time[sl],
                                    threefry.fold_in(ktrace, c), max_depth,
                                    **kw)
            parts.append(rad_c)
            count = count + cnt_c
        radiance = torch.cat(parts)[:R]
    else:
        radiance, count = trace_fn(scene, ro, rd, time, ktrace, max_depth,
                                   **kw)
    img = radiance.reshape(height, width, samples, 3).mean(dim=2)
    return img, count
