"""Primary rays and progressive accumulation (counterpart of
``pathtrace_tpu/render/frame.py``).

The JAX package draws the in-pixel jitter and lens/time uniforms from
``jax.random``; here they come from an explicit ``torch.Generator`` on the
render device. The two streams differ, so tests feed both packages the
same numpy-made uniforms through :func:`~pathtrace_tpu_torch.camera.get_rays`.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.camera import Camera, get_rays


def pixel_jitter(height: int, width: int, samples: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Uniform iid in-pixel offsets [H, W, S, 2] in [0, 1)."""
    return torch.rand((height, width, samples, 2), generator=generator,
                      device=generator.device)


def generate_primary_rays(camera: Camera, width: int, height: int,
                          samples: int, generator: torch.Generator):
    """Jittered primary rays for the full frame, on ``generator.device``:
    ``u = (x + U) / W, v = (y + U) / H``, row y = 0 at the bottom of the
    image. Returns ro, rd [H, W, S, 3] and time [H, W, S]."""
    dev = generator.device
    jitter = pixel_jitter(height, width, samples, generator)
    cam_u = torch.rand((height, width, samples, 3), generator=generator,
                       device=dev)
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


def render_frame_diff(scene, camera: Camera, width: int, height: int,
                      samples: int, max_depth: int,
                      generator, seed: int, features, rays=None):
    """Differentiable whole-frame render: primary rays, then
    :func:`~pathtrace_tpu_torch.ops.fastpath.trace_fast_diff`, then the
    per-pixel sample mean. The one-device case of the reference's
    ``render_frame_sharded(..., differentiable=True, mode="fast")``
    (``parallel/mesh.py:148-228``); one device needs no padding lanes.
    ``generator`` draws the primary-ray jitter, unless ``rays`` (ro, rd
    [H*W*S, 3], time [H*W*S], in [H, W, S] order) gives the rays; ``seed``
    keys the bounce RNG. Returns (image [H, W, 3], segments [] int64 on
    the device)."""
    from pathtrace_tpu_torch.ops.fastpath import trace_fast_diff

    R = height * width * samples
    if rays is None:
        ro, rd, t = generate_primary_rays(camera, width, height, samples,
                                          generator)
        rays = (ro.reshape(R, 3), rd.reshape(R, 3), t.reshape(R))
    radiance, segs = trace_fast_diff(scene, *rays, seed, max_depth, features)
    return radiance.reshape(height, width, samples, 3).mean(dim=2), segs
