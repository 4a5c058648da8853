"""Batched thin-lens camera (counterpart of ``pathtrace_tpu/camera.py``).

The same precomputed basis and film extent, evaluated in float32 in the
same operation order, so a camera built here equals the JAX one.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pathtrace_tpu_torch.ops import math as pmath


@dataclasses.dataclass
class Camera:
    origin: torch.Tensor             # [3]
    lower_left_corner: torch.Tensor  # [3]
    horizontal: torch.Tensor         # [3]
    vertical: torch.Tensor           # [3]
    u: torch.Tensor                  # [3]
    v: torch.Tensor                  # [3]
    w: torch.Tensor                  # [3]
    time0: torch.Tensor              # []
    time1: torch.Tensor              # []
    lens_radius: torch.Tensor        # []

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def make_camera(lookfrom, lookat, vup, vfov_degrees: float, aspect: float,
                aperture: float, focus_dist: float, time0: float = 0.0,
                time1: float = 0.0) -> Camera:
    """Build the precomputed camera basis on the CPU."""
    lookfrom, lookat, vup = _f32(lookfrom), _f32(lookat), _f32(vup)
    theta = vfov_degrees * math.pi / 180.0
    half_height = torch.tan(_f32(theta * 0.5))
    half_width = _f32(aspect) * half_height
    w = pmath.normalize(lookfrom - lookat)
    u = pmath.normalize(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    fd = _f32(focus_dist)
    return Camera(
        origin=lookfrom,
        lower_left_corner=(
            lookfrom - half_width * fd * u - half_height * fd * v - fd * w
        ),
        horizontal=2.0 * half_width * fd * u,
        vertical=2.0 * half_height * fd * v,
        u=u,
        v=v,
        w=w,
        time0=_f32(time0),
        time1=_f32(time1),
        lens_radius=_f32(aperture * 0.5),
    )


def get_rays(camera: Camera, s: torch.Tensor, t: torch.Tensor,
             uniforms: torch.Tensor):
    """Primary rays for film coordinates ``s, t`` in [0, 1) of any batch
    shape and ``[..., 3]`` uniforms (two for the aperture disk, one for
    shutter time). Returns (origin [..., 3], unit direction [..., 3],
    time [...])."""
    rd = camera.lens_radius * pmath.random_in_unit_disk(uniforms[..., 0],
                                                        uniforms[..., 1])
    offset = camera.u * rd[..., 0:1] + camera.v * rd[..., 1:2]
    time = camera.time0 + uniforms[..., 2] * (camera.time1 - camera.time0)
    origin = camera.origin + offset
    direction = pmath.normalize(
        camera.lower_left_corner
        + s[..., None] * camera.horizontal
        + t[..., None] * camera.vertical
        - camera.origin
        - offset
    )
    return origin, direction, time
