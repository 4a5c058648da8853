"""Math primitives on batched ``[..., 3]`` tensors (counterpart of
``pathtrace_tpu/ops/math.py``): closed-form sampling transforms, no
rejection loops, every function differentiable under autograd."""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Batched 3-vector dot product along the last axis, summed x, y, z
    in that order."""
    p = a * b
    out = (p[..., 0] + p[..., 1]) + p[..., 2]
    return out[..., None] if keepdims else out


def normalize(v: torch.Tensor, eps: float = 1e-38) -> torch.Tensor:
    """Normalize along the last axis (guarded against zero vectors)."""
    n2 = (v * v).sum(dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps))


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection ``v - 2 (v.n) n``."""
    return v - 2.0 * dot(v, n) * n


def refract(v: torch.Tensor, n: torch.Tensor, ni_over_nt):
    """Snell refraction: ``(refracted, ok)``, ``ok`` False under total
    internal reflection (``refracted`` is then finite but meaningless).
    The square root's argument is replaced by 1 where it is not positive,
    so reverse mode stays finite on those lanes."""
    ni_over_nt = torch.as_tensor(ni_over_nt, dtype=v.dtype, device=v.device)
    if ni_over_nt.dim() < v.dim():
        ni_over_nt = ni_over_nt[..., None]
    dt = dot(v, n)
    disc = 1.0 - (ni_over_nt * ni_over_nt) * (1.0 - dt * dt)
    ok = (disc > 0.0)[..., 0]
    safe = torch.where(disc > 0.0, disc, 1.0)
    refr = ni_over_nt * (v - n * dt) - n * torch.sqrt(safe)
    return refr, ok


def schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's Fresnel approximation."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def random_unit_vector(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction from two uniforms: z = 2 u1 - 1, azimuth
    2 pi u2. Returns ``u1.shape + (3,)``."""
    z = u1 * 2.0 - 1.0
    a = u2 * TWO_PI
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(a), r * torch.sin(a), z], dim=-1)


def random_in_unit_sphere(u1: torch.Tensor, u2: torch.Tensor,
                          u3: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball: a uniform direction scaled by the
    cube root of a uniform."""
    return random_unit_vector(u1, u2) * torch.pow(u3, 1.0 / 3.0)[..., None]


def random_in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk (z = 0) from two uniforms: radius
    sqrt(U), uniform angle. Returns ``u1.shape + (3,)``."""
    r = torch.sqrt(u1)
    a = u2 * TWO_PI
    return torch.stack([r * torch.cos(a), r * torch.sin(a),
                        torch.zeros_like(r)], dim=-1)
