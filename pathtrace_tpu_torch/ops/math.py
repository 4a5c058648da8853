"""Math primitives on batched ``[..., 3]`` tensors (counterpart of
``pathtrace_tpu/ops/math.py``; only what the slice needs)."""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def normalize(v: torch.Tensor, eps: float = 1e-38) -> torch.Tensor:
    """Normalize along the last axis (guarded against zero vectors)."""
    n2 = (v * v).sum(dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps))


def random_in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk (z = 0) from two uniforms: radius
    sqrt(U), uniform angle. Returns ``u1.shape + (3,)``."""
    r = torch.sqrt(u1)
    a = u2 * TWO_PI
    return torch.stack([r * torch.cos(a), r * torch.sin(a),
                        torch.zeros_like(r)], dim=-1)
