"""Table Perlin noise and turbulence by gathers (counterpart of
``pathtrace_tpu/ops/perlin.py``), the general integrator's noise texture.

The eight corner lookups of each point are gathers from the scene's
:class:`~pathtrace_tpu_torch.models.types.PerlinTables`: the hash is
``perm_x[(i + di) & 255] ^ perm_y[(j + dj) & 255] ^ perm_z[(k + dk) & 255]``
on the integer floors (``& 255`` on a negative floor wraps as two's
complement, as in the reference), the gradient at the corner is dotted
with the offset, and the Hermite-weighted trilinear blend sums the eight.
Differentiable in the point and in ``randvec``. (The fast path's K2 uses
a hash noise instead, ``fastpath.fast_noise_c``, as the reference's fused
kernel does.)
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.models.types import PerlinTables


def noise(tables: PerlinTables, p: torch.Tensor) -> torch.Tensor:
    """Perlin gradient noise at the points ``p`` [..., 3]: [...]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    xf, yf, zf = torch.floor(x), torch.floor(y), torch.floor(z)
    u, v, w = x - xf, y - yf, z - zf
    i = xf.to(torch.int32)
    j = yf.to(torch.int32)
    k = zf.to(torch.int32)
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    perm = [t.to(torch.int64) for t in (tables.perm_x, tables.perm_y,
                                         tables.perm_z)]
    accum = torch.zeros_like(u)
    for di in (0, 1):
        px = perm[0][((i + di) & 255).long()]
        wu = uu if di else (1.0 - uu)
        for dj in (0, 1):
            py = perm[1][((j + dj) & 255).long()]
            wv = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                pz = perm[2][((k + dk) & 255).long()]
                wwk = ww if dk else (1.0 - ww)
                g = tables.randvec[px ^ py ^ pz]  # [..., 3]
                d = ((g[..., 0] * (u - di) + g[..., 1] * (v - dj))
                     + g[..., 2] * (w - dk))
                accum = accum + wu * wv * wwk * d
    return accum


def turb(tables: PerlinTables, p: torch.Tensor, depth: int = 7) -> torch.Tensor:
    """Turbulence: ``|sum over octaves of 0.5^o noise(2^o p)|``."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise(tables, temp_p)
        weight *= 0.5
        temp_p = temp_p * 2.0
    return torch.abs(accum)
