"""Edge-avoiding à-trous wavelet denoiser, Dammertz et al., HPG 2010
(counterpart of ``pathtrace_tpu/render/denoise.py``; plain PyTorch).

Five sparse 5x5 B3-spline passes with holes that double each pass, each
tap weighted by its colour, normal and depth affinity to the centre from
the first-hit AOVs (:mod:`~pathtrace_tpu_torch.render.aov`). The albedo
is demodulated first (filter the irradiance, re-modulate after), so
texture detail does not blur. No TPU kernel computes it (the reference
writes it in ``jnp``), so it is elementwise PyTorch: 25 gathers and a
handful of elementwise operations a tap.

It keeps the reference's arithmetic: the edge clamp of ``_shift2d`` (a
clamped row and column gather; ``torch.roll`` would wrap around), each
tap's weight ``_H[iy] * _H[ix]`` as a float32 product, ``sigma_color``
halved each pass, and the depth range ``max - min`` over the whole depth
buffer.
"""

from __future__ import annotations

import numpy as np
import torch

# B3-spline tap weights, float32 as the reference holds them
_H = np.asarray([1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0],
                np.float32)


def _shift_index(n: int, d: int, device) -> torch.Tensor:
    """``clamp(i - d, 0, n - 1)``: the rows (or columns) a shift by ``d``
    reads, the edge repeated."""
    return torch.clamp(torch.arange(n, device=device) - d, 0, n - 1)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``x`` [H, W, ...] shifted by (dy, dx) with an edge clamp:
    ``out[y, x] = x[clamp(y - dy), clamp(x - dx)]``."""
    if dy:
        x = x.index_select(0, _shift_index(x.shape[0], dy, x.device))
    if dx:
        x = x.index_select(1, _shift_index(x.shape[1], dx, x.device))
    return x


def _sum3(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] + x[..., 1] + x[..., 2]


def atrous_denoise(color: torch.Tensor, normal: torch.Tensor,
                   albedo: torch.Tensor, depth: torch.Tensor,
                   iterations: int = 5, sigma_color: float = 0.35,
                   sigma_normal: float = 0.25,
                   sigma_depth: float = 0.05) -> torch.Tensor:
    """Denoise ``color`` [H, W, 3] guided by the first-hit AOVs (tensors
    on one device; numpy arrays are taken onto the colour's device).

    ``sigma_color`` halves every pass (the residual noise shrinks each
    pass, so the affinity tightens with it); ``sigma_depth`` is relative
    to the depth range. The albedo guide is clamped to [1e-3, 1], so an
    emitter does not demodulate into near-zero irradiance. Returns the
    filtered image."""
    color = torch.as_tensor(color, dtype=torch.float32)
    dev = color.device

    def on(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    normal, albedo, depth = on(normal), on(albedo), on(depth)
    eps = 1e-3
    alb = torch.clamp(albedo, eps, 1.0)
    irr = color / alb                      # demodulate texture detail
    drange = torch.clamp(depth.max() - depth.min(), min=1e-6)
    d = depth / drange

    inv_sn2 = 1.0 / (2.0 * sigma_normal ** 2)
    inv_sd2 = 1.0 / (2.0 * sigma_depth ** 2)

    out = irr
    for it in range(iterations):
        step = 1 << it
        sc = sigma_color / (2.0 ** it)
        inv_sc2 = 1.0 / (2.0 * sc ** 2)
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype, device=dev)
        for iy in range(-2, 3):
            for ix in range(-2, 3):
                h = float(_H[iy + 2] * _H[ix + 2])  # a float32 product
                cq = _shift2d(out, iy * step, ix * step)
                nq = _shift2d(normal, iy * step, ix * step)
                dq = _shift2d(d, iy * step, ix * step)
                wc = _sum3((out - cq) ** 2) * inv_sc2
                wn = _sum3((normal - nq) ** 2) * inv_sn2
                wd = (d - dq) ** 2 * inv_sd2
                w = h * torch.exp(-(wc + wn + wd))[..., None]
                acc = acc + cq * w
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-12)

    return out * alb                      # re-modulate the albedo
