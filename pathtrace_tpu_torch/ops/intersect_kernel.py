"""Closest hit over every sphere: the CUDA kernel ``csrc/sphere_nearest.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``pathtrace_tpu/ops/intersect_pallas.py``
``_kernel_static`` (reached through ``_sphere_nearest_call`` from
``sphere_nearest_pallas_cols``). Per ray, the nearest root in
(t_min, t_max) of the unit-direction quadratic over the masked spheres,
with ``b = ro.d - c.d`` and ``c = |ro|^2 - 2 c.ro + (|c|^2 - r^2)``: the
near root if it lies in the window, else the far one. Ties go to the
lowest sphere index; a miss gives (t_max, 0).

On the card the kernel is bound by fp32 arithmetic, about 20 flops per
ray-sphere pair (R x N x 20 per bounce), not by bytes: it reads 24 bytes
and writes 8 per ray. The sphere operand streams through shared memory in
tiles; each thread keeps its ray and running (t, idx) in registers.

Built with ``-fmad=false`` and IEEE sqrt, the kernel rounds every
operation as the plain version does, so the two agree bit for bit (t and
idx). Against the JAX package they agree only to a tolerance: the
expanded quadratic cancels (``|c|^2 - r^2`` of a small sphere ten units
away keeps few bits of ``r^2``), so XLA's different rounding of the same
terms moves t by up to ~1e-4 relative, and near-grazing or self-hit lanes
flip (see tests/test_torch_kernels.py).
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)

# rays per plain-version chunk: each [chunk, N] temporary takes
# chunk * N * 4 bytes whatever the wavefront size
PLAIN_CHUNK = 1 << 15


def sphere_nearest_plain(soa: torch.Tensor, rays: torch.Tensor,
                         t_min: float = MIN_T, t_max: float = MAX_T):
    """Plain PyTorch version, in ray chunks. ``soa``: [5, N] (cx, cy, cz,
    |c|^2 - r^2, mask); ``rays``: [6, R] (ro xyz, rd xyz, |rd| = 1).
    Returns (t [R] f32, idx [R] int32)."""
    cx, cy, cz, cc_m_r2 = (soa[k][None, :] for k in range(4))
    smask = soa[4][None, :] > 0
    R = rays.shape[1]
    t_out = torch.empty(R, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(R, dtype=torch.int32, device=rays.device)
    inf = torch.tensor(t_max, dtype=torch.float32, device=rays.device)
    for lo in range(0, R, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, R)
        ox, oy, oz, dx, dy, dz = (rays[k, lo:hi][:, None] for k in range(6))
        ro_d = ox * dx + oy * dy + oz * dz
        ro_ro = ox * ox + oy * oy + oz * oz
        b = ro_d - (cx * dx + cy * dy + cz * dz)
        c = ro_ro - 2.0 * (cx * ox + cy * oy + cz * oz) + cc_m_r2
        disc = b * b - c
        valid = (disc > 0.0) & smask
        # float64 root rounded once = the correctly rounded float32 sqrt
        # (what the kernel's IEEE sqrtf gives; torch's CPU float32 sqrt
        # can be one ULP off)
        sq = torch.sqrt(torch.clamp(disc, min=0.0).double()).float()
        t0 = -b - sq
        t1 = -b + sq
        t0_ok = valid & (t0 > t_min) & (t0 < t_max)
        t1_ok = valid & (t1 > t_min) & (t1 < t_max)
        t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, inf))
        tmin, imin = torch.min(t, dim=1)  # first index of the minimum
        t_out[lo:hi] = tmin
        i_out[lo:hi] = imin.to(torch.int32)
    return t_out, i_out


def _check(soa: torch.Tensor, rays: torch.Tensor) -> None:
    if soa.device != rays.device:
        raise ValueError(f"soa on {soa.device}, rays on {rays.device}")
    if soa.dtype != torch.float32 or rays.dtype != torch.float32:
        raise TypeError("sphere_nearest takes float32 tensors")
    if soa.dim() != 2 or soa.shape[0] != 5:
        raise ValueError(f"soa must be [5, N], got {tuple(soa.shape)}")
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be [6, R], got {tuple(rays.shape)}")
    if not soa.is_contiguous() or rays.stride(1) != 1:
        raise ValueError("soa must be contiguous and ray rows unit-stride")


def sphere_nearest(soa: torch.Tensor, rays: torch.Tensor,
                   t_min: float = MIN_T, t_max: float = MAX_T):
    """Closest hit for every ray: (t [R] f32, idx [R] int32).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot launch)."""
    global LAUNCHES, PLAIN_CALLS
    _check(soa, rays)
    if rays.device.type == "cpu":
        PLAIN_CALLS += 1
        return sphere_nearest_plain(soa, rays, t_min, t_max)
    if rays.device.type != "cuda":
        raise ValueError(f"sphere_nearest: unsupported device {rays.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R, N = rays.shape[1], soa.shape[1]
    t_out = torch.empty(R, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(R, dtype=torch.int32, device=rays.device)
    if R == 0:
        return t_out, i_out
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    code = lib.pt_sphere_nearest(
        rays.data_ptr(), rays.stride(0), R, soa.data_ptr(), N,
        float(t_min), float(t_max), t_out.data_ptr(), i_out.data_ptr(), stream,
    )
    _cuda_build.check(code, "sphere_nearest launch")
    LAUNCHES += 1
    return t_out, i_out
