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

:class:`SphereNearest` makes the closest hit differentiable, the
counterpart of the reference's custom VJP (``_sphere_nearest_vjp``,
``intersect_pallas.py:639-683``): the forward is the kernel above, the
backward is the kernel ``csrc/sphere_nearest_bwd.cu`` (K6), which
recomputes the winner's root from (t, idx) and differentiates it in O(R).
Static scenes only: ray time and the motion leaves get no gradient.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)
BWD_LAUNCHES = 0     # K6 launches (CUDA tensors)
BWD_PLAIN_CALLS = 0  # K6 calls served with the plain version (CPU)

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


# ---------------------------------------------------------------------------
# backward (K6) and the differentiable closest hit
# ---------------------------------------------------------------------------

def _winner_t(center, radius, ro, rd, idx, t_min, t_max):
    """The winner's root, recomputed differentiably from ``idx``: the
    twin of the reference's ``_winner_t`` (``intersect_pallas.py:649``)
    for static spheres, with the same root choice and t window as the
    forward and the double-where guard on the square root. Each
    intermediate feeds at most two later operations, so autograd's
    accumulation order cannot change a bit."""
    oc = ro - center.index_select(0, idx)
    r = radius.index_select(0, idx)
    p = oc * rd
    b = (p[:, 0] + p[:, 1]) + p[:, 2]
    q = oc.square()
    cq = ((q[:, 0] + q[:, 1]) + q[:, 2]) - r.square()
    disc = b.square() - cq
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    nb = -b
    t0 = nb - sq
    t1 = nb + sq
    use_t0 = pos & (t0 > t_min) & (t0 < t_max)
    return torch.where(use_t0, t0, t1)


def sphere_nearest_bwd_plain(center, radius, ro, rd, t, idx, g_t,
                             t_min: float = MIN_T, t_max: float = MAX_T):
    """Plain PyTorch version of K6: autograd through :func:`_winner_t`.
    Misses (``t == t_max``) get a zero gradient. Returns (g_center [N, 3],
    g_radius [N], g_ro [R, 3], g_rd [R, 3])."""
    g = torch.where(t < t_max, g_t, 0.0)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (center, radius, ro, rd)]
        tw = _winner_t(*leaves, idx.long(), t_min, t_max)
        grads = torch.autograd.grad(tw, leaves, g)
    return tuple(grads)


def _check_bwd(center, radius, ro, rd, t, idx, g_t) -> None:
    dev = t.device
    R, N = t.shape[0], radius.shape[0]
    for name, x, dtype, shape in (
        ("center", center, torch.float32, (N, 3)),
        ("radius", radius, torch.float32, (N,)),
        ("ro", ro, torch.float32, (R, 3)),
        ("rd", rd, torch.float32, (R, 3)),
        ("t", t, torch.float32, (R,)),
        ("idx", idx, torch.int32, (R,)),
        ("g_t", g_t, torch.float32, (R,)),
    ):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, t on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def sphere_nearest_bwd(center, radius, ro, rd, t, idx, g_t,
                       t_min: float = MIN_T, t_max: float = MAX_T):
    """Gradient of the closest-hit distance ``t`` (cotangent ``g_t``)
    with respect to the sphere centres and radii and the rays:
    (g_center [N, 3], g_radius [N], g_ro [R, 3], g_rd [R, 3]).

    CPU tensors run the plain version; CUDA tensors launch K6 on the
    current stream (raising if it cannot launch)."""
    global BWD_LAUNCHES, BWD_PLAIN_CALLS
    _check_bwd(center, radius, ro, rd, t, idx, g_t)
    if t.device.type == "cpu":
        BWD_PLAIN_CALLS += 1
        return sphere_nearest_bwd_plain(center, radius, ro, rd, t, idx, g_t,
                                        t_min, t_max)
    if t.device.type != "cuda":
        raise ValueError(f"sphere_nearest_bwd: unsupported device {t.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    center, radius, ro, rd, t, idx, g_t = (
        x.contiguous() for x in (center, radius, ro, rd, t, idx, g_t))
    R, N = t.shape[0], radius.shape[0]
    g_center = torch.zeros_like(center)
    g_radius = torch.zeros_like(radius)
    g_ro = torch.empty_like(ro)
    g_rd = torch.empty_like(rd)
    if R == 0:
        return g_center, g_radius, g_ro, g_rd
    stream = torch.cuda.current_stream(t.device).cuda_stream
    code = lib.pt_sphere_nearest_bwd(
        ro.data_ptr(), rd.data_ptr(), t.data_ptr(), idx.data_ptr(),
        g_t.data_ptr(), R, center.data_ptr(), radius.data_ptr(), N,
        float(t_min), float(t_max), g_ro.data_ptr(), g_rd.data_ptr(),
        g_center.data_ptr(), g_radius.data_ptr(), stream,
    )
    _cuda_build.check(code, "sphere_nearest_bwd launch")
    BWD_LAUNCHES += 1
    return g_center, g_radius, g_ro, g_rd


class SphereNearest(torch.autograd.Function):
    """Differentiable closest hit: ``apply(soa, center, radius, ro, rd)``
    gives (t [R], idx [R] int32).

    ``soa`` is the [5, Npad] operand of :func:`sphere_nearest`, built from
    the same ``center`` and ``radius`` (``fastpath.build_sphere_soa``);
    it gets no gradient, as in the reference, where none flows through
    the kernel's ``|c|^2 - r^2`` term. ``ro``/``rd`` are [R, 3] and are
    packed per call into the kernel's [6, R] planes. The backward (K6)
    gives gradients to ``center``, ``radius``, ``ro`` and ``rd``."""

    @staticmethod
    def forward(ctx, soa, center, radius, ro, rd):
        rays = torch.cat([ro, rd], dim=1).T.contiguous()
        t, idx = sphere_nearest(soa, rays, MIN_T, MAX_T)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(center, radius, ro, rd, t, idx)
        return t, idx

    @staticmethod
    def backward(ctx, g_t, _g_idx):
        center, radius, ro, rd, t, idx = ctx.saved_tensors
        g_center, g_radius, g_ro, g_rd = sphere_nearest_bwd(
            center, radius, ro, rd, t, idx, g_t.contiguous())
        return None, g_center, g_radius, g_ro, g_rd
