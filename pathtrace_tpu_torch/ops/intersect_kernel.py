"""Closest hit over every sphere: the CUDA kernels of
``csrc/sphere_nearest.cu`` and their plain PyTorch versions.

:func:`sphere_nearest` (K1) replaces the TPU kernel
``pathtrace_tpu/ops/intersect_pallas.py`` ``_kernel_static`` (reached
through ``_sphere_nearest_call`` from ``sphere_nearest_pallas_cols``). Per
ray, the nearest root in (t_min, t_max) of the unit-direction quadratic
over the masked spheres, with ``b = ro.d - c.d`` and
``c = |ro|^2 - 2 c.ro + (|c|^2 - r^2)``: the near root if it lies in the
window, else the far one. Ties go to the lowest sphere index; a miss gives
(t_max, 0).

:func:`sphere_nearest_moving` (K3) replaces ``_kernel_moving``
(``intersect_pallas.py:340``): the same closest hit with each centre
lerped to the ray's time, ``c = c0 + s * delta``, ``s = (time - time0) *
inv_dt``, in the reference's expanded form over the precomputed ``c0.delta``
and ``|delta|^2`` (``b -= s * delta.d``; ``c += -2 s delta.ro + 2 s c0.delta
+ s^2 |delta|^2``). Its operand is [12, N]; a static sphere (delta = 0,
inv_dt = 0) gives K1's result bit for bit. 38 operations a moving pair,
K1's 16 a static one.

On the card both are bound by issue slots, not by bytes (they read 24
bytes, 28 with the time, and write 8 per ray): built with ``-fmad=false``,
each of a pair's 16 additions and multiplications (38 for K3) is an
instruction of its own, and an SM sub-partition issues one warp
instruction a clock. Each thread keeps 4 rays (2 or 1 on a wavefront too
narrow to give the SMs 1.5 blocks each) and their running (t, idx) in registers; a tile's live spheres
are staged in shared memory as float4 rows in index order, each read once
for all of a thread's rays. The kernel's shortcuts are exact, and each
has a plain predicate here that the tests hold to the plain version
(tests/test_torch_sweep.py): it stages only the live slots
(:func:`staged_slots`), K3 skips the motion terms on static slots
(:func:`static_slots`) in blocks whose rays are all finite
(:func:`static_rays_ok`), and it picks the root without a t_max test
(:func:`kernel_root`).

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
recomputes the winner's root from (t, idx) and differentiates it in O(R),
four rays a thread, the per-sphere sums in a fixed order (a warp's
terms, then the block's warps in turn, then the blocks' rows of a buffer
column by column), so they have the same bits on every run;
:func:`bwd_launch` is its launch rule (grid, and a block's sums in shared
or device memory).
For moving spheres the forward is K3 and the backward differentiates the
lerped centre too: it gives gradients to the motion leaves (delta, time0,
inv_dt) and to the rays' time.

:func:`sphere_nearest_culled` is the same closest hit with per-tile AABB
culls, the kernel ``csrc/sphere_nearest_culled.cu``: K4, the flat cull
(the reference's ``_kernel_static_culled``, ``intersect_pallas.py:111``),
and K5, the two-level cull (``_kernel_static_culled2``, ``:212``). Each
thread holds 2 or 1 rays (:func:`culled_rays_per_thread`, the launcher's
rule: K4 2 on wide wavefronts, K5 1), mapped as K1 maps them, and a warp
of 32 x that many rays skips a 128-sphere tile when no ray of it can beat
its running best inside the tile's box (K5: first the supertile's box);
the sweeps it does run are K1's, live slots staged as float4 rows, so the
result equals K1's bit for bit. The plain version groups the rays as the
kernel does (:func:`cull_groups`) and counts the same (warp, tile)
sweeps, and the (ray, live slot) pairs they sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)
MOVING_LAUNCHES = 0     # K3 launches (CUDA tensors)
MOVING_PLAIN_CALLS = 0  # K3 calls served with the plain version (CPU)
BWD_LAUNCHES = 0     # K6 launches (CUDA tensors)
BWD_PLAIN_CALLS = 0  # K6 calls served with the plain version (CPU)
FLAT_LAUNCHES = 0     # K4 (flat cull) launches
FLAT_PLAIN_CALLS = 0  # K4 calls served with the plain version
HIER_LAUNCHES = 0     # K5 (two-level cull) launches
HIER_PLAIN_CALLS = 0  # K5 calls served with the plain version

TILE_N = 128       # spheres per cull tile
SUPER_TILES = 16   # member tiles per supertile of the two-level cull
WARP = 32          # lanes a warp, the culled kernels' skip unit
CULL_THREADS = 256  # threads a block of the culled kernels
H100_SMS = 132     # SMs the plain culls assume off the card
# K6's launch (bwd_launch): 4 rays a thread, 256 threads a block, a block
# per 1024 rays (a persistent grid of two blocks an SM was slower, PERF.md);
# per-block sums in shared memory up to the 227 KB a block may opt into on
# the H100 (faster than adding into device memory at 4096 spheres). Each
# block writes its sums to a row of a [blocks, 4 or 9 x N] buffer, which
# the column passes sum in a fixed order; fewer blocks, each a larger
# share of the rays, where the buffer would pass BWD_PARTIAL_BYTES
# (final_full's 1,024 moving-scene spheres at 3.69M rays: 133 MB)
BWD_RAYS, BWD_THREADS = 4, 256
BWD_SHARED_BYTES = 232_448
BWD_PARTIAL_BYTES = 256 << 20
BWD_SEG = 64  # buffer rows a block of the first column pass sums

# rays per plain-version chunk, at most PLAIN_CHUNK and at most
# PLAIN_PAIRS / N: each [chunk, N] temporary takes at most 4 PLAIN_PAIRS
# bytes whatever the wavefront and scene sizes
PLAIN_CHUNK = 1 << 15
PLAIN_PAIRS = 1 << 23


def _nearest_plain(cx, cy, cz, cc_m_r2, smask, rays, t_min, t_max,
                   motion=None):
    """K1's arithmetic on one chunk: ``rays`` [6, r] against the spheres'
    [1, n] rows; (t [r], first index of the minimum [r] int64).
    ``motion`` (K3): the [1, n] rows dx, dy, dz, time0, inv_dt, c.delta,
    |delta|^2 and the chunk's times [r]."""
    ox, oy, oz, dx, dy, dz = (rays[k][:, None] for k in range(6))
    ro_d = ox * dx + oy * dy + oz * dz
    ro_ro = ox * ox + oy * oy + oz * oz
    b = ro_d - (cx * dx + cy * dy + cz * dz)
    c = ro_ro - 2.0 * (cx * ox + cy * oy + cz * oz) + cc_m_r2
    if motion is not None:
        mx, my, mz, time0, inv_dt, c_dot_d, d2, time = motion
        s = (time[:, None] - time0) * inv_dt
        b = b - s * (mx * dx + my * dy + mz * dz)
        c = (c - 2.0 * s * (mx * ox + my * oy + mz * oz)
             + 2.0 * s * c_dot_d + s * s * d2)
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
    inf = torch.tensor(t_max, dtype=torch.float32, device=rays.device)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, inf))
    return torch.min(t, dim=1)  # first index of the minimum


def sphere_nearest_plain(soa: torch.Tensor, rays: torch.Tensor,
                         t_min: float = MIN_T, t_max: float = MAX_T,
                         time: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K1, in ray chunks. ``soa``: [5, N] (cx,
    cy, cz, |c|^2 - r^2, mask); ``rays``: [6, R] (ro xyz, rd xyz,
    |rd| = 1). Given the rays' ``time`` [R], the plain version of K3:
    ``soa`` is then [12, N] (adding dx, dy, dz, time0, inv_dt, c.delta,
    |delta|^2). Returns (t [R] f32, idx [R] int32)."""
    rows = [soa[k][None, :] for k in range(soa.shape[0])]
    spheres = rows[:4] + [rows[4] > 0]
    R = rays.shape[1]
    t_out = torch.empty(R, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(R, dtype=torch.int32, device=rays.device)
    step = max(1, min(PLAIN_CHUNK, PLAIN_PAIRS // max(soa.shape[1], 1)))
    for lo in range(0, R, step):
        hi = min(lo + step, R)
        motion = None if time is None else rows[5:] + [time[lo:hi]]
        tmin, imin = _nearest_plain(*spheres, rays[:, lo:hi], t_min, t_max,
                                    motion)
        t_out[lo:hi] = tmin
        i_out[lo:hi] = imin.to(torch.int32)
    return t_out, i_out


# |time0| and |ray time| at most this: K3 may skip a static slot's motion
# terms (csrc/sphere_nearest.cu kTimeBound)
STATIC_TIME_BOUND = 1e30


def staged_slots(soa: torch.Tensor) -> torch.Tensor:
    """The slots K1/K3 stage and sweep, in index order: the live ones
    (mask > 0). The plain version takes a pair only where the mask is
    set, so a masked slot never wins and leaving it out changes nothing.
    For tests."""
    return torch.nonzero(soa[4] > 0).flatten()


def static_slots(soa: torch.Tensor) -> torch.Tensor:
    """K3's static slots ([N] bool), whose motion terms the kernel skips:
    delta, inv_dt, c.delta and |delta|^2 all zero (either sign) and
    |time0| <= ``STATIC_TIME_BOUND``. With finite rays and times (see
    :func:`static_rays_ok`) every motion term is then +-0, so b and c keep
    their values up to the sign of a zero, b*b - c keeps its bits, and t
    does too (disc > 0 makes the root nonzero). For tests."""
    zero = (soa[5:8] == 0).all(dim=0) & (soa[9:12] == 0).all(dim=0)
    return zero & (soa[8].abs() <= STATIC_TIME_BOUND)


def static_rays_ok(rays: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """Per ray ([R] bool): origin and direction finite and |time| <=
    ``STATIC_TIME_BOUND``. K3 takes the static shortcut in a block of
    rays only when every ray of the block passes. For tests."""
    return torch.isfinite(rays).all(dim=0) & (time.abs() <= STATIC_TIME_BOUND)


def kernel_root(b: torch.Tensor, sq: torch.Tensor, t_min: float):
    """The kernel's root of a pair with disc > 0: t0 = -b - sq where
    t0 > t_min, else t1 = -b + sq; the pair wins where t > t_min and t is
    below the running best. No t_max test is needed: t0 <= t1 (rounding
    is monotone) and the running best never exceeds t_max. For tests."""
    t0 = -b - sq
    return torch.where(t0 > t_min, t0, -b + sq)


def _check(soa: torch.Tensor, rays: torch.Tensor, rows: int = 5) -> None:
    if soa.device != rays.device:
        raise ValueError(f"soa on {soa.device}, rays on {rays.device}")
    if soa.dtype != torch.float32 or rays.dtype != torch.float32:
        raise TypeError("sphere_nearest takes float32 tensors")
    if soa.dim() != 2 or soa.shape[0] != rows:
        raise ValueError(f"soa must be [{rows}, N], got {tuple(soa.shape)}")
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


def sphere_nearest_moving(soa: torch.Tensor, rays: torch.Tensor,
                          time: torch.Tensor, t_min: float = MIN_T,
                          t_max: float = MAX_T):
    """Closest hit over moving spheres (K3) for every ray at its time:
    (t [R] f32, idx [R] int32). ``soa`` is the [12, N] operand of
    ``fastpath.build_sphere_soa(..., motion=True)``; ``time`` [R].

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot launch)."""
    global MOVING_LAUNCHES, MOVING_PLAIN_CALLS
    _check(soa, rays, rows=12)
    R = rays.shape[1]
    if (time.device != rays.device or time.dtype != torch.float32
            or tuple(time.shape) != (R,) or not time.is_contiguous()):
        raise ValueError("time must be a contiguous float32 [R] tensor on "
                         f"{rays.device}")
    if rays.device.type == "cpu":
        MOVING_PLAIN_CALLS += 1
        return sphere_nearest_plain(soa, rays, t_min, t_max, time)
    if rays.device.type != "cuda":
        raise ValueError(f"sphere_nearest_moving: unsupported device "
                         f"{rays.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    N = soa.shape[1]
    t_out = torch.empty(R, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(R, dtype=torch.int32, device=rays.device)
    if R == 0:
        return t_out, i_out
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    code = lib.pt_sphere_nearest_moving(
        rays.data_ptr(), rays.stride(0), time.data_ptr(), R, soa.data_ptr(),
        N, float(t_min), float(t_max), t_out.data_ptr(), i_out.data_ptr(),
        stream,
    )
    _cuda_build.check(code, "sphere_nearest_moving launch")
    MOVING_LAUNCHES += 1
    return t_out, i_out


# ---------------------------------------------------------------------------
# backward (K6) and the differentiable closest hit
# ---------------------------------------------------------------------------

def _winner_t(center, radius, ro, rd, idx, t_min, t_max, motion=None):
    """The winner's root, recomputed differentiably from ``idx``: the
    twin of the reference's ``_winner_t`` (``intersect_pallas.py:649``),
    with the same root choice and t window as the forward and the
    double-where guard on the square root. ``motion`` (delta, time0,
    inv_dt, time) lerps the centre to the ray's time first. Each
    intermediate feeds at most two later operations (the lerp factor
    feeds one stack, whose three edges autograd sums in their order), so
    autograd's accumulation order cannot change a bit."""
    centre = center.index_select(0, idx)
    if motion is not None:
        delta, time0, inv_dt, time = motion
        dt = time - time0.index_select(0, idx)
        u = dt * inv_dt.index_select(0, idx)
        centre = centre + delta.index_select(0, idx) * torch.stack(
            [u, u, u], dim=1)
    oc = ro - centre
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
                             t_min: float = MIN_T, t_max: float = MAX_T,
                             motion=None):
    """Plain PyTorch version of K6: autograd through :func:`_winner_t`.
    Misses (``t == t_max``) get a zero gradient. Returns (g_center [N, 3],
    g_radius [N], g_ro [R, 3], g_rd [R, 3]); with ``motion`` (delta [N,
    3], time0 [N], inv_dt [N], time [R]) also (g_delta, g_time0,
    g_inv_dt, g_time)."""
    g = torch.where(t < t_max, g_t, 0.0)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (center, radius, ro, rd, *(motion or ()))]
        tw = _winner_t(*leaves[:4], idx.long(), t_min, t_max,
                       motion=leaves[4:] if motion is not None else None)
        grads = torch.autograd.grad(tw, leaves, g)
    return tuple(grads)


def _check_bwd(center, radius, ro, rd, t, idx, g_t, motion) -> None:
    dev = t.device
    R, N = t.shape[0], radius.shape[0]
    named = [
        ("center", center, torch.float32, (N, 3)),
        ("radius", radius, torch.float32, (N,)),
        ("ro", ro, torch.float32, (R, 3)),
        ("rd", rd, torch.float32, (R, 3)),
        ("t", t, torch.float32, (R,)),
        ("idx", idx, torch.int32, (R,)),
        ("g_t", g_t, torch.float32, (R,)),
    ]
    if motion is not None:
        named += [(name, x, torch.float32, shape) for name, x, shape in zip(
            ("delta", "time0", "inv_dt", "time"), motion,
            ((N, 3), (N,), (N,), (R,)))]
    for name, x, dtype, shape in named:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, t on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def bwd_launch(n_rays: int, n_spheres: int, moving: bool) -> tuple:
    """K6's launch rule: (blocks, shared). A block per ``BWD_THREADS``
    steps of ``BWD_RAYS`` rays, or as many blocks as the buffer of their
    sums (4 floats a sphere a block, 9 with motion) holds within
    ``BWD_PARTIAL_BYTES`` when that is fewer (each block then takes a
    larger share of the rays). ``shared``: a block's sums fit in
    ``BWD_SHARED_BYTES`` (read at the call), else the block sums in its
    row of the buffer in device memory."""
    row_bytes = (9 if moving else 4) * 4 * max(n_spheres, 1)
    shared = row_bytes <= BWD_SHARED_BYTES
    quads = -(-n_rays // BWD_RAYS)
    blocks = max(1, -(-quads // BWD_THREADS))
    return max(1, min(blocks, BWD_PARTIAL_BYTES // row_bytes)), shared


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous on a 16-byte boundary (K6 moves rays in float4s):
    a view that starts off it is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def sphere_nearest_bwd(center, radius, ro, rd, t, idx, g_t,
                       t_min: float = MIN_T, t_max: float = MAX_T,
                       motion=None):
    """Gradient of the closest-hit distance ``t`` (cotangent ``g_t``)
    with respect to the sphere centres and radii and the rays:
    (g_center [N, 3], g_radius [N], g_ro [R, 3], g_rd [R, 3]). With
    ``motion`` = (delta [N, 3], time0 [N], inv_dt [N], time [R]), the
    moving spheres' backward, which also gives (g_delta, g_time0,
    g_inv_dt, g_time).

    CPU tensors run the plain version; CUDA tensors launch K6 on the
    current stream (raising if it cannot launch), whose per-sphere sums
    are taken in a fixed order: the same bits on every run."""
    global BWD_LAUNCHES, BWD_PLAIN_CALLS
    _check_bwd(center, radius, ro, rd, t, idx, g_t, motion)
    if t.device.type == "cpu":
        BWD_PLAIN_CALLS += 1
        return sphere_nearest_bwd_plain(center, radius, ro, rd, t, idx, g_t,
                                        t_min, t_max, motion)
    if t.device.type != "cuda":
        raise ValueError(f"sphere_nearest_bwd: unsupported device {t.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    center, radius = center.contiguous(), radius.contiguous()
    ro, rd, t, idx, g_t = (_aligned(x) for x in (ro, rd, t, idx, g_t))
    R, N = t.shape[0], radius.shape[0]
    # the per-sphere sums are written whole by the kernel's last pass
    new = torch.zeros_like if R == 0 or N == 0 else torch.empty_like
    grads = [new(center), new(radius), torch.empty_like(ro),
             torch.empty_like(rd)]
    delta = time0 = inv_dt = time = None
    if motion is not None:
        delta, time0, inv_dt = (x.contiguous() for x in motion[:3])
        time = _aligned(motion[3])
        grads += [new(delta), new(time0), new(inv_dt),
                  torch.empty_like(time)]
    if R == 0 or N == 0:
        for g in grads[2:4] + grads[7:]:
            g.zero_()
        return tuple(grads)
    g_center, g_radius, g_ro, g_rd, g_delta, g_time0, g_inv_dt, g_time = (
        grads + [None] * 4)[:8]

    def ptr(x):
        return None if x is None else x.data_ptr()

    blocks, shared = bwd_launch(R, N, motion is not None)
    cols = (9 if motion is not None else 4) * N
    partial = torch.empty(blocks * cols, dtype=torch.float32,
                          device=t.device)
    segments = -(-blocks // BWD_SEG)
    mid = (torch.empty(segments * cols, dtype=torch.float32,
                       device=t.device) if segments > 1 else None)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    code = lib.pt_sphere_nearest_bwd(
        ptr(ro), ptr(rd), ptr(time), ptr(t), ptr(idx), ptr(g_t), R,
        ptr(center), ptr(delta), ptr(time0), ptr(inv_dt), ptr(radius), N,
        float(t_min), float(t_max), ptr(g_ro), ptr(g_rd), ptr(g_time),
        ptr(g_center), ptr(g_delta), ptr(g_time0), ptr(g_inv_dt),
        ptr(g_radius), ptr(partial), ptr(mid), blocks, int(shared), stream,
    )
    _cuda_build.check(code, "sphere_nearest_bwd launch")
    BWD_LAUNCHES += 1
    return tuple(grads)


def pack_rays(ro: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """[R, 3] origins and directions as the kernels' [6, R] planes, rows
    unit-stride for every R (one ray included)."""
    return torch.stack([ro[:, 0], ro[:, 1], ro[:, 2],
                        rd[:, 0], rd[:, 1], rd[:, 2]])


class SphereNearest(torch.autograd.Function):
    """Differentiable closest hit: ``apply(soa, center, radius, ro, rd)``
    gives (t [R], idx [R] int32); for moving spheres
    ``apply(soa, center, radius, ro, rd, delta, time0, inv_dt, time)``.

    ``soa`` is the operand of :func:`sphere_nearest` ([5, Npad]) or of
    :func:`sphere_nearest_moving` ([12, Npad]), built from the same
    leaves (``fastpath.build_sphere_soa``); it gets no gradient, as in the
    reference, where none flows through the kernel's precomputed terms.
    ``ro``/``rd`` are [R, 3] and are packed per call into the kernel's
    [6, R] planes. The backward (K6) gives gradients to ``center``,
    ``radius``, ``ro`` and ``rd``, and with motion to ``delta``,
    ``time0``, ``inv_dt`` and ``time``."""

    @staticmethod
    def forward(ctx, soa, center, radius, ro, rd, delta=None, time0=None,
                inv_dt=None, time=None):
        rays = pack_rays(ro, rd)
        ctx.moving = time is not None
        if ctx.moving:
            t, idx = sphere_nearest_moving(soa, rays, time.contiguous(),
                                           MIN_T, MAX_T)
            extra = (delta, time0, inv_dt, time)
        else:
            t, idx = sphere_nearest(soa, rays, MIN_T, MAX_T)
            extra = ()
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(center, radius, ro, rd, t, idx, *extra)
        return t, idx

    @staticmethod
    def backward(ctx, g_t, _g_idx):
        center, radius, ro, rd, t, idx, *extra = ctx.saved_tensors
        grads = sphere_nearest_bwd(center, radius, ro, rd, t, idx,
                                   g_t.contiguous(),
                                   motion=extra if ctx.moving else None)
        return (None, *grads)


# ---------------------------------------------------------------------------
# the culled closest hit: K4 (flat) and K5 (two-level)
# ---------------------------------------------------------------------------

_EPS = 1e-12   # |d| at or below this: the ray is parallel to that axis
_BIG = 1e30    # its reciprocal stand-in and its slab interval's ends


class CullBoxes(NamedTuple):
    """Boxes of the culled closest hit, built once per trace.

    ``tiles``: [6, T] per 128-sphere tile (lo x, y, z, hi x, y, z);
    ``supers``: [6, T / s_tiles] supertile boxes of the two-level cull
    (K5), or None for the flat cull (K4)."""

    tiles: torch.Tensor
    supers: Optional[torch.Tensor]
    s_tiles: int  # member tiles per supertile (1 for the flat cull)


def cull_mode(n_tiles: int):
    """The reference's automatic choice (``intersect_pallas.py:442-449``):
    (hier, s_tiles). The two-level cull when the scene spans at least two
    supertiles of ``SUPER_TILES`` tiles (of 32 above 1024 tiles), else the
    flat cull."""
    s_tiles = SUPER_TILES
    if n_tiles > 1024:
        s_tiles = max(s_tiles, 32)
    return n_tiles >= 2 * s_tiles, s_tiles


def cull_slots(n: int, hier: bool, s_tiles: int) -> int:
    """Sphere slots of the culled operand: ``n`` padded to whole tiles, and
    for the two-level cull to whole supertiles (``:467-470``)."""
    mult = TILE_N * (s_tiles if hier else 1)
    return ((n + mult - 1) // mult) * mult


def cull_boxes(center: torch.Tensor, radius: torch.Tensor,
               mask: torch.Tensor, n_slots: int, hier: bool,
               s_tiles: int) -> CullBoxes:
    """Conservative boxes (``intersect_pallas.py:518-549``): per tile of
    128 slots, the masked min/max of centre -/+ |radius|, padded by 1e-3.
    A tile with no live sphere gets an inverted box (lo = f32 max, hi =
    -f32 max), which the kernels skip. A supertile's box is the union of
    its member tiles' boxes. ``n_slots``: slots of the padded operand."""
    n = center.shape[0]
    c = center.detach().to(torch.float32)
    r_abs = radius.detach().to(torch.float32).abs()[:, None]
    lo = torch.where(mask[:, None], c - r_abs, MAX_T)
    hi = torch.where(mask[:, None], c + r_abs, -MAX_T)
    if n_slots > n:
        lo = torch.cat([lo, lo.new_full((n_slots - n, 3), MAX_T)])
        hi = torch.cat([hi, hi.new_full((n_slots - n, 3), -MAX_T)])
    n_tiles = n_slots // TILE_N
    lo_t = lo.T.reshape(3, n_tiles, TILE_N).amin(dim=2) - 1e-3
    hi_t = hi.T.reshape(3, n_tiles, TILE_N).amax(dim=2) + 1e-3
    tiles = torch.cat([lo_t, hi_t]).contiguous()
    if not hier:
        return CullBoxes(tiles, None, 1)
    supers = torch.cat([lo_t.reshape(3, -1, s_tiles).amin(dim=2),
                        hi_t.reshape(3, -1, s_tiles).amax(dim=2)])
    return CullBoxes(tiles, supers.contiguous(), s_tiles)


def _slab(lo, hi, o, inv, par):
    """``axis_interval`` of the reference (``intersect_pallas.py:153``)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1)
    tx = torch.maximum(t0, t1)
    inside = (o >= lo) & (o <= hi)
    tn = torch.where(par, torch.where(inside, -_BIG, _BIG), tn)
    tx = torch.where(par, torch.where(inside, _BIG, -_BIG), tx)
    return tn, tx


def _box_want(box, k, origin, inv, par, best_t, t_min, t_max):
    """Per ray: may a hit inside box ``k`` beat ``best_t`` (``want``,
    ``intersect_pallas.py:169-175``)?"""
    tn, tx = zip(*(_slab(box[a, k], box[3 + a, k], origin[a], inv[a],
                         par[a]) for a in range(3)))
    tenter = torch.maximum(torch.maximum(tn[0], tn[1]), tn[2])
    texit = torch.minimum(torch.minimum(tx[0], tx[1]), tx[2])
    return ((texit >= tenter) & (texit > t_min)
            & (tenter < torch.clamp(best_t, max=t_max)))


class CulledPlain(NamedTuple):
    """What :func:`sphere_nearest_culled_plain` returns."""

    t: torch.Tensor       # [R] f32
    idx: torch.Tensor     # [R] int32
    sweeps: torch.Tensor  # (group, tile) sweeps run, 0-d int64
    tests: torch.Tensor   # (ray, box) tests made, 0-d int64
    slots: torch.Tensor   # (ray, live slot) pairs swept, 0-d int64


def cull_groups(n_rays: int, k_rays: int, device=None) -> torch.Tensor:
    """The skip units of the culled kernels: [G, 32 * k_rays] ray indices,
    row g the rays of warp g % 8 of block g // 8. A block of
    ``CULL_THREADS`` threads holds ``CULL_THREADS * k_rays`` consecutive
    rays; thread ``x`` owns rays ``x + k * CULL_THREADS`` (k < k_rays), so
    a warp's rays are 32 consecutive ones in each of k_rays slices of the
    block (``csrc/sphere_nearest_culled.cu``, as K1 maps them). Indices
    of ``n_rays`` and above are the last block's missing rays."""
    per_block = CULL_THREADS * k_rays
    n_blocks = (n_rays + per_block - 1) // per_block
    b = torch.arange(n_blocks, device=device)[:, None, None, None]
    w = torch.arange(CULL_THREADS // WARP, device=device)[None, :, None, None]
    k = torch.arange(k_rays, device=device)[None, None, :, None]
    lane = torch.arange(WARP, device=device)[None, None, None, :]
    i = b * per_block + k * CULL_THREADS + w * WARP + lane
    return i.reshape(n_blocks * (CULL_THREADS // WARP), k_rays * WARP)


def culled_rays_per_thread(n_rays: int, hier: bool, n_sm: int = H100_SMS) -> int:
    """Rays a thread the culled kernels launch ``n_rays`` rays with on a
    card of ``n_sm`` SMs (``hier``: K5, else K4): the launcher's rule of
    ``csrc/sphere_nearest_culled.cu`` (``culled_rays_per_thread``),
    mirrored. K4 takes 2 when every SM gets at least 3 blocks of 2-ray
    threads, else 1; K5 takes 1 (measured on the H100, PERF.md)."""
    if hier:
        return 1
    return 2 if n_rays >= 3 * n_sm * CULL_THREADS * 2 else 1


def culled_kernel_rays(n_rays: int, hier: bool) -> int:
    """The rays a thread the kernel's launcher picks for ``n_rays`` rays on
    the current card (its C entry ``pt_sphere_nearest_culled_rays``)."""
    from pathtrace_tpu_torch.ops import _cuda_build

    return int(_cuda_build.library().pt_sphere_nearest_culled_rays(
        int(n_rays), int(hier)))


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def sphere_nearest_culled_plain(soa: torch.Tensor, rays: torch.Tensor,
                                cull: CullBoxes, t_min: float = MIN_T,
                                t_max: float = MAX_T,
                                k_rays: Optional[int] = None) -> CulledPlain:
    """Plain PyTorch version of K4/K5, with the kernel's skip unit: the
    rays in the kernel's warps of 32 x ``k_rays`` (:func:`cull_groups`;
    by default the launcher's choice for R rays on a card of this device's
    SM count, 132 on the CPU), tiles (and supertiles) in index order; per
    tile the slab test against each ray's running best, ``any`` per
    group, K1's arithmetic on the groups that want the tile. Empty tiles
    and supertiles are skipped untested. Returns :class:`CulledPlain`:
    (t, idx, sweeps, box tests, slots swept), where ``slots`` counts a
    group's rays (those below R) times the tile's live slots for each
    sweep, the figure that compares across units."""
    R = rays.shape[1]
    dev = rays.device
    if k_rays is None:
        k_rays = culled_rays_per_thread(R, cull.supers is not None,
                                        _sm_count(dev))
    groups = cull_groups(R, k_rays, dev)
    n_pad = groups.numel()
    if n_pad > R:
        rays = torch.cat([rays, rays.new_zeros((6, n_pad - R))], dim=1)
    live = torch.arange(n_pad, device=dev) < R
    origin = rays[0:3]
    d = rays[3:6]
    inv = torch.where(d.abs() > _EPS, 1.0 / d, _BIG)
    par = d.abs() <= _EPS
    best_t = torch.full((n_pad,), t_max, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    sweeps = torch.zeros((), dtype=torch.int64, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.zeros((), dtype=torch.int64, device=dev)
    n_tiles = cull.tiles.shape[1]
    tile_live = (cull.tiles[0] <= cull.tiles[3]).tolist()
    live_slots = (soa[4] > 0).reshape(n_tiles, TILE_N).sum(dim=1)
    supers = cull.supers
    n_inner = 1 if supers is None else cull.s_tiles
    super_live = (supers[0] <= supers[3]).tolist() if supers is not None else []
    for s in range(n_tiles // n_inner):
        tested = live
        if supers is not None:
            if not super_live[s]:
                continue
            want = live & _box_want(supers, s, origin, inv, par, best_t,
                                    t_min, t_max)
            tests += live.sum()
            tested = torch.zeros_like(live)
            tested[groups[want[groups].any(dim=1)].reshape(-1)] = True
            tested &= live
        for m in range(n_inner):
            k = s * n_inner + m
            if not tile_live[k]:
                continue
            want = tested & _box_want(cull.tiles, k, origin, inv, par,
                                      best_t, t_min, t_max)
            tests += tested.sum()
            swept = want[groups].any(dim=1)
            sweeps += swept.sum()
            rows = groups[swept].reshape(-1)
            rows = rows[rows < R]
            slots += rows.numel() * live_slots[k]
            sl = slice(k * TILE_N, (k + 1) * TILE_N)
            spheres = ([soa[j, sl][None, :] for j in range(4)]
                       + [soa[4, sl][None, :] > 0])
            for lo in range(0, rows.numel(), 4 * PLAIN_CHUNK):
                sel = rows[lo:lo + 4 * PLAIN_CHUNK]
                tmin, imin = _nearest_plain(*spheres, rays[:, sel], t_min,
                                            t_max)
                cur = best_t[sel]
                better = tmin < cur
                best_t[sel] = torch.where(better, tmin, cur)
                best_i[sel] = torch.where(better, (imin + k * TILE_N).int(),
                                          best_i[sel])
    return CulledPlain(best_t[:R], best_i[:R], sweeps, tests, slots)


def _check_cull(soa: torch.Tensor, rays: torch.Tensor,
                cull: CullBoxes) -> None:
    _check(soa, rays)
    n_tiles = cull.tiles.shape[1]
    if soa.shape[1] != n_tiles * TILE_N:
        raise ValueError(f"soa has {soa.shape[1]} slots for {n_tiles} tiles")
    boxes = [("tiles", cull.tiles, n_tiles)]
    if cull.supers is not None:
        if cull.s_tiles < 1 or n_tiles % cull.s_tiles:
            raise ValueError(f"{n_tiles} tiles in supertiles of {cull.s_tiles}")
        boxes.append(("supers", cull.supers, n_tiles // cull.s_tiles))
    for name, box, n in boxes:
        if box.device != rays.device or box.dtype != torch.float32:
            raise ValueError(f"{name} boxes must be float32 on {rays.device}")
        if tuple(box.shape) != (6, n) or not box.is_contiguous():
            raise ValueError(f"{name} boxes must be contiguous [6, {n}], "
                             f"got {tuple(box.shape)}")


def sphere_nearest_culled(soa: torch.Tensor, rays: torch.Tensor,
                          cull: CullBoxes, t_min: float = MIN_T,
                          t_max: float = MAX_T, count_sweeps: bool = False):
    """Closest hit with the per-tile AABB cull: K5 (two-level) when
    ``cull.supers`` is set, else K4 (flat). ``soa`` is the [5, 128 * T]
    operand of ``cull``'s tiles. Returns (t [R] f32, idx [R] int32,
    sweeps): equal to :func:`sphere_nearest` bit for bit; ``sweeps`` (a 0-d
    int64 tensor when ``count_sweeps``, else None) counts the (warp, tile)
    sweeps run, a warp being 32 x :func:`culled_rays_per_thread` rays (on
    the card: :func:`culled_kernel_rays`).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot launch)."""
    global FLAT_LAUNCHES, FLAT_PLAIN_CALLS, HIER_LAUNCHES, HIER_PLAIN_CALLS
    _check_cull(soa, rays, cull)
    hier = cull.supers is not None
    if rays.device.type == "cpu":
        if hier:
            HIER_PLAIN_CALLS += 1
        else:
            FLAT_PLAIN_CALLS += 1
        t, idx, sweeps, _, _ = sphere_nearest_culled_plain(soa, rays, cull,
                                                           t_min, t_max)
        return t, idx, sweeps if count_sweeps else None
    if rays.device.type != "cuda":
        raise ValueError(
            f"sphere_nearest_culled: unsupported device {rays.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R, N = rays.shape[1], soa.shape[1]
    t_out = torch.empty(R, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(R, dtype=torch.int32, device=rays.device)
    sweeps = (torch.zeros((), dtype=torch.int64, device=rays.device)
              if count_sweeps else None)
    if R == 0:
        return t_out, i_out, sweeps
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    code = lib.pt_sphere_nearest_culled(
        rays.data_ptr(), rays.stride(0), R, soa.data_ptr(), N,
        cull.tiles.data_ptr(), cull.tiles.shape[1],
        cull.supers.data_ptr() if hier else None, cull.s_tiles,
        float(t_min), float(t_max), t_out.data_ptr(), i_out.data_ptr(),
        sweeps.data_ptr() if count_sweeps else None, stream,
    )
    _cuda_build.check(code, "sphere_nearest_culled launch")
    if hier:
        HIER_LAUNCHES += 1
    else:
        FLAT_LAUNCHES += 1
    return t_out, i_out, sweeps
