"""Fast render path: closest-hit kernel + fused shade/scatter kernel +
host-driven stream compaction.

Counterpart of ``pathtrace_tpu/ops/fastpath.py`` (fused flavour, static
sphere scenes). One bounce is two kernels:

* :func:`~pathtrace_tpu_torch.ops.intersect_kernel.sphere_nearest` — the
  closest hit over every sphere, giving (t, idx) per ray;
* :func:`~pathtrace_tpu_torch.ops.shade_kernel.shade_from_winners` — reads
  each lane's winner row of the attribute table itself and runs texture,
  emission, sky and scatter in one pass.

Between bounces the host ladder reads lagged alive counts and compacts the
wavefront. Each count readback is a stream sync on CUDA; the ladder counts
them.

Attribute row layout (24 columns, as in the JAX package):
  cols 0-13   shading: mat_kind, fuzz, ref_idx, tex_kind, col_rgb,
              odd_rgb, even_rgb, noise_scale
  col  14     kind (0: sphere)
  cols 15-23  cx cy cz dx dy dz time0 inv_dt radius

The bounce RNG is the stateless counter hash of the JAX package, keyed on
(lane, seed, depth, draw) and reproduced bit for bit. torch on the CPU has
no uint32 ``+`` or ``>>``, so the hash computes in int64 and masks to 32
bits; products by a 32-bit constant are split in 16-bit halves so no
int64 product overflows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops.intersect_kernel import sphere_nearest
from pathtrace_tpu_torch.ops.shade_kernel import (
    FLAG_CHECKER,
    FLAG_DIELECTRIC,
    FLAG_LAMBERTIAN,
    FLAG_LIGHT,
    FLAG_METAL,
    FLAG_NOISE,
    shade_from_winners,
)
from pathtrace_tpu_torch.render import compact_util

TILE_N = 128   # sphere tables pad to a multiple of this
GEO = 15       # first geometry column of an attribute row
K_ATTR = 24

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# counter-hash RNG and hash noise (bit-exact twins of the JAX functions)
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, without an int64 product above 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & _M32


def _to_f32_unit(h: torch.Tensor) -> torch.Tensor:
    # (h >> 8) < 2**24, so the int32 -> f32 conversion is exact
    return (h >> 8).to(torch.int32).to(torch.float32)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 2146121005)
    h = h ^ (h >> 15)
    h = _mul32(h, 2654435769)
    h = h ^ (h >> 13)
    return h


def counter_uniform(lane: torch.Tensor, seed: int, depth: int,
                    draw: int) -> torch.Tensor:
    """Stateless counter-hash uniform in [0, 1).

    ``lane``: integer tensor of lane ids (uint32 bit patterns); ``seed``:
    the int32 seed (its bit pattern is used); ``depth``, ``draw``: ints."""
    k = ((int(seed) & _M32) * 2891336453 + (int(depth) & _M32) * 1013904223
         + draw * 374761393) & _M32
    h = (_mul32(_u32(lane), 747796405) + k) & _M32
    h = _mix32(h)
    return _to_f32_unit(h) * (1.0 / 16777216.0)


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """Lattice hash; negative coordinates wrap as two's complement."""
    h = (_mul32(_u32(ix), 374761393) + _mul32(_u32(iy), 668265263)
         + _mul32(_u32(iz), 1103515245)) & _M32
    h = h ^ (h >> 13)
    h = _mul32(h, 1274126177)
    return h ^ (h >> 16)


def _hash_unit(h: torch.Tensor) -> torch.Tensor:
    return _to_f32_unit(h) * (2.0 / 16777216.0) - 1.0


def cbrt_pos(x: torch.Tensor) -> torch.Tensor:
    """cbrt for x in [0, 1) via exp/log, the form the JAX package uses."""
    return torch.exp(torch.log(torch.clamp(x, min=1e-38)) * (1.0 / 3.0))


def fast_noise_c(px: torch.Tensor, py: torch.Tensor,
                 pz: torch.Tensor) -> torch.Tensor:
    """Hash-gradient Hermite noise on component tensors."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix = fx.to(torch.int32).to(torch.int64)
    iy = fy.to(torch.int32).to(torch.int64)
    iz = fz.to(torch.int32).to(torch.int64)
    u, v, w = px - fx, py - fy, pz - fz
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    accum = torch.zeros_like(px)
    for di in (0, 1):
        wu = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wv = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wwk = ww if dk else (1.0 - ww)
                h = _hash3(ix + di, iy + dj, iz + dk)
                gx = _hash_unit(h)
                gy = _hash_unit((_mul32(h, 1664525) + 1013904223) & _M32)
                gz = _hash_unit((_mul32(h, 22695477) + 1) & _M32)
                dot = gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                accum = accum + wu * wv * wwk * dot
    return accum


def fast_turb_c(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
                octaves: int = 7) -> torch.Tensor:
    accum = torch.zeros_like(px)
    weight = 1.0
    for _ in range(octaves):
        accum = accum + weight * fast_noise_c(px, py, pz)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(accum)


# ---------------------------------------------------------------------------
# support gate and attribute tables
# ---------------------------------------------------------------------------

def attr_width(features: SceneFeatures) -> int:
    """24 columns: the sphere row (image textures and boxes, which widen
    it in the JAX package, are not in this port yet)."""
    return K_ATTR


def fastpath_supported(features: SceneFeatures) -> bool:
    """True for the scene classes this port renders: static spheres with
    Lambertian, metal, dielectric or emissive materials and constant,
    checker (constant children) or noise textures. Raises ``ValueError``
    naming what is missing for anything else."""
    missing = [name for name, on in (
        ("moving spheres", features.has_motion),
        ("rects", features.has_rects),
        ("boxes", features.has_boxes),
        ("media", features.has_media),
        ("image textures", features.has_image),
        ("isotropic materials", features.has_isotropic),
        ("checker textures with non-constant children",
         features.has_checker and not features.checker_children_const),
    ) if on]
    if missing:
        raise ValueError(
            f"scene needs {', '.join(missing)}: not ported yet"
        )
    return True


def feature_flags(features: SceneFeatures) -> int:
    """Runtime bitmask of the shade branches a scene needs."""
    flags = 0
    for on, bit in ((features.has_checker, FLAG_CHECKER),
                    (features.has_noise, FLAG_NOISE),
                    (features.has_lambertian, FLAG_LAMBERTIAN),
                    (features.has_metal, FLAG_METAL),
                    (features.has_dielectric, FLAG_DIELECTRIC),
                    (features.has_light, FLAG_LIGHT)):
        if on:
            flags |= bit
    return flags


def _shade_cols(scene: Scene, mat_id: torch.Tensor):
    mats = scene.materials
    tex = scene.textures
    mat_id = mat_id.long()
    tid = mats.tex_id[mat_id].long()
    odd = tex.odd_id[tid].long()
    even = tex.even_id[tid].long()
    return [
        mats.kind[mat_id].to(torch.float32),
        mats.fuzz[mat_id],
        mats.ref_idx[mat_id],
        tex.kind[tid].to(torch.float32),
        tex.color[tid][:, 0], tex.color[tid][:, 1], tex.color[tid][:, 2],
        tex.color[odd][:, 0], tex.color[odd][:, 1], tex.color[odd][:, 2],
        tex.color[even][:, 0], tex.color[even][:, 1], tex.color[even][:, 2],
        tex.scale[tid],
    ]


def _finish_table(cols, mask, dead_col: int, n_pad: int, k_attr: int):
    table = torch.stack(cols, dim=1)
    table = torch.where(mask[:, None], table, 0.0)
    table[:, dead_col] = torch.where(mask, table[:, dead_col], 1.0e18)
    rows = table.shape[0]
    if n_pad > rows:
        pad = table.new_zeros((n_pad - rows, table.shape[1]))
        pad[:, dead_col] = 1.0e18
        table = torch.cat([table, pad], dim=0)
    if table.shape[1] < k_attr:
        table = torch.cat(
            [table, table.new_zeros((table.shape[0], k_attr - table.shape[1]))],
            dim=1,
        )
    return table


def build_sphere_table(scene: Scene, k_attr: int) -> torch.Tensor:
    """[Npad, k_attr] winner-row table, Npad a multiple of 128; dead and
    padding rows get cx = 1e18."""
    sp = scene.spheres
    cols = _shade_cols(scene, sp.mat_id) + [
        torch.zeros_like(sp.radius),                     # kind = 0 (sphere)
        sp.center[:, 0], sp.center[:, 1], sp.center[:, 2],
        sp.center_delta[:, 0], sp.center_delta[:, 1], sp.center_delta[:, 2],
        sp.time0, sp.inv_time_delta, sp.radius,          # radius at GEO+8
    ]
    n_pad = ((sp.count + TILE_N - 1) // TILE_N) * TILE_N
    return _finish_table(cols, sp.mask, GEO, n_pad, k_attr)


def build_sphere_soa(scene: Scene) -> torch.Tensor:
    """[5, Npad] closest-hit operand: cx, cy, cz, |c|^2 - r^2, mask.
    Padding spheres sit at centre 1e18 with c-term 1e30 and mask 0."""
    sp = scene.spheres
    n = sp.count
    n_pad = ((n + TILE_N - 1) // TILE_N) * TILE_N
    c = sp.center
    cc_m_r2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
               - sp.radius * sp.radius)
    soa = torch.stack([c[:, 0], c[:, 1], c[:, 2], cc_m_r2,
                       sp.mask.to(torch.float32)])
    if n_pad > n:
        pad = soa.new_zeros((5, n_pad - n))
        pad[:3] = 1.0e18
        pad[3] = 1.0e30
        soa = torch.cat([soa, pad], dim=1)
    return soa.contiguous()


class FastTables(NamedTuple):
    table: torch.Tensor   # [Npad, 24] winner rows
    soa: torch.Tensor     # [5, Npad] closest-hit operand
    sky4: torch.Tensor    # [4] sky rgb + use_gradient_sky


def prep_tables(scene: Scene, features: SceneFeatures) -> FastTables:
    """Per-trace tables, on the scene's device."""
    sky4 = torch.cat([scene.sky.to(torch.float32).reshape(3),
                      scene.use_gradient_sky.to(torch.float32).reshape(1)])
    return FastTables(
        table=build_sphere_table(scene, attr_width(features)).contiguous(),
        soa=build_sphere_soa(scene),
        sky4=sky4.contiguous(),
    )


# ---------------------------------------------------------------------------
# wavefront state and the bounce
# ---------------------------------------------------------------------------

# rows of FastStateP.planes (and of the shade kernel's output)
RO, RD, RAD, THR = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)


@dataclasses.dataclass
class FastStateP:
    """Plane-form wavefront state.

    ``planes`` packs the twelve float planes the shade kernel rewrites
    (ro xyz, rd xyz, radiance rgb, throughput rgb) as one [12, R] tensor,
    so a compaction moves them with one gather and the closest-hit kernel
    reads ``planes[:6]`` in place."""

    planes: torch.Tensor  # [12, R] f32
    time: torch.Tensor    # [R] f32
    alive: torch.Tensor   # [R] bool
    lane: torch.Tensor    # [R] int32, uint32 bit pattern of the RNG stream id

    @property
    def size(self) -> int:
        return self.alive.shape[0]


def make_state(ro: torch.Tensor, rd: torch.Tensor,
               time: torch.Tensor) -> FastStateP:
    R = ro.shape[0]
    dev = ro.device
    planes = torch.empty((12, R), dtype=torch.float32, device=dev)
    planes[RO] = ro.T
    planes[RD] = rd.T
    planes[RAD] = 0.0
    planes[THR] = 1.0
    return FastStateP(
        planes=planes,
        time=time.to(torch.float32).contiguous(),
        alive=torch.ones(R, dtype=torch.bool, device=dev),
        lane=torch.arange(R, dtype=torch.int32, device=dev),
    )


def fast_bounce_fused(tables: FastTables, state: FastStateP, seed: int,
                      depth: int, max_depth: int,
                      features: SceneFeatures) -> FastStateP:
    """One bounce: closest hit, then the fused shade/scatter pass."""
    t, idx = sphere_nearest(tables.soa, state.planes[:6], MIN_T, MAX_T)
    planes, alive = shade_from_winners(
        tables.table, idx, t, state.planes, state.time, state.alive,
        state.lane, seed, depth, max_depth, tables.sky4,
        feature_flags(features),
    )
    return FastStateP(planes=planes, time=state.time, alive=alive,
                      lane=state.lane)


def _bounce_group_fused(tables, state, seed, depth0, max_depth, features,
                        group, segs):
    """``group`` bounces; ``segs`` (device int64) gains sum(alive) before
    each bounce: every live lane traces one segment."""
    for g in range(group):
        segs = segs + state.alive.sum()
        state = fast_bounce_fused(tables, state, seed, depth0 + g,
                                  max_depth, features)
    return state, segs


# ---------------------------------------------------------------------------
# host ladder and trace
# ---------------------------------------------------------------------------

# Knobs of the compaction ladder: the JAX package's starting values, not
# yet measured on CUDA (see PERF.md). None of them changes an image.
# Above this many lanes the ladder compacts by 128-lane ROWS first.
LANE_COMPACT_MAX = 1 << 19
# Compact when the alive rung is at most this fraction of the size.
COMPACT_SHRINK = 0.35
ROW_SHRINK = 0.75
SMALL_SHRINK = 0.6
# Bounces between alive-count readbacks.
GROUP = 1


class _AliveCounts:
    """[alive lanes, alive 128-lane rows] of a state, copied to the host
    asynchronously; :meth:`read` waits for that copy only (on CUDA, a
    sync on an event recorded right after the count)."""

    def __init__(self, alive: torch.Tensor):
        lanes = alive.sum()
        if alive.shape[0] % 128 == 0:
            rows = alive.view(-1, 128).any(dim=1).sum()
        else:
            rows = lanes
        counts = torch.stack([lanes, rows])
        if counts.is_cuda:
            self._host = torch.empty(2, dtype=counts.dtype, pin_memory=True)
            self._host.copy_(counts, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = counts, None

    def read(self):
        if self._event is not None:
            self._event.synchronize()
        lanes, rows = self._host.tolist()
        return int(lanes), int(rows)


class TraceResult(NamedTuple):
    radiance: torch.Tensor   # [R, 3] f32
    ray_count: torch.Tensor  # [] int64 on the device: segments traced
    readbacks: int           # alive-count readbacks (host syncs)


def _host_ladder(step, state: FastStateP, max_depth: int, min_size: int,
                 compaction: bool):
    """Bounce loop with lagged alive counts and the two-tier compaction
    ladder (rows above LANE_COMPACT_MAX lanes, exact lanes below).

    Each group's count is read one group later: the alive set only
    shrinks, so a lagged count is a safe upper bound, and the copy has
    landed by then while the next group runs on the device."""
    R = state.size
    dev = state.alive.device
    out_radiance = torch.zeros((3, R), dtype=torch.float32, device=dev)
    indices = torch.arange(R, dtype=torch.int64, device=dev)
    identity = True  # no compaction yet: flushes are dense adds
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    size = R
    pending = None
    readbacks = 0
    depth = 0
    while depth <= max_depth:
        g = min(GROUP, max_depth + 1 - depth)
        state, segs = step(state, depth, g, segs)
        depth += g
        if depth > max_depth:
            break
        new_pending = _AliveCounts(state.alive)
        if pending is not None:
            lag_lanes, lag_rows = pending.read()
            readbacks += 1
            if lag_lanes == 0:
                break
            if compaction:
                next_size = compact_util.rung(lag_lanes, min_size)
                if size > LANE_COMPACT_MAX and size % 128 == 0:
                    next_rows = compact_util.rung(lag_rows,
                                                  max(min_size // 128, 1))
                    if next_rows * 128 <= int(size * ROW_SHRINK):
                        out_radiance, state, indices = compact_util.compact_rows(
                            out_radiance, state, indices, next_rows, identity)
                        size, identity = next_rows * 128, False
                    elif next_size <= int(size * COMPACT_SHRINK):
                        out_radiance, state, indices = compact_util.compact(
                            out_radiance, state, indices, next_size, identity)
                        size, identity = next_size, False
                elif next_size <= int(size * SMALL_SHRINK):
                    out_radiance, state, indices = compact_util.compact(
                        out_radiance, state, indices, next_size, identity)
                    size, identity = next_size, False
        pending = new_pending
    out_radiance = compact_util.final_flush(out_radiance, state, indices,
                                            identity)
    return out_radiance, segs, readbacks


def trace_fast(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
               time: torch.Tensor, seed: int, max_depth: int,
               features: SceneFeatures, min_size: int = 1 << 15,
               compaction: bool = True) -> TraceResult:
    """Trace a wavefront of rays (ro, rd: [R, 3] unit directions; time
    [R]) on the scene's device. ``seed`` keys the bounce RNG (its int32
    bit pattern); lane id ``i`` keys ray i's stream, so compaction never
    changes a ray's result."""
    fastpath_supported(features)
    tables = prep_tables(scene, features)
    seed = int(seed)

    def step(state, depth, g, segs):
        return _bounce_group_fused(tables, state, seed, depth, max_depth,
                                   features, g, segs)

    state = make_state(ro, rd, time)
    out_radiance, segs, readbacks = _host_ladder(
        step, state, max_depth, max(min_size, 128), compaction)
    return TraceResult(out_radiance.T.contiguous(), segs, readbacks)


class FrameResult(NamedTuple):
    image: torch.Tensor      # [H, W, 3] f32 linear
    ray_count: torch.Tensor  # [] int64 on the device
    readbacks: int


def render_frame_fast(scene: Scene, camera, width: int, height: int,
                      samples: int, max_depth: int,
                      generator: torch.Generator, seed: int,
                      features: SceneFeatures) -> FrameResult:
    """Whole-frame render through the fast path. ``generator`` (on the
    scene's device) draws the primary-ray jitter; ``seed`` must be
    frame-unique and keys the bounce RNG."""
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    ro, rd, t = generate_primary_rays(camera, width, height, samples,
                                      generator)
    R = height * width * samples
    res = trace_fast(scene, ro.reshape(R, 3), rd.reshape(R, 3), t.reshape(R),
                     seed, max_depth, features)
    img = res.radiance.reshape(height, width, samples, 3).mean(dim=2)
    return FrameResult(img, res.ray_count, res.readbacks)

