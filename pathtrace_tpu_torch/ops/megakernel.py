"""The megakernel path: a ray's whole bounce loop in one kernel (K7,
``csrc/megakernel.cu``) and its plain PyTorch version.

Counterpart of ``pathtrace_tpu/ops/megakernel.py``: :func:`trace_megakernel`
traces a wavefront of rays through up to ``max_depth + 1`` closest-hit
passes over sphere (static or moving) and rect scenes with no boxes, media
or image textures, and returns each ray's radiance and the segments traced.
There is no host ladder and no compaction: each ray runs its loop to its
end in the kernel, and a lane whose ray has ended takes the next ray of
the wavefront (a persistent grid; ray ``i``'s result does not depend on
the thread that traces it).

Tables, in the megakernel's own layouts (bit for bit the JAX package's,
dead rows included):

* spheres, ``[Npad, 24]`` with Npad a multiple of 128: cx, cy, cz, dx, dy,
  dz, time0, inv_dt, radius, then the 14 shading columns (mat_kind, fuzz,
  ref_idx, tex_kind, colour rgb, odd rgb, even rgb, noise scale) and a zero.
  Dead and padding rows have cx = 1e18 and zeros elsewhere;
* rects, ``[128, 24]``: axis, a0, a1, b0, b1, k, flip, the 14 shading
  columns and three zeros. Dead rects have k = 1e18, a0 = 1 and a1 = -1
  (an empty interval); padding rows k = 1e18 and zeros elsewhere.

Per pass the closest hit is the megakernel's own arithmetic, not K1's:
the quadratic from the (time-lerped) centre, ``b = ro.d - c.d`` and
``c = ((|ro|^2 - 2 c.ro) + |c|^2) - r^2``, over every row, dead ones
included; ties go to the lowest index, and a rect beats the sphere
winner only when strictly nearer. K7 keeps the rows that can win
resident in shared memory (:func:`prep_tables`: ``sphere_rows`` and
``rect_rows``, every row whose geometry differs from all rows before it,
since a later copy never wins a tie), static sphere rows apart from
moving ones; :func:`resident_sweep_plain` is its sweep over them, for
tests. A scene whose resident rows take more than ``SHARED_LIMIT`` bytes
(:func:`scene_shared_bytes`) is refused. Shading then follows the JAX
megakernel, whose constants differ from the fast path's in places (the
metal cbrt's 1e-30 floor, the dielectric's clamped exit cosine). The
bounce RNG is the counter hash keyed on the ray's global index, the same
stream as the fast path's, so the two paths agree ray for ray wherever
no rounding flips a decision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_NOISE,
    Scene,
    SceneFeatures,
)
from pathtrace_tpu_torch.ops.fastpath import (
    _finish_table,
    _shade_cols,
    counter_uniform,
    fast_turb_c,
    feature_flags,
)
from pathtrace_tpu_torch.ops.intersect_kernel import PLAIN_CHUNK, TILE_N
from pathtrace_tpu_torch.ops.shade_kernel import TWO_PI, _int32

LAUNCHES = 0     # K7 launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)

K_PAD = 24          # floats per table row
SPHERE_SHADE = 9    # first shading column of a sphere row
RECT_SHADE = 7      # first shading column of a rect row
RECT_ROWS = TILE_N  # rows of the rect table: at most 128 rects
_INF = float(MAX_T)
SPHERE_GEOMETRY = 9  # cx, cy, cz, dx, dy, dz, time0, inv_dt, radius
RECT_GEOMETRY = 6    # axis, a0, a1, b0, b1, k
# |time0| at most this: a row with zero delta and inv_dt skips the lerp
STATIC_TIME_BOUND = 1e30
# shared memory a block may opt into on the H100 (227 KB): the most
# K7's resident scene may take
SHARED_LIMIT = 232_448


def megakernel_supported(features: SceneFeatures) -> bool:
    """The megakernel's scenes: no boxes, media or image textures, and
    checker textures only with constant children (the tables hold a
    checker's two child colours, which a noise or checker child lacks)."""
    return not (features.has_boxes or features.has_media or features.has_image
                or (features.has_checker
                    and not features.checker_children_const))


def _refuse_unsupported(features: SceneFeatures) -> None:
    if not megakernel_supported(features):
        raise ValueError("the megakernel takes no boxes, media, image "
                         "textures or checker textures with non-constant "
                         "children")


def build_sphere_table(scene: Scene) -> torch.Tensor:
    """``[Npad, 24]`` sphere rows (JAX ``megakernel.build_sphere_table``)."""
    sp = scene.spheres
    cols = [sp.center[:, 0], sp.center[:, 1], sp.center[:, 2],
            sp.center_delta[:, 0], sp.center_delta[:, 1],
            sp.center_delta[:, 2], sp.time0, sp.inv_time_delta, sp.radius,
            *_shade_cols(scene, sp.mat_id)]
    n_pad = ((sp.count + TILE_N - 1) // TILE_N) * TILE_N
    return _finish_table(cols, sp.mask, 0, n_pad, K_PAD)


def build_rect_table(scene: Scene) -> torch.Tensor:
    """``[128, 24]`` rect rows (JAX ``megakernel.build_rect_table``)."""
    rc = scene.rects
    if rc.count > RECT_ROWS:
        raise ValueError(f"the megakernel takes at most {RECT_ROWS} rects, "
                         f"got {rc.count}")
    cols = [rc.axis.to(torch.float32), rc.a0, rc.a1, rc.b0, rc.b1, rc.k,
            rc.flip, *_shade_cols(scene, rc.mat_id)]
    table = _finish_table(cols, rc.mask, 5, RECT_ROWS, K_PAD)
    # a dead rect's interval is empty (a0 = 1 > a1 = -1); padding rows stay
    # zero there
    table[:rc.count, 1:3] = torch.where(rc.mask[:, None],
                                        table[:rc.count, 1:3],
                                        table.new_tensor([1.0, -1.0]))
    return table


class MegaTables(NamedTuple):
    spheres: torch.Tensor  # [Npad, 24]
    rects: torch.Tensor    # [128, 24]
    sky4: torch.Tensor     # [4]: sky rgb, use_gradient_sky
    # K7's resident rows (int32): the static sphere rows, then the moving
    # ones, each in increasing index; and the rect rows
    sphere_rows: torch.Tensor
    n_static: int
    rect_rows: torch.Tensor


def resident_rows(table: torch.Tensor, cols: int) -> torch.Tensor:
    """Rows of ``table`` whose first ``cols`` columns differ bit for bit
    from those of every row before them, in increasing index (int64). A
    later copy of a row's geometry gives the same t and loses the tie to
    it, so the sweep over these rows picks what the sweep over all rows
    picks: the dead and padding rows, all alike, keep one."""
    bits = table[:, :cols].contiguous().view(torch.int32)
    _, inverse = torch.unique(bits, dim=0, return_inverse=True)
    n = table.shape[0]
    first = torch.full((int(inverse.max()) + 1 if n else 0,), n,
                       dtype=torch.int64, device=table.device)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=table.device),
                          "amin")
    return torch.sort(first).values


def static_rows(spheres: torch.Tensor) -> torch.Tensor:
    """Sphere rows ([N] bool) K7 sweeps without the lerp: delta and inv_dt
    zero (either sign) and |time0| <= ``STATIC_TIME_BOUND``. With a finite
    ray time the lerp then adds +-0 to the centre, which leaves the bits
    of b*b - c and of t as they are (the sign of a zero at most)."""
    return ((spheres[:, 3:6] == 0).all(dim=1) & (spheres[:, 7] == 0)
            & (spheres[:, 6].abs() <= STATIC_TIME_BOUND))


def scene_shared_bytes(n_static: int, n_moving: int, n_rects: int,
                       motion: bool) -> int:
    """Shared bytes of K7's resident scene (``csrc/megakernel.cu``
    scene_bytes, mirrored): 24 a static sphere row, 40 a moving one, each
    list padded to a multiple of 4, and 28 a rect. Without motion every
    sphere row takes the static form."""
    def pad4(n):
        return (n + 3) // 4 * 4

    n_s = n_static if motion else n_static + n_moving
    n_m = n_moving if motion else 0
    return 24 * pad4(n_s) + 40 * pad4(n_m) + 28 * n_rects


def prep_tables(scene: Scene) -> MegaTables:
    """The megakernel's tables, on the scene's device, with K7's resident
    rows (one host sync, once per scene). Instanced spheres or rects are
    refused (the tables hold world-space geometry)."""
    if scene.spheres.instanced or scene.rects.instanced:
        raise ValueError("the megakernel takes no instanced spheres or rects")
    sky4 = torch.cat([scene.sky.to(torch.float32).reshape(3),
                      scene.use_gradient_sky.to(torch.float32).reshape(1)])
    spheres, rects = build_sphere_table(scene), build_rect_table(scene)
    rows = resident_rows(spheres, SPHERE_GEOMETRY)
    fixed = static_rows(spheres).index_select(0, rows)
    sphere_rows = torch.cat([rows[fixed], rows[~fixed]]).to(torch.int32)
    rect_rows = resident_rows(rects, RECT_GEOMETRY).to(torch.int32)
    return MegaTables(spheres, rects, sky4.contiguous(),
                      sphere_rows.contiguous(), int(fixed.sum()),
                      rect_rows.contiguous())


def shared_bytes(tables: MegaTables, features: SceneFeatures) -> int:
    """The shared bytes K7 takes for ``tables`` under ``features``."""
    n = tables.sphere_rows.shape[0]
    return scene_shared_bytes(
        tables.n_static, n - tables.n_static,
        tables.rect_rows.shape[0] if features.has_rects else 0,
        features.has_motion)


def resident_sweep_plain(tables: MegaTables, o, d, tm, motion: bool):
    """K7's sphere sweep over its resident rows, in the kernel's
    arithmetic: static rows with |c|^2 and r^2 taken per row, moving rows
    lerped (with ``motion``; a ray whose time is not finite sweeps from a
    NaN origin), the least t and on equal t the lowest row. Returns (t
    [r], row [r]); a miss gives (MAX_T, 2^31 - 1). For tests: it must pick
    what :func:`_sphere_sweep` picks over every row."""
    sph = tables.spheres
    rows = tables.sphere_rows.long()
    n_s = tables.n_static if motion else rows.shape[0]
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    sx = (torch.where(torch.isfinite(tm)[:, None], ox, float("nan"))
          if motion else ox)
    ro_d = sx * dx + oy * dy + oz * dz
    ro_ro = sx * sx + oy * oy + oz * oz
    ts, row_ids = [], []
    for part, lerp in ((rows[:n_s], False), (rows[n_s:], True)):
        g = sph.index_select(0, part)
        cx, cy, cz, r = (g[None, :, k] for k in (0, 1, 2, 8))
        if lerp:
            s = (tm[:, None] - g[None, :, 6]) * g[None, :, 7]
            cx = cx + s * g[None, :, 3]
            cy = cy + s * g[None, :, 4]
            cz = cz + s * g[None, :, 5]
        cc = cx * cx + cy * cy + cz * cz
        b = ro_d - (cx * dx + cy * dy + cz * dz)
        c = ((ro_ro - 2.0 * (cx * ox + cy * oy + cz * oz)) + cc) - r * r
        disc = b * b - c
        sq = _sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t = torch.where(t0 > MIN_T, t0, -b + sq)
        ts.append(torch.where((disc > 0.0) & (t > MIN_T), t, _INF))
        row_ids.append(part.expand(o.shape[0], -1))
    t = torch.cat(ts, dim=1)
    row_id = torch.cat(row_ids, dim=1)
    best = t.min(dim=1).values
    tied = torch.where(t == best[:, None], row_id, 2 ** 31 - 1)
    return best, torch.where(best < _INF, tied.min(dim=1).values, 2 ** 31 - 1)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as the kernel's IEEE sqrtf
    (through float64, rounded once: torch's CPU float32 sqrt can be one
    ULP off)."""
    return torch.sqrt(x.double()).float()


def _sphere_sweep(sph, o, d, tm, motion: bool):
    """Closest sphere of each ray: (t [r], first index of the minimum [r])
    over every row of the table, in the kernel's operation order."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    cx, cy, cz = (sph[None, :, k] for k in range(3))
    if motion:
        s = (tm[:, None] - sph[None, :, 6]) * sph[None, :, 7]
        cx = cx + s * sph[None, :, 3]
        cy = cy + s * sph[None, :, 4]
        cz = cz + s * sph[None, :, 5]
    r = sph[None, :, 8]
    ro_d = ox * dx + oy * dy + oz * dz
    ro_ro = ox * ox + oy * oy + oz * oz
    b = ro_d - (cx * dx + cy * dy + cz * dz)
    c = ((ro_ro - 2.0 * (cx * ox + cy * oy + cz * oz))
         + (cx * cx + cy * cy + cz * cz)) - r * r
    disc = b * b - c
    valid = disc > 0.0
    sq = _sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(valid & (t0 > MIN_T), t0,
                    torch.where(valid & (t1 > MIN_T), t1, _INF))
    return torch.min(t, dim=1)


def _rect_sweep(rect, o, d):
    """Closest rect of each ray: (t [r], first index of the minimum [r])."""
    axis, a0, a1, b0, b1, kk = (rect[None, :, k] for k in range(6))
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    is_x, is_y, is_z = axis == 0.0, axis == 1.0, axis == 2.0
    o_n = torch.where(is_x, ox, torch.where(is_y, oy, oz))
    d_n = torch.where(is_x, dx, torch.where(is_y, dy, dz))
    o_a = torch.where(is_x, oy, ox)
    d_a = torch.where(is_x, dy, dx)
    o_b = torch.where(is_z, oy, oz)
    d_b = torch.where(is_z, dy, dz)
    d_n = torch.where(torch.abs(d_n) < 1e-12, 1e-12, d_n)
    t = (kk - o_n) / d_n
    pa = o_a + t * d_a
    pb = o_b + t * d_b
    ok = (t > MIN_T) & (pa >= a0) & (pa <= a1) & (pb >= b0) & (pb <= b1)
    return torch.min(torch.where(ok, t, _INF), dim=1)


def _bounce_plain(tables: MegaTables, o, d, tm, th, ra, lane, seed: int,
                  depth: int, f: SceneFeatures):
    """One pass of the loop for live rays: (o, d, th, ra, alive, hit,
    noise), the last two the rays that were shaded and those whose winner
    has the noise texture (the work the kernel does past the sweeps)."""
    sph, rect, sky4 = tables.spheres, tables.rects, tables.sky4
    t, best = _sphere_sweep(sph, o, d, tm, f.has_motion)
    row = sph.index_select(0, best)
    centre = row[:, 0:3]
    if f.has_motion:
        s = (tm - row[:, 6]) * row[:, 7]
        centre = centre + s[:, None] * row[:, 3:6]
    radius = row[:, 8]
    inv_r = 1.0 / torch.where(torch.abs(radius) < 1e-12, 1.0, radius)
    sh = row[:, SPHERE_SHADE:SPHERE_SHADE + 14]
    if f.has_rects:
        rc_t, rc_best = _rect_sweep(rect, o, d)
        rect_wins = rc_t < t
        t = torch.where(rect_wins, rc_t, t)
    hit = t < _INF
    p = o + torch.where(hit, t, 0.0)[:, None] * d
    n = (p - centre) * inv_r[:, None]
    if f.has_rects:
        rrow = rect.index_select(0, rc_best)
        axis, flip = rrow[:, 0], rrow[:, 6]
        rn = torch.stack([torch.where(axis == a, flip, 0.0) for a in
                          (0.0, 1.0, 2.0)], dim=1)
        n = torch.where(rect_wins[:, None], rn, n)
        sh = torch.where(rect_wins[:, None],
                         rrow[:, RECT_SHADE:RECT_SHADE + 14], sh)

    mat_kind, fuzz, ref_idx, tex_kind = sh[:, 0], sh[:, 1], sh[:, 2], sh[:, 3]
    tex = sh[:, 4:7]
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    if f.has_checker:
        sines = torch.sin(10.0 * px) * torch.sin(10.0 * py) * torch.sin(10.0 * pz)
        checker = torch.where((sines < 0.0)[:, None], sh[:, 7:10], sh[:, 10:13])
        tex = torch.where((tex_kind == float(TEX_CHECKER))[:, None], checker, tex)
    if f.has_noise:
        marble = 0.5 * (1.0 + torch.sin(sh[:, 13] * pz
                                        + 10.0 * fast_turb_c(px, py, pz)))
        tex = torch.where((tex_kind == float(TEX_NOISE))[:, None],
                          marble[:, None], tex)

    sky_t = 0.5 * (d[:, 1] + 1.0)
    grad = torch.stack([(1.0 - sky_t) + sky_t * g for g in (0.15, 0.21, 0.30)],
                       dim=1)
    sky = torch.where(sky4[3] > 0.5, grad, sky4[None, :3])
    is_light = mat_kind == float(MAT_DIFFUSE_LIGHT)
    em = torch.where(hit[:, None], torch.where(is_light[:, None], tex, 0.0), sky)
    ra = ra + th * em

    u1 = counter_uniform(lane, seed, depth, 0)
    u2 = counter_uniform(lane, seed, depth, 1)
    u3 = counter_uniform(lane, seed, depth, 2)
    uc = counter_uniform(lane, seed, depth, 3)
    zz = u1 * 2.0 - 1.0
    aa = u2 * TWO_PI
    rr = _sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    uv = torch.stack([rr * torch.cos(aa), rr * torch.sin(aa), zz], dim=1)

    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    rdotn = d[:, 0] * nx + d[:, 1] * ny + d[:, 2] * nz
    refl = d - (2.0 * rdotn)[:, None] * n
    new_d = uv
    ok = torch.ones_like(hit)
    is_diel = torch.zeros_like(hit)
    if f.has_dielectric:
        exiting = rdotn > 0.0
        on = torch.where(exiting[:, None], -n, n)
        ni = torch.where(exiting, ref_idx, 1.0 / ref_idx)
        cos_in = torch.where(exiting, rdotn, -rdotn)
        ces = 1.0 - ref_idx * ref_idx * (1.0 - cos_in * cos_in)
        cosine = torch.where(exiting, _sqrt(torch.clamp(ces, min=0.0)),
                             cos_in)
        dt = d[:, 0] * on[:, 0] + d[:, 1] * on[:, 1] + d[:, 2] * on[:, 2]
        disc = 1.0 - ni * ni * (1.0 - dt * dt)
        refr_ok = disc > 0.0
        sq = _sqrt(torch.clamp(disc, min=0.0))
        refr = ni[:, None] * (d - on * dt[:, None]) - on * sq[:, None]
        r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
        r0 = r0 * r0
        omc = 1.0 - cosine
        omc2 = omc * omc
        schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
        take_refr = uc > torch.where(refr_ok, schlick, 1.0)
        is_diel = mat_kind == float(MAT_DIELECTRIC)
        new_d = torch.where(is_diel[:, None],
                            torch.where(take_refr[:, None], refr, refl), new_d)
    if f.has_metal:
        rad3 = torch.exp(torch.log(torch.clamp(u3, min=1e-30)) * (1.0 / 3.0))
        metal = refl + (fuzz * rad3)[:, None] * uv
        refl_dot_n = refl[:, 0] * nx + refl[:, 1] * ny + refl[:, 2] * nz
        is_metal = mat_kind == float(MAT_METAL)
        new_d = torch.where(is_metal[:, None], metal, new_d)
        ok = torch.where(is_metal, refl_dot_n > 0.0, ok)
    if f.has_lambertian:
        is_lam = mat_kind == float(MAT_LAMBERTIAN)
        new_d = torch.where(is_lam[:, None], n + uv, new_d)
    if f.has_light:
        ok = ok & ~is_light
    inv_len = torch.rsqrt(torch.clamp(
        new_d[:, 0] * new_d[:, 0] + new_d[:, 1] * new_d[:, 1]
        + new_d[:, 2] * new_d[:, 2], min=1e-38))
    new_d = new_d * inv_len[:, None]
    at = torch.where(is_diel[:, None], 1.0, tex)

    can = hit & ok
    c3 = can[:, None]
    noisy = (hit & (tex_kind == float(TEX_NOISE)) if f.has_noise
             else torch.zeros_like(hit))
    return (torch.where(c3, p, o), torch.where(c3, new_d, d),
            torch.where(c3, th * at, th), ra, can, hit, noisy)


def trace_megakernel_plain(tables: MegaTables, ro: torch.Tensor,
                           rd: torch.Tensor, time: torch.Tensor, seed: int,
                           max_depth: int, features: SceneFeatures,
                           work: dict | None = None):
    """Plain PyTorch version of K7, on any device: (radiance [R, 3],
    segments [] int64). Each pass runs on the live rays only, in chunks of
    ``PLAIN_CHUNK`` (its [chunk, Npad] temporaries stay bounded); a dead
    ray keeps its state and adds nothing, so the result per ray equals the
    kernel's block-wise loop.

    ``work``, if given, receives the segments that hit something and were
    shaded (``"shaded"``) and those whose winner has the noise texture
    (``"noise"``), int64 on the device: what K7's operation bound counts;
    and each ray's segments (``"ray_segments"``, [R] int64), from which a
    lane occupancy follows (``tools/nearest_bench.k7_lane_passes``)."""
    _refuse_unsupported(features)
    R = ro.shape[0]
    dev = ro.device
    o, d = ro.clone(), rd.clone()
    th = torch.ones((R, 3), dtype=torch.float32, device=dev)
    ra = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    lane = torch.arange(R, dtype=torch.int64, device=dev)
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    shaded = torch.zeros((), dtype=torch.int64, device=dev)
    noise = torch.zeros((), dtype=torch.int64, device=dev)
    per_ray = torch.zeros(R, dtype=torch.int64, device=dev)
    seed = int(seed)
    for depth in range(max_depth + 1):
        live = alive.nonzero()[:, 0]
        if live.numel() == 0:
            break
        segs += live.numel()
        per_ray[live] += 1
        for lo in range(0, live.numel(), PLAIN_CHUNK):
            sel = live[lo:lo + PLAIN_CHUNK]
            (o[sel], d[sel], th[sel], ra[sel], alive[sel], hit,
             noisy) = _bounce_plain(tables, o[sel], d[sel], time[sel], th[sel],
                                    ra[sel], lane[sel], seed, depth, features)
            shaded += hit.sum()
            noise += noisy.sum()
    if work is not None:
        work.update(shaded=shaded, noise=noise, ray_segments=per_ray)
    return ra, segs


def _check(tables: MegaTables, ro, rd, time) -> None:
    dev = ro.device
    R = ro.shape[0]
    for name, x, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           ("time", time, (R,)),
                           ("spheres", tables.spheres, None),
                           ("rects", tables.rects, (RECT_ROWS, K_PAD)),
                           ("sky4", tables.sky4, (4,))):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, ro on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sph = tables.spheres
    if sph.dim() != 2 or sph.shape[1] != K_PAD or sph.shape[0] % TILE_N:
        raise ValueError(f"spheres must be [128 k, {K_PAD}], got "
                         f"{tuple(sph.shape)}")


def trace_megakernel(tables: MegaTables, ro: torch.Tensor, rd: torch.Tensor,
                     time: torch.Tensor, seed: int, max_depth: int,
                     features: SceneFeatures, work: dict | None = None):
    """Trace a wavefront (ro, rd [R, 3] unit directions, time [R]) through
    the megakernel over a scene's tables (:func:`prep_tables`, built once
    per scene): (radiance [R, 3] f32, segments traced [] int64 on the
    device). ``seed`` keys the bounce RNG (its int32 bit pattern); ray
    ``i``'s stream is keyed on ``i``. A scene whose resident rows exceed
    ``SHARED_LIMIT`` bytes (:func:`shared_bytes`) is refused.

    CPU tensors run the plain version (``work`` as there); CUDA tensors
    launch K7 on the current stream, with no host sync (raising if it
    cannot launch), and ``work``, if given, receives its lane-passes
    (``"lane_passes"``: 32 for each pass a warp made, [] int64)."""
    global LAUNCHES, PLAIN_CALLS
    _refuse_unsupported(features)
    ro, rd = ro.contiguous(), rd.contiguous()
    time = time.to(torch.float32).contiguous()
    _check(tables, ro, rd, time)
    need = shared_bytes(tables, features)
    if need > SHARED_LIMIT:
        raise ValueError(
            f"the megakernel keeps the scene in shared memory: its "
            f"{tables.sphere_rows.shape[0]} sphere and "
            f"{tables.rect_rows.shape[0]} rect rows take {need} bytes, more "
            f"than the {SHARED_LIMIT} a block may hold")
    if ro.device.type == "cpu":
        PLAIN_CALLS += 1
        return trace_megakernel_plain(tables, ro, rd, time, seed, max_depth,
                                      features, work=work)
    if ro.device.type != "cuda":
        raise ValueError(f"trace_megakernel: unsupported device {ro.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R = ro.shape[0]
    out = torch.empty((R, 3), dtype=torch.float32, device=ro.device)
    # segments, lane-passes and the kernel's ray counter, zeroed on the
    # device
    counts = torch.zeros(3, dtype=torch.int64, device=ro.device)
    if work is not None:
        work["lane_passes"] = counts[1]
    if R == 0:
        return out, counts[0]
    rects = features.has_rects
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    code = lib.pt_megakernel(
        ro.data_ptr(), rd.data_ptr(), time.data_ptr(), R,
        tables.spheres.data_ptr(), tables.sphere_rows.data_ptr(),
        tables.n_static, tables.sphere_rows.shape[0] - tables.n_static,
        tables.rects.data_ptr() if rects else None,
        tables.rect_rows.data_ptr() if rects else None,
        tables.rect_rows.shape[0] if rects else 0,
        tables.sky4.data_ptr(), _int32(seed), int(max_depth),
        feature_flags(features), float(MIN_T), out.data_ptr(),
        counts.data_ptr(), stream,
    )
    _cuda_build.check(code, "megakernel launch")
    LAUNCHES += 1
    return out, counts[0]
