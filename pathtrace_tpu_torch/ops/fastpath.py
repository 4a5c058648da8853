"""Fast render path: closest-hit kernel + fused shade/scatter kernel +
host-driven stream compaction.

Counterpart of ``pathtrace_tpu/ops/fastpath.py`` (fused flavour: static
or moving spheres, rects, transformed boxes and constant-density media;
image textures on spheres and rects).
One bounce is two kernels:

* :func:`~pathtrace_tpu_torch.ops.intersect_kernel.sphere_nearest` — the
  closest hit over every sphere, giving (t, idx) per ray; scenes of at
  least ``CULL_MIN_TILES`` sphere tiles take
  :func:`~pathtrace_tpu_torch.ops.intersect_kernel.sphere_nearest_culled`
  instead (the flat cull K4, or the two-level cull K5 for scenes of two
  supertiles or more), which gives the same (t, idx) bit for bit; scenes
  with moving spheres take
  :func:`~pathtrace_tpu_torch.ops.intersect_kernel.sphere_nearest_moving`
  (K3, centres lerped to each ray's time), never culled;
  a scene without spheres skips the sweep (t = MAX_T, idx 0), as the
  reference does; the rects, boxes and media of the scene are swept
  after it in plain PyTorch (:mod:`~pathtrace_tpu_torch.ops.intersect_rect`,
  :mod:`~pathtrace_tpu_torch.ops.intersect_box`; the media with the
  free-flight draws ``8 + j``), each kind winning only when strictly
  nearer;
* :func:`~pathtrace_tpu_torch.ops.shade_kernel.shade_from_winners` — reads
  each lane's winner row of the attribute table (spheres, then the rect,
  box and medium blocks) itself and runs texture, emission, sky and
  scatter in one pass (the sphere normal from the time-lerped centre when
  the scene moves; a rect's axis normal; a box's face normal from the
  slab test redone in object space; (1, 0, 0) in a medium, whose
  isotropic material scatters into the unit-sphere direction; an image
  texture's texel read from the atlas at the winner's UV).

With next-event estimation (``nee_lights``) a plain-PyTorch tail follows
K2 each bounce: one light sample per Lambertian or isotropic lane, a
shadow ray through the closest hit (K1 or K3, the rects, boxes and media;
the shadow media draw ``8 + n_media + j``), the power-heuristic split of
the light and BSDF strategies, and the MIS weight of the next vertex's
emission, which K2 applies there (the 13th state plane). With Russian
roulette (``rr_start``) a tail from that depth on ends lanes of low
throughput and boosts the survivors.

Between bounces the host ladder reads lagged alive counts and compacts the
wavefront. Each count readback is a stream sync on CUDA; the ladder counts
them. Frames of culled scenes trace in 64x64 pixel-tile order, so that a
warp's rays form a narrow frustum the culls can prune.

The differentiable trace (:func:`trace_fast_diff`, the training path) runs
every bounce at full width with no compaction, on every scene class the
reference's differentiable path takes (:func:`diff_refusal`): the closest
hit goes
through :class:`~pathtrace_tpu_torch.ops.intersect_kernel.SphereNearest`
(K1 or, for moving spheres, K3 forward; K6 backward) and one row gather, and the shading is
plain PyTorch under autograd, as the reference shades its diff path in
XLA.

Attribute row layout (24 columns, 28 in image scenes, 48 in scenes with
boxes or media, as in the JAX package):
  cols 0-13   shading: mat_kind, fuzz, ref_idx, tex_kind, col_rgb,
              odd_rgb, even_rgb, noise_scale
  col  14     kind (0: sphere, 1: rect, 2: box, 3: medium)
  cols 15-23  sphere: cx cy cz dx dy dz time0 inv_dt radius
              rect: axis a0 a1 b0 b1 k flip, then zeros
  cols 15-41  box: p0 xyz, p1 xyz, obj_from_world (3x4 row-major),
              world_from_obj's linear part (3x3 row-major)
  cols 15-34  medium: p0 xyz, p1 xyz, obj_from_world, density, radius
  last 3     (28 and 48 columns) the atlas entry of the row's texture:
             y-offset, height, width (image 0's on rows of other textures)

The bounce RNG is the stateless counter hash of the JAX package, keyed on
(lane, seed, depth, draw) and reproduced bit for bit. torch on the CPU has
no uint32 ``+`` or ``>>``, so the hash computes in int64 and masks to 32
bits; products by a 32-bit constant are split in 16-bit halves so no
int64 product overflows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import (
    Boxes,
    Media,
    Rects,
    Scene,
    SceneFeatures,
)
from pathtrace_tpu_torch.models.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
)
from pathtrace_tpu_torch.ops.intersect_kernel import (
    TILE_N,
    CullBoxes,
    SphereNearest,
    cull_boxes,
    cull_mode,
    cull_slots,
    sphere_nearest,
    sphere_nearest_culled,
    sphere_nearest_moving,
)
from pathtrace_tpu_torch.ops.intersect_box import box_nearest, media_nearest
from pathtrace_tpu_torch.ops.intersect_rect import (
    RECT_ROWS,
    merge_rects,
    merge_winner,
    rect_nearest,
)
from pathtrace_tpu_torch.ops.lights import (
    LightTable,
    light_dir_pdf_planes,
    sample_light_dirs_planes,
)
from pathtrace_tpu_torch.ops.shade_kernel import (
    ALBEDO,
    ESC,
    FLAG_BOX,
    FLAG_CHECKER,
    FLAG_DIELECTRIC,
    FLAG_EMIT_SCALE,
    FLAG_IMAGE,
    FLAG_LAMBERTIAN,
    FLAG_LIGHT,
    FLAG_MEDIUM,
    FLAG_METAL,
    FLAG_MOTION,
    FLAG_NOISE,
    FLAG_RECT,
    KIND_BOX,
    KIND_MEDIUM,
    KIND_RECT,
    NORMAL,
    TWO_PI,
    _trunc_clamp,
    box_frame,
    shade_from_winners,
)
from pathtrace_tpu_torch.render import compact_util

GEO = 15       # first geometry column of an attribute row
K_ATTR = 24
K_ATTR_AFFINE = 48  # rows of scenes with boxes or media
K_ATTR_IMG = 28     # rows this wide carry the image atlas entry at the end
_INV_PI = 1.0 / 3.14159265358979

_M32 = 0xFFFFFFFF
_INF = float(MAX_T)


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
    """24 columns; 48 in scenes with boxes or media, whose rows carry
    affine transforms; 28 in other image scenes, whose rows end in their
    texture's atlas entry (the 48-column rows end in it too)."""
    if features.has_boxes or features.has_media:
        return K_ATTR_AFFINE
    return K_ATTR_IMG if features.has_image else K_ATTR


def diff_refusal(features: SceneFeatures, scene: Scene) -> Optional[str]:
    """Why the differentiable fast path cannot take ``scene`` (None when
    it can): the reference's ``fastpath_supported`` (``fastpath.py:98``),
    the only gate of its ``trace_fast_diff``: more than ``RECT_ROWS``
    rects, instanced spheres or rects, or checker textures with
    non-constant children."""
    if scene.rects.count > RECT_ROWS:
        return (f"scene has {scene.rects.count} rects; the fast path takes "
                f"at most {RECT_ROWS}")
    for kind in ("spheres", "rects"):
        if getattr(scene, kind).instanced:
            return (f"scene has instanced {kind}: the fast path takes "
                    "world-space primitives (the general integrator renders "
                    "instances)")
    if features.has_checker and not features.checker_children_const:
        return ("scene needs checker textures with non-constant children: "
                "not ported yet")
    return None


def fastpath_refusal(features: SceneFeatures, scene: Scene) -> Optional[str]:
    """Why the fast path cannot render ``scene`` (None when it can): the
    reference's own fallbacks to the general integrator
    (:func:`diff_refusal`), or image textures in a scene with boxes or
    media, which the reference shades outside its fused kernel (the
    differentiable bounce, which has the box UV, takes them)."""
    why = diff_refusal(features, scene)
    if why is None and features.has_image and (features.has_boxes
                                                or features.has_media):
        why = ("scene needs image textures in a scene with boxes or media: "
               "the reference shades such scenes outside the fused kernel "
               "(fused_shade_supported: the non-fused bounce with box "
               "normals and box UV), which is not ported yet")
    return why


def fastpath_supported(features: SceneFeatures, scene: Scene) -> bool:
    """True for the scene classes the fast path renders: static or moving
    world-space spheres, world-space rects (at most ``RECT_ROWS``),
    transformed boxes and constant-density media with Lambertian, metal,
    dielectric, emissive or isotropic materials and constant, checker
    (constant children), noise or, in scenes without boxes or media, image
    textures. Raises ``ValueError`` naming what is missing for anything
    else (:func:`fastpath_refusal`); ``mode="auto"`` renders such scenes
    through the general integrator."""
    why = fastpath_refusal(features, scene)
    if why is not None:
        raise ValueError(why)
    return True


def feature_flags(features: SceneFeatures) -> int:
    """Runtime bitmask of the shade branches a scene needs."""
    flags = 0
    for on, bit in ((features.has_checker, FLAG_CHECKER),
                    (features.has_noise, FLAG_NOISE),
                    (features.has_lambertian, FLAG_LAMBERTIAN),
                    (features.has_metal, FLAG_METAL),
                    (features.has_dielectric, FLAG_DIELECTRIC),
                    (features.has_light, FLAG_LIGHT),
                    (features.has_motion, FLAG_MOTION),
                    (features.has_rects, FLAG_RECT),
                    (features.has_boxes, FLAG_BOX),
                    (features.has_media, FLAG_MEDIUM),
                    (features.has_image, FLAG_IMAGE)):
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


def _img_cols(scene: Scene, mat_id: torch.Tensor, k_attr: int):
    """The atlas entry (y-offset, height, width) of each primitive's
    texture, the last three columns of rows of 28 columns or more (None
    for narrower rows): image 0's for textures that are not images, as in
    the reference."""
    if k_attr < K_ATTR_IMG:
        return None
    tid = scene.materials.tex_id[mat_id.long()].long()
    img_id = scene.textures.image_id[tid].long()
    at = scene.atlas
    return [at.y_offset[img_id].to(torch.float32),
            at.height[img_id].to(torch.float32),
            at.width[img_id].to(torch.float32)]


def _finish_table(cols, mask, dead_col: int, n_pad: int, k_attr: int,
                  img_cols=None):
    """Stack the columns into rows; dead and padding rows are zero with
    1e18 in ``dead_col``. Out of place, so gradients reach the leaves.
    ``img_cols`` (:func:`_img_cols`, for rows of 28 columns or more) end
    each row, as in the reference."""
    if img_cols is not None:
        fill = cols[0].new_zeros(cols[0].shape)
        cols = cols + [fill] * (k_attr - 3 - len(cols)) + img_cols
    table = torch.stack(cols, dim=1)
    is_dead_col = torch.arange(table.shape[1], device=table.device) == dead_col
    dead_row = torch.where(is_dead_col, 1.0e18, 0.0).to(table.dtype)
    table = torch.where(mask[:, None], table, dead_row)
    rows = table.shape[0]
    if n_pad > rows:
        table = torch.cat([table, dead_row.expand(n_pad - rows, -1)], dim=0)
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
    return _finish_table(cols, sp.mask, GEO, n_pad, k_attr,
                         _img_cols(scene, sp.mat_id, k_attr))


def build_rect_table(scene: Scene, k_attr: int) -> torch.Tensor:
    """[128, k_attr] rect rows: the shading columns, kind 1, then axis, a0,
    a1, b0, b1, k, flip. Dead and padding rows get k = 1e18 and the empty
    interval a0 = 1 > a1 = -1, so they never win."""
    rc = scene.rects
    cols = _shade_cols(scene, rc.mat_id) + [
        torch.ones_like(rc.k),                           # kind = 1 (rect)
        rc.axis.to(torch.float32), rc.a0, rc.a1, rc.b0, rc.b1, rc.k, rc.flip,
    ]
    table = _finish_table(cols, rc.mask, GEO + 5, RECT_ROWS, k_attr,
                          _img_cols(scene, rc.mat_id, k_attr))
    dead = torch.cat([~rc.mask, rc.mask.new_ones(RECT_ROWS - rc.count)])
    k = torch.arange(table.shape[1], device=table.device)
    interval = (k == GEO + 1) | (k == GEO + 2)
    return torch.where(dead[:, None] & interval,
                       torch.where(k == GEO + 1, 1.0, -1.0).to(table.dtype),
                       table)


def _affine_cols(m: torch.Tensor, linear_only: bool = False):
    """The columns of [N, 3, 4] affines, row-major (the 3x3 linear part
    only when ``linear_only``)."""
    m = m[:, :, :3] if linear_only else m
    flat = m.reshape(m.shape[0], -1)
    return [flat[:, i] for i in range(flat.shape[1])]


def _slab_cols(scene: Scene, prims, kind: float):
    """The columns boxes and media share: shading, ``kind``, p0 and p1 at
    GEO, obj_from_world (3x4 row-major) at GEO + 6."""
    return _shade_cols(scene, prims.mat_id) + [
        torch.full_like(prims.mask, kind, dtype=torch.float32),
        *prims.p0.unbind(1), *prims.p1.unbind(1),
    ] + _affine_cols(prims.obj_from_world)


def build_box_table(scene: Scene, k_attr: int) -> torch.Tensor:
    """[N, k_attr] box rows: :func:`_slab_cols` with kind 2, then
    world_from_obj's linear part (3x3 row-major) at GEO + 18. Dead rows
    are zero with p0x = 1e18."""
    bx = scene.boxes
    cols = (_slab_cols(scene, bx, KIND_BOX)
            + _affine_cols(bx.world_from_obj, linear_only=True))
    return _finish_table(cols, bx.mask, GEO, bx.count, k_attr,
                         _img_cols(scene, bx.mat_id, k_attr))


def build_media_table(scene: Scene, k_attr: int) -> torch.Tensor:
    """[N, k_attr] medium rows: :func:`_slab_cols` with kind 3 (the
    scatter needs no normal), then the density at GEO + 18 and the sphere
    boundary's radius at GEO + 19."""
    md = scene.media
    cols = _slab_cols(scene, md, KIND_MEDIUM) + [md.density, md.radius]
    return _finish_table(cols, md.mask, GEO, md.count, k_attr,
                         _img_cols(scene, md.mat_id, k_attr))


def build_sphere_soa(scene: Scene, n_pad: Optional[int] = None,
                     motion: bool = False) -> torch.Tensor:
    """[5, Npad] closest-hit operand: cx, cy, cz, |c|^2 - r^2, mask, with
    ``n_pad`` slots (default: the spheres padded to whole tiles of 128).
    ``motion``: the [12, Npad] operand of K3, which adds dx, dy, dz,
    time0, inv_dt, c.delta and |delta|^2 (both dot products summed
    x, y, z in that order). Padding spheres sit at centre 1e18 with
    c-term 1e30, every other row 0. No gradient flows through it (see
    ``SphereNearest``)."""
    sp = scene.spheres
    n = sp.count
    if n_pad is None:
        n_pad = ((n + TILE_N - 1) // TILE_N) * TILE_N
    c = sp.center.detach()
    radius = sp.radius.detach()
    cc_m_r2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
               - radius * radius)
    rows = [c[:, 0], c[:, 1], c[:, 2], cc_m_r2, sp.mask.to(torch.float32)]
    if motion:
        d = sp.center_delta.detach()
        rows += [d[:, 0], d[:, 1], d[:, 2], sp.time0.detach(),
                 sp.inv_time_delta.detach(),
                 c[:, 0] * d[:, 0] + c[:, 1] * d[:, 1] + c[:, 2] * d[:, 2],
                 d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]]
    soa = torch.stack(rows)
    if n_pad > n:
        pad = soa.new_zeros((len(rows), n_pad - n))
        pad[:3] = 1.0e18
        pad[3] = 1.0e30
        soa = torch.cat([soa, pad], dim=1)
    return soa.contiguous()


class TableRows(NamedTuple):
    """First row of each kind's block in the winner table (a kind the
    scene lacks has no block, and its entry is the next block's row)."""

    rect: int
    box: int
    media: int


class FastTables(NamedTuple):
    table: torch.Tensor   # [rows, 24, 28 or 48] winner rows (see TableRows)
    soa: torch.Tensor     # [5, Nslots] closest-hit operand ([12, Npad]: K3)
    sky4: torch.Tensor    # [4] sky rgb + use_gradient_sky
    rows: TableRows       # where the rect, box and medium blocks start
    cull: Optional[CullBoxes] = None  # the culls' boxes (None: K1)
    rects: Optional[Rects] = None     # the rect sweep's rects (rect scenes)
    boxes: Optional[Boxes] = None     # the box sweep's boxes (box scenes)
    media: Optional[Media] = None     # the media sweep's media (media scenes)
    lights: Optional[LightTable] = None  # NEE's light table (host)
    light_rgb: Optional[torch.Tensor] = None  # [3, L] light emission
    atlas: Optional[torch.Tensor] = None  # [H, W, 3] image atlas (images)


def table_rows(scene: Scene, features: SceneFeatures) -> TableRows:
    """The blocks of :func:`winner_table`: the sphere rows (whole tiles of
    128), then the ``RECT_ROWS`` rect block in rect scenes, one row per
    box in box scenes, one per medium in media scenes."""
    rect = sphere_tiles(scene) * TILE_N
    box = rect + (RECT_ROWS if features.has_rects else 0)
    media = box + (scene.boxes.count if features.has_boxes else 0)
    return TableRows(rect, box, media)


def winner_table(scene: Scene, features: SceneFeatures) -> torch.Tensor:
    """The rows K2 and the differentiable bounce read winners from, in the
    blocks of :func:`table_rows` (the reference's order): rect ``i`` is
    row ``rows.rect + i``, box ``i`` row ``rows.box + i``, medium ``i``
    row ``rows.media + i``."""
    k_attr = attr_width(features)
    parts = [build_sphere_table(scene, k_attr)]
    if features.has_rects:
        parts.append(build_rect_table(scene, k_attr))
    if features.has_boxes:
        parts.append(build_box_table(scene, k_attr))
    if features.has_media:
        parts.append(build_media_table(scene, k_attr))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def sphere_tiles(scene: Scene) -> int:
    """Tiles of 128 sphere slots the scene spans."""
    return (scene.spheres.count + TILE_N - 1) // TILE_N


def cull_scene(scene: Scene, features: SceneFeatures) -> bool:
    """Static sphere scenes of at least ``CULL_MIN_TILES`` tiles take the
    culled closest hit and tile-order frames (the reference's rule,
    ``fastpath.py:1993-1998``; the port has no BVH)."""
    return (features.has_spheres and not features.has_motion
            and sphere_tiles(scene) >= CULL_MIN_TILES)


def prep_tables(scene: Scene, features: SceneFeatures,
                cull: bool = False,
                lights: Optional[LightTable] = None) -> FastTables:
    """Per-trace tables, on the scene's device. ``cull``: build the boxes
    of the cull :func:`cull_mode` picks, and pad the closest-hit operand
    to its tiles (and supertiles). Rect, box and media scenes get their
    blocks after the sphere rows, image scenes the atlas K2 reads texels
    from, whose entries must lie inside its data (K2's clamps keep each
    read inside its entry). ``lights``: the light table of next-event
    estimation, whose lights must all have constant textures."""
    sky4 = torch.cat([scene.sky.to(torch.float32).reshape(3),
                      scene.use_gradient_sky.to(torch.float32).reshape(1)])
    boxes, n_slots = None, None
    if cull:
        sp = scene.spheres
        hier, s_tiles = cull_mode(sphere_tiles(scene))
        n_slots = cull_slots(sp.count, hier, s_tiles)
        boxes = cull_boxes(sp.center, sp.radius, sp.mask, n_slots, hier,
                           s_tiles)
    table = winner_table(scene, features)
    atlas = None
    if features.has_image:
        _check_atlas(scene)
        atlas = scene.atlas.data.contiguous()
    light_rgb = None
    if lights is not None:
        if lights.color is None:
            raise ValueError("lights whose texture is not a constant: not "
                             "ported yet")
        light_rgb = torch.from_numpy(lights.color.T.copy()).to(sky4.device)
    return FastTables(
        table=table.contiguous(),
        soa=build_sphere_soa(scene, n_slots, motion=features.has_motion),
        sky4=sky4.contiguous(),
        rows=table_rows(scene, features),
        cull=boxes,
        rects=scene.rects if features.has_rects else None,
        boxes=scene.boxes if features.has_boxes else None,
        media=scene.media if features.has_media else None,
        lights=lights,
        light_rgb=light_rgb,
        atlas=atlas,
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
    (ro xyz, rd xyz, radiance rgb, throughput rgb), and with next-event
    estimation a 13th, the MIS weight of the lane's next emission hit
    (row ``ESC``), as one [12 or 13, R] tensor, so a compaction moves them
    with one gather and the closest-hit kernel reads ``planes[:6]`` in
    place."""

    planes: torch.Tensor  # [12, R] f32 ([13, R] with NEE)
    time: torch.Tensor    # [R] f32
    alive: torch.Tensor   # [R] bool
    lane: torch.Tensor    # [R] int32, uint32 bit pattern of the RNG stream id

    @property
    def size(self) -> int:
        return self.alive.shape[0]


def make_state(ro: torch.Tensor, rd: torch.Tensor, time: torch.Tensor,
               nee: bool = False) -> FastStateP:
    """The state of a new wavefront; ``nee`` adds the MIS plane, at 1."""
    R = ro.shape[0]
    dev = ro.device
    planes = torch.empty((13 if nee else 12, R), dtype=torch.float32,
                         device=dev)
    planes[RO] = ro.T
    planes[RD] = rd.T
    planes[RAD] = 0.0
    planes[THR] = 1.0
    if nee:
        planes[ESC] = 1.0
    return FastStateP(
        planes=planes,
        time=time.to(torch.float32).contiguous(),
        alive=torch.ones(R, dtype=torch.bool, device=dev),
        lane=torch.arange(R, dtype=torch.int32, device=dev),
    )


def _no_hit(rays: torch.Tensor):
    """(t, idx) of a scene without spheres: MAX_T and 0 on every ray."""
    R = rays.shape[1]
    return (torch.full((R,), _INF, dtype=rays.dtype, device=rays.device),
            torch.zeros((R,), dtype=torch.int32, device=rays.device))


def media_uniforms(lane: torch.Tensor, seed: int, depth: int, n_media: int,
                   first_draw: int):
    """The media sweep's free-flight uniforms: draw ``first_draw + j`` for
    medium ``j`` (8 + j for the bounce's rays, 8 + n_media + j for the
    shadow rays, as in the reference)."""
    return [counter_uniform(lane, seed, depth, first_draw + j)
            for j in range(n_media)]


def nearest_t_only(tables: FastTables, rays: torch.Tensor,
                   time: torch.Tensor, features: SceneFeatures,
                   med_u=None) -> torch.Tensor:
    """Closest-hit distance only, over the spheres (K1 brute force, or K3
    for moving spheres), the rects, boxes and media, of ``rays`` [6, R]:
    the shadow rays' occlusion test (the reference's ``nearest_t_only``,
    ``fastpath.py:356``). ``med_u``: the media's uniforms (media scenes)."""
    if not features.has_spheres:
        t, _ = _no_hit(rays)
    elif features.has_motion:
        t, _ = sphere_nearest_moving(tables.soa, rays, time, MIN_T, MAX_T)
    else:
        t, _ = sphere_nearest(tables.soa, rays, MIN_T, MAX_T)
    if tables.rects is not None:
        t = torch.minimum(t, rect_nearest(tables.rects, *rays)[0])
    if tables.boxes is not None:
        t = torch.minimum(t, box_nearest(tables.boxes, *rays)[0])
    if tables.media is not None:
        t = torch.minimum(t, media_nearest(tables.media, *rays, med_u)[0])
    return t


class ShadowRays(NamedTuple):
    rays: torch.Tensor    # [6, R] hit point xyz (0 off NEE), light dir xyz
    dist: torch.Tensor    # [R] distance to the sampled light point
    pdf: torch.Tensor     # [R] the sample's solid-angle density
    light: torch.Tensor   # [R] int32 index of the sampled light
    mask: torch.Tensor    # [R] bool: the lanes that take NEE
    is_lam: torch.Tensor  # [R] bool: Lambertian winners


def shadow_rays(tables: FastTables, idx: torch.Tensor, planes: torch.Tensor,
                alive: torch.Tensor, lane: torch.Tensor, seed: int,
                depth: int) -> ShadowRays:
    """NEE's light samples after the shade kernel: each live Lambertian or
    isotropic lane samples one light (draws 4-6) from its hit point,
    which K2 left in the ro rows of ``planes``. Lanes off NEE start at the
    origin and are swept all the same, as in the reference."""
    mat_kind = tables.table[:, 0].index_select(0, idx.long())
    is_lam = mat_kind == float(MAT_LAMBERTIAN)
    mask = alive & (is_lam | (mat_kind == float(MAT_ISOTROPIC)))
    lu0, lu1, lu2 = (counter_uniform(lane, seed, depth, k) for k in (4, 5, 6))
    zero = torch.zeros_like(planes[0])
    spx, spy, spz = (torch.where(mask, planes[k], zero) for k in range(3))
    wix, wiy, wiz, ldist, lpdf, lidx, lvalid = sample_light_dirs_planes(
        tables.lights, spx, spy, spz, lu0, lu1, lu2)
    return ShadowRays(torch.stack([spx, spy, spz, wix, wiy, wiz]), ldist,
                      lpdf, lidx, mask & lvalid, is_lam)


def nee_tail(tables: FastTables, t: torch.Tensor, idx: torch.Tensor,
             state_in: FastStateP, planes: torch.Tensor, alive: torch.Tensor,
             seed: int, depth: int, features: SceneFeatures) -> torch.Tensor:
    """Next-event estimation with MIS after the shade kernel (the
    reference's ``_fused_nee_tail``, ``fastpath.py:1294``). ``planes`` is
    K2's [19, R] output under ``FLAG_EMIT_SCALE`` and ``alive`` its new
    alive mask; K2 has scaled this bounce's emission by the lane's MIS
    weight. The lanes of :func:`shadow_rays` trace their shadow ray; an
    unoccluded sample adds its light-strategy share to the radiance
    planes, and row ``ESC`` gets the BSDF strategy's share for the
    direction K2 scattered into. An isotropic lane's BSDF density is
    1 / (4 pi). In place; returns the shadow rays traced (a device
    int64)."""
    lights = tables.lights
    sh = shadow_rays(tables, idx, planes, alive, state_in.lane, seed, depth)
    spx, spy, spz, wix, wiy, wiz = sh.rays
    ldist, lpdf, nee_mask, is_lam = sh.dist, sh.pdf, sh.mask, sh.is_lam
    zero = torch.zeros_like(t)
    med_u = None
    if tables.media is not None:
        n_media = tables.media.count
        med_u = media_uniforms(state_in.lane, seed, depth, n_media,
                               8 + n_media)
    s_t = nearest_t_only(tables, sh.rays, state_in.time, features, med_u)
    unoccluded = ~((s_t < _INF) & (s_t < ldist * (1.0 - 1e-3)))
    le = tables.light_rgb.index_select(1, sh.light.long())
    snx, sny, snz = (torch.where(nee_mask, n, zero) for n in planes[NORMAL])
    cos_s = torch.clamp(wix * snx + wiy * sny + wiz * snz, min=0.0)
    pdf_f = torch.where(is_lam, cos_s * _INV_PI, 0.25 * _INV_PI)
    w_light = lpdf * lpdf / torch.clamp(lpdf * lpdf + pdf_f * pdf_f, min=1e-20)
    scale = torch.where(nee_mask & unoccluded,
                        pdf_f * w_light / torch.clamp(lpdf, min=1e-12), 0.0)
    albedo = planes[ALBEDO]
    for c in range(3):
        planes[6 + c] = (planes[6 + c]
                         + state_in.planes[9 + c] * albedo[c] * le[c] * scale)
    # the BSDF side of the split: K2's scattered direction is in the rd rows
    rdx, rdy, rdz = planes[3], planes[4], planes[5]
    cos_b = torch.clamp(rdx * snx + rdy * sny + rdz * snz, min=0.0)
    p_b = torch.where(is_lam, cos_b * _INV_PI, 0.25 * _INV_PI)
    p_l = light_dir_pdf_planes(lights, spx, spy, spz, rdx, rdy, rdz)
    w_bsdf = p_b * p_b / torch.clamp(p_b * p_b + p_l * p_l, min=1e-20)
    planes[ESC] = torch.where(nee_mask & (p_l > 0.0), w_bsdf, 1.0)
    return nee_mask.sum()


def rr_tail(planes: torch.Tensor, alive: torch.Tensor, lane: torch.Tensor,
            seed: int, depth: int, rr_start: int) -> torch.Tensor:
    """Russian roulette after the shade kernel (the reference's
    ``_fused_rr_tail``, ``fastpath.py:1399``): from depth ``rr_start`` on
    a live lane survives with p = clip(max throughput, 0.05, 1) (draw 7)
    and its throughput is divided by p. Scales ``planes``' throughput rows
    in place; returns the new alive mask."""
    if depth < rr_start:
        return alive
    thr = planes[THR]
    p_rr = torch.clamp(torch.maximum(torch.maximum(thr[0], thr[1]), thr[2]),
                       0.05, 1.0)
    survive = ~alive | (counter_uniform(lane, seed, depth, 7) < p_rr)
    planes[THR] = thr * torch.where(alive & survive, 1.0 / p_rr, 1.0)
    return alive & survive


def closest_hit(tables: FastTables, state: FastStateP, depth: int,
                features: SceneFeatures, seed: Optional[int] = None):
    """The winners (t [R], idx [R] int32, a row of ``tables.table``) of a
    state's rays: K3 for moving spheres, the cull when the tables carry
    cull boxes, else K1 (no sweep in a scene without spheres); then the
    rect, box and media sweeps in that order, each kind's winner taking
    its row when strictly nearer (the earlier kinds keep ties). The media
    sweep draws its free flights from the bounce's ``seed`` (draws
    ``8 + j``), which media scenes must pass."""
    if not features.has_spheres:
        t, idx = _no_hit(state.planes)
    elif features.has_motion:
        t, idx = sphere_nearest_moving(tables.soa, state.planes[:6],
                                       state.time, MIN_T, MAX_T)
    elif tables.cull is not None and (depth == 0 or CULL_ALL_DEPTHS):
        t, idx, _ = sphere_nearest_culled(tables.soa, state.planes[:6],
                                          tables.cull, MIN_T, MAX_T)
    else:
        t, idx = sphere_nearest(tables.soa, state.planes[:6], MIN_T, MAX_T)
    rays = state.planes[:6]
    if tables.rects is not None:
        t, idx = merge_rects(tables.rects, rays, t, idx, tables.rows.rect)
    if tables.boxes is not None:
        t, idx = merge_winner(t, idx, *box_nearest(tables.boxes, *rays),
                              tables.rows.box)
    if tables.media is not None:
        if seed is None:
            raise ValueError("closest_hit: a media scene needs the bounce "
                             "seed (the free-flight draws)")
        med_u = media_uniforms(state.lane, seed, depth, tables.media.count, 8)
        t, idx = merge_winner(
            t, idx, *media_nearest(tables.media, *rays, med_u),
            tables.rows.media)
    return t, idx


def fast_bounce_fused(tables: FastTables, state: FastStateP, seed: int,
                      depth: int, max_depth: int, features: SceneFeatures,
                      rr_start: int = 0):
    """One bounce: :func:`closest_hit`, then the fused shade/scatter pass,
    then the NEE tail when the tables carry lights and the roulette tail
    when ``rr_start`` > 0. Returns (state, shadow rays traced: a device
    int64, or 0 without NEE)."""
    t, idx = closest_hit(tables, state, depth, features, seed)
    nee = tables.lights is not None
    flags = feature_flags(features) | (FLAG_EMIT_SCALE if nee else 0)
    planes, alive = shade_from_winners(
        tables.table, idx, t, state.planes, state.time, state.alive,
        state.lane, seed, depth, max_depth, tables.sky4, flags,
        atlas=tables.atlas,
    )
    shadow = 0
    if nee:
        shadow = nee_tail(tables, t, idx, state, planes, alive, seed, depth,
                          features)
        planes = planes[:ESC + 1]
    if rr_start > 0:
        alive = rr_tail(planes, alive, state.lane, seed, depth, rr_start)
    return FastStateP(planes=planes, time=state.time, alive=alive,
                      lane=state.lane), shadow


def _bounce_group_fused(tables, state, seed, depth0, max_depth, features,
                        group, segs, rr_start=0):
    """``group`` bounces; ``segs`` (device int64) gains sum(alive) before
    each bounce (every live lane traces one segment) and the shadow rays
    of the NEE tail."""
    for g in range(group):
        segs = segs + state.alive.sum()
        state, shadow = fast_bounce_fused(tables, state, seed, depth0 + g,
                                          max_depth, features, rr_start)
        segs = segs + shadow
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
# Static sphere scenes spanning at least this many 128-sphere tiles take
# the culled closest hit and tile-order frames. Patchable.
CULL_MIN_TILES = 8
# Cull every bounce of such scenes, not only depth 0: tile-order frames
# keep later bounces' warps pixel-coherent enough to skip tiles. Patchable.
CULL_ALL_DEPTHS = True


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
               compaction: bool = True,
               nee_lights: Optional[LightTable] = None,
               rr_start: int = 0) -> TraceResult:
    """Trace a wavefront of rays (ro, rd: [R, 3] unit directions; time
    [R]) on the scene's device. ``seed`` keys the bounce RNG (its int32
    bit pattern); lane id ``i`` keys ray i's stream, so compaction never
    changes a ray's result. ``nee_lights`` (the scene's
    :func:`~pathtrace_tpu_torch.ops.lights.build_light_table`) turns on
    next-event estimation with MIS, whose shadow rays the segment count
    includes; ``rr_start`` > 0 Russian roulette from that depth."""
    fastpath_supported(features, scene)
    tables = prep_tables(scene, features, cull=cull_scene(scene, features),
                         lights=nee_lights)
    seed = int(seed)

    def step(state, depth, g, segs):
        return _bounce_group_fused(tables, state, seed, depth, max_depth,
                                   features, g, segs, rr_start)

    state = make_state(ro, rd, time, nee=nee_lights is not None)
    out_radiance, segs, readbacks = _host_ladder(
        step, state, max_depth, max(min_size, 128), compaction)
    return TraceResult(out_radiance.T.contiguous(), segs, readbacks)


class FrameResult(NamedTuple):
    image: torch.Tensor      # [H, W, 3] f32 linear
    ray_count: torch.Tensor  # [] int64 on the device
    readbacks: int


@functools.lru_cache(maxsize=16)
def _tile_perm_np(height: int, width: int, tile: int = 64):
    """Pixel permutation into ``tile x tile`` screen tiles, and its
    inverse (the reference's ``_tile_perm_np``, ``fastpath.py:1769``).
    In raster order a warp's rays span a sliver of a scanline and a block
    of them the image's width; in tile order they form a compact pixel
    tile, whose narrow frustum is what the culls prune against."""
    i = np.arange(height * width, dtype=np.int64)
    x = i % width
    y = i // width
    tiles_x = (width + tile - 1) // tile
    key = (((y // tile) * tiles_x + (x // tile)) << 20) \
        + (y % tile) * tile + (x % tile)
    order = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size, dtype=np.int32)
    return order, inv


@functools.lru_cache(maxsize=16)
def _tile_perm(height: int, width: int, device: torch.device):
    """:func:`_tile_perm_np` as int64 index tensors on ``device``, kept
    for the frames that follow."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.int64)
                 for a in _tile_perm_np(height, width))


def tile_layout(scene: Scene, features: SceneFeatures, height: int,
                width: int) -> bool:
    """Frames of culled scenes trace in tile order (the reference's rule,
    ``fastpath.py:1866-1869``), when the film holds a whole tile."""
    return cull_scene(scene, features) and height >= 64 and width >= 64


def permute_rays(ro: torch.Tensor, rd: torch.Tensor, t: torch.Tensor,
                 order: torch.Tensor, samples: int):
    """Permute the pixel axis of a [H*W*S]-flat ray set by ``order`` with
    one packed [hw, 7S] row gather (``_permute_rays_jit``)."""
    S = samples
    hw = order.shape[0]
    pack = torch.cat([ro.reshape(hw, 3 * S), rd.reshape(hw, 3 * S),
                      t.reshape(hw, S)], dim=1).index_select(0, order)
    R = hw * S
    return (pack[:, :3 * S].reshape(R, 3), pack[:, 3 * S:6 * S].reshape(R, 3),
            pack[:, 6 * S:].reshape(R))


def unpermute_image(radiance: torch.Tensor, inv: torch.Tensor, height: int,
                    width: int, samples: int) -> torch.Tensor:
    """Tile-ordered radiance [H*W*S, 3] -> the [H, W, 3] sample mean
    (``_unpermute_image_jit``)."""
    rows = radiance.reshape(height * width, 3 * samples).index_select(0, inv)
    return rows.reshape(height, width, samples, 3).mean(dim=2)


def trace_frame(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                t: torch.Tensor, width: int, height: int, samples: int,
                max_depth: int, seed: int, features: SceneFeatures,
                nee_lights: Optional[LightTable] = None,
                rr_start: int = 0) -> FrameResult:
    """A frame's rays (ro, rd [H*W*S, 3], t [H*W*S], in [H, W, S] order)
    to its image: permuted into tile order when :func:`tile_layout` says
    so, traced, un-permuted and averaged over the samples. Lane ids key
    the bounce RNG, so tile order renames lanes and renders the same
    estimator."""
    tiled = tile_layout(scene, features, height, width)
    if tiled:
        order, inv = _tile_perm(height, width, ro.device)
        ro, rd, t = permute_rays(ro, rd, t, order, samples)
    res = trace_fast(scene, ro, rd, t, seed, max_depth, features,
                     nee_lights=nee_lights, rr_start=rr_start)
    if tiled:
        img = unpermute_image(res.radiance, inv, height, width, samples)
    else:
        img = res.radiance.reshape(height, width, samples, 3).mean(dim=2)
    return FrameResult(img, res.ray_count, res.readbacks)


def render_frame_fast(scene: Scene, camera, width: int, height: int,
                      samples: int, max_depth: int, frame_key: torch.Tensor,
                      seed: int, features: SceneFeatures,
                      nee_lights: Optional[LightTable] = None,
                      rr_start: int = 0, stratify: bool = False) -> FrameResult:
    """Whole-frame render through the fast path on the scene's device.
    ``frame_key`` (a Threefry key, :mod:`pathtrace_tpu_torch.utils.threefry`)
    draws the primary rays as the reference's does, ``stratify`` places
    each pixel's samples Latin-hypercube; ``seed`` must be frame-unique and
    keys the bounce RNG. ``nee_lights``, ``rr_start``: as
    :func:`trace_fast`'s."""
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    ro, rd, t = generate_primary_rays(camera, width, height, samples,
                                      frame_key, stratify,
                                      device=scene.spheres.center.device)
    R = height * width * samples
    return trace_frame(scene, ro.reshape(R, 3), rd.reshape(R, 3),
                       t.reshape(R), width, height, samples, max_depth, seed,
                       features, nee_lights, rr_start)


# ---------------------------------------------------------------------------
# the differentiable trace (training path)
# ---------------------------------------------------------------------------

class FastState(NamedTuple):
    """[R, 3]-form wavefront state of the differentiable trace (twin of
    the reference's ``FastState`` without the NEE plane)."""

    ro: torch.Tensor          # [R, 3]
    rd: torch.Tensor          # [R, 3]
    time: torch.Tensor        # [R]
    radiance: torch.Tensor    # [R, 3]
    throughput: torch.Tensor  # [R, 3]
    alive: torch.Tensor       # [R] bool
    lane: torch.Tensor        # [R] int32, uint32 bit pattern of the stream id


def nearest_hit_attrs(table: torch.Tensor, soa: torch.Tensor, scene: Scene,
                      ro: torch.Tensor, rd: torch.Tensor, time: torch.Tensor,
                      features: SceneFeatures, med_u=None):
    """Closest hit over every kind of the scene, differentiable in t, and
    the winner's attribute row by one row gather from ``table`` (the
    blocks of :func:`winner_table`): (t [R], attrs [R, K]). Twin of the
    reference's ``nearest_hit_attrs`` (``fastpath.py:242``): the spheres
    through ``SphereNearest`` (moving spheres pass their motion leaves and
    the rays' time; a scene without spheres has no sweep), then the rects,
    boxes and media in plain PyTorch (the media at the free-flight
    uniforms ``med_u``), each kind winning only when strictly nearer.
    Nothing here writes in place, so autograd reaches every kind's
    leaves."""
    f = features
    if f.has_spheres:
        sp = scene.spheres
        motion = ((sp.center_delta, sp.time0, sp.inv_time_delta, time)
                  if f.has_motion else ())
        t, idx = SphereNearest.apply(soa, sp.center, sp.radius, ro, rd,
                                     *motion)
    else:
        t = torch.full(ro.shape[:1], _INF, dtype=ro.dtype, device=ro.device)
        idx = torch.zeros(ro.shape[:1], dtype=torch.int32, device=ro.device)
    rows = table_rows(scene, f)
    rays = (*ro.unbind(1), *rd.unbind(1))
    if f.has_rects:
        t, idx = merge_rects(scene.rects, rays, t, idx, rows.rect)
    if f.has_boxes:
        t, idx = merge_winner(t, idx, *box_nearest(scene.boxes, *rays),
                              rows.box)
    if f.has_media:
        t, idx = merge_winner(t, idx, *media_nearest(scene.media, *rays,
                                                     med_u), rows.media)
    return t, table.index_select(0, idx.long())


def _diff_image_rgb(scene: Scene, attrs: torch.Tensor, point: torch.Tensor,
                    normal: torch.Tensor, t_safe: torch.Tensor, box,
                    features: SceneFeatures) -> torch.Tensor:
    """The image branch of the differentiable bounce (the reference's
    ``fast_bounce``, ``fastpath.py:655-701``): the sphere UV from the
    bounce's normal, a rect's in-plane fractions, a box's face
    parameterization in object space (``box``: the face axis and the
    object-space ray of :func:`~pathtrace_tpu_torch.ops.shade_kernel.box_frame`),
    the ``ii``/``jj`` clamps into the row's image, then one row gather
    from ``scene.atlas.data``: [R, 3]. The texel's index is an integer,
    so only the atlas leaf gets a gradient, as in the reference."""
    f = features
    kind = attrs[:, GEO - 1]
    with torch.no_grad():
        nx, ny = normal[:, 0], normal[:, 1]
        phi = torch.atan2(nx, ny)
        theta = torch.asin(torch.clamp(ny, -1.0, 1.0))
        uu = 1.0 - (phi + 3.14159265) * (0.5 / 3.14159265)
        vv = (theta + 1.5707963) * (1.0 / 3.14159265)
        p = point
        geo = attrs[:, GEO:GEO + 6]
        if f.has_rects:
            axis = geo[:, 0].to(torch.int32)
            pa = torch.where(axis == 0, p[:, 1], p[:, 0])
            pb = torch.where(axis == 2, p[:, 1], p[:, 2])
            da = geo[:, 2] - geo[:, 1]
            db = geo[:, 4] - geo[:, 3]
            da = torch.where(torch.abs(da) < 1e-12, 1.0, da)
            db = torch.where(torch.abs(db) < 1e-12, 1.0, db)
            is_rect = kind == KIND_RECT
            uu = torch.where(is_rect, (pa - geo[:, 1]) / da, uu)
            vv = torch.where(is_rect, (pb - geo[:, 3]) / db, vv)
        if f.has_boxes:
            face_axis, ro_o, rd_o = box
            p_obj = [ro_o[k] + t_safe * rd_o[k] for k in range(3)]

            def gp(planes, ax):
                return torch.where(ax == 0, planes[0],
                                   torch.where(ax == 1, planes[1], planes[2]))

            a_ax = torch.where(face_axis == 0, 1, 0)
            b_ax = torch.where(face_axis == 2, 1, 2)
            bp0 = [geo[:, k] for k in range(3)]
            bp1 = [geo[:, 3 + k] for k in range(3)]
            da = gp(bp1, a_ax) - gp(bp0, a_ax)
            db = gp(bp1, b_ax) - gp(bp0, b_ax)
            da = torch.where(torch.abs(da) < 1e-12, 1.0, da)
            db = torch.where(torch.abs(db) < 1e-12, 1.0, db)
            is_box = kind == KIND_BOX
            uu = torch.where(is_box, (gp(p_obj, a_ax) - gp(bp0, a_ax)) / da,
                             uu)
            vv = torch.where(is_box, (gp(p_obj, b_ax) - gp(bp0, b_ax)) / db,
                             vv)
        img = attrs[:, -3:]
        ii = _trunc_clamp(uu * img[:, 2], img[:, 2])
        jj = _trunc_clamp((1.0 - vv) * img[:, 1] - 0.001, img[:, 1])
        atlas = scene.atlas.data
        flat = (img[:, 0].to(torch.int32) + jj) * atlas.shape[1] + ii
    return atlas.reshape(-1, 3).index_select(0, flat.long())


def fast_bounce(table: torch.Tensor, soa: torch.Tensor, scene: Scene,
                state: FastState, seed: int, depth: int, max_depth: int,
                features: SceneFeatures) -> FastState:
    """One differentiable bounce: the twin of the reference's
    ``fast_bounce`` (``fastpath.py:549-895``) without NEE and roulette:
    the media's free-flight uniforms (draws ``8 + j``), the sphere, rect,
    box (the slab test redone from the winner's row) and medium normals,
    constant/checker/noise/image albedo, emission and sky, and the
    Lambertian/metal/dielectric/isotropic scatter. The masked square
    roots keep the reference's double-where guards, so masked lanes leak
    no NaN into the gradients."""
    f = features
    med_u = (media_uniforms(state.lane, seed, depth, scene.media.count, 8)
             if f.has_media else None)
    t, attrs = nearest_hit_attrs(table, soa, scene, state.ro, state.rd,
                                 state.time, f, med_u)
    hit = t < _INF
    t_safe = torch.where(hit, t, 0.0)
    point = state.ro + t_safe[:, None] * state.rd

    kind = attrs[:, GEO - 1]
    center = attrs[:, GEO:GEO + 3]
    if f.has_motion:
        s = (state.time - attrs[:, GEO + 6]) * attrs[:, GEO + 7]
        center = center + s[:, None] * attrs[:, GEO + 3:GEO + 6]
    r = attrs[:, GEO + 8]
    inv_r = 1.0 / torch.where(torch.abs(r) < 1e-12, 1.0, r)
    normal = (point - center) * inv_r[:, None]
    if f.has_rects:
        one_hot = (torch.arange(3, dtype=point.dtype, device=point.device)
                   == attrs[:, GEO, None]).to(point.dtype)
        normal = torch.where((kind == KIND_RECT)[:, None],
                             one_hot * attrs[:, GEO + 6, None], normal)
    box = None
    if f.has_boxes:
        box_n, face_axis, ro_o, rd_o = box_frame(
            attrs.T, state.ro.unbind(1), state.rd.unbind(1), t_safe)
        box = (face_axis, ro_o, rd_o)
        normal = torch.where((kind == KIND_BOX)[:, None],
                             torch.stack(box_n, dim=1), normal)
    if f.has_media:
        # arbitrary: the isotropic phase function ignores it
        normal = torch.where((kind == KIND_MEDIUM)[:, None],
                             normal.new_tensor([1.0, 0.0, 0.0]), normal)

    tex_kind = attrs[:, 3]
    rgb = attrs[:, 4:7]
    if f.has_checker:
        with torch.no_grad():  # only its sign is used
            p = point.detach()
            sines = (torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1])
                     * torch.sin(10.0 * p[:, 2]))
        checker = torch.where(sines[:, None] < 0.0, attrs[:, 7:10],
                              attrs[:, 10:13])
        rgb = torch.where((tex_kind == float(TEX_CHECKER))[:, None], checker,
                          rgb)
    if f.has_noise:
        marble = 0.5 * (1.0 + torch.sin(
            attrs[:, 13] * point[:, 2]
            + 10.0 * fast_turb_c(point[:, 0], point[:, 1], point[:, 2])))
        rgb = torch.where((tex_kind == float(TEX_NOISE))[:, None],
                          marble[:, None], rgb)
    if f.has_image:
        img_rgb = _diff_image_rgb(scene, attrs, point, normal, t_safe, box, f)
        rgb = torch.where((tex_kind == float(TEX_IMAGE))[:, None], img_rgb,
                          rgb)

    mat_kind = attrs[:, 0]
    sky_t = 0.5 * (state.rd[:, 1] + 1.0)
    grad_sky = (1.0 - sky_t)[:, None] + sky_t[:, None] * torch.tensor(
        [0.15, 0.21, 0.30], dtype=point.dtype, device=point.device)
    sky_rgb = torch.where(scene.use_gradient_sky > 0.5, grad_sky,
                          scene.sky.reshape(1, 3))
    is_light = mat_kind == float(MAT_DIFFUSE_LIGHT)
    prim_emit = torch.where(is_light[:, None], rgb, 0.0)
    emit = torch.where(hit[:, None], prim_emit, sky_rgb)
    alive_f = state.alive.to(point.dtype)[:, None]
    radiance = state.radiance + state.throughput * emit * alive_f

    u1 = counter_uniform(state.lane, seed, depth, 0)
    u2 = counter_uniform(state.lane, seed, depth, 1)
    u3 = counter_uniform(state.lane, seed, depth, 2)
    uc = counter_uniform(state.lane, seed, depth, 3)
    zz = u1 * 2.0 - 1.0
    aa = u2 * TWO_PI
    rr = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    unit = torch.stack([rr * torch.cos(aa), rr * torch.sin(aa), zz], dim=-1)

    d = state.rd
    n = normal
    rdotn = torch.sum(d * n, dim=-1)
    reflected = d - 2.0 * rdotn[:, None] * n
    direction = unit
    ok = torch.ones_like(hit)

    if f.has_dielectric:
        ref_idx = attrs[:, 2]
        exiting = rdotn > 0.0
        outward = torch.where(exiting[:, None], -n, n)
        ni = torch.where(exiting, ref_idx, 1.0 / ref_idx)
        cos_in = torch.where(exiting, rdotn, -rdotn)
        ces = 1.0 - ref_idx * ref_idx * (1.0 - cos_in * cos_in)
        # double-where guards: sqrt'(0) is infinite and would poison the
        # gradients of the lanes the outer where masks off
        cosine = torch.where(
            exiting, torch.sqrt(torch.where(ces > 0.0, ces, 1.0)), cos_in)
        dt_ = torch.sum(d * outward, dim=-1)
        disc = 1.0 - ni * ni * (1.0 - dt_ * dt_)
        refr_ok = disc > 0.0
        sq = torch.sqrt(torch.where(refr_ok, disc, 1.0))
        refr = (ni[:, None] * (d - outward * dt_[:, None])
                - outward * sq[:, None])
        r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
        r0 = r0 * r0
        omc = 1.0 - cosine
        omc2 = omc * omc
        schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
        reflect_prob = torch.where(refr_ok, schlick, 1.0)
        diel_dir = torch.where((uc > reflect_prob)[:, None], refr, reflected)
        is_diel = mat_kind == float(MAT_DIELECTRIC)
        direction = torch.where(is_diel[:, None], diel_dir, direction)

    if f.has_metal:
        rad3 = cbrt_pos(u3)
        metal_dir = reflected + (attrs[:, 1] * rad3)[:, None] * unit
        is_metal = mat_kind == float(MAT_METAL)
        direction = torch.where(is_metal[:, None], metal_dir, direction)
        ok = torch.where(is_metal, rdotn < 0.0, ok)

    if f.has_lambertian:
        is_lam = mat_kind == float(MAT_LAMBERTIAN)
        direction = torch.where(is_lam[:, None], n + unit, direction)

    if f.has_light:
        ok = ok & ~is_light

    inv_len = torch.rsqrt(torch.clamp(
        torch.sum(direction * direction, dim=-1), min=1e-38))
    direction = direction * inv_len[:, None]

    atten = rgb
    if f.has_dielectric:
        atten = torch.where(is_diel[:, None], 1.0, rgb)

    can = state.alive & hit & ok & (depth < max_depth)
    cs = can[:, None]
    return FastState(
        ro=torch.where(cs, point, state.ro),
        rd=torch.where(cs, direction, state.rd),
        time=state.time,
        radiance=radiance,
        throughput=torch.where(cs, state.throughput * atten,
                               state.throughput),
        alive=can,
        lane=state.lane,
    )


def diff_supported(features: SceneFeatures, scene: Scene) -> bool:
    """True for the scenes :func:`trace_fast_diff` takes; raises
    ``ValueError`` naming what is missing otherwise (:func:`diff_refusal`).
    The trainer renders the others through the general integrator."""
    why = diff_refusal(features, scene)
    if why is not None:
        raise ValueError(why)
    return True


def _check_atlas(scene: Scene) -> None:
    """Refuse atlas entries that reach outside the atlas data (the clamps
    keep each texel read inside its entry, so the entries bound every
    read)."""
    at = scene.atlas
    h, w = at.data.shape[:2]
    if bool(((at.y_offset < 0) | (at.height < 0) | (at.width < 0)
             | (at.y_offset + at.height > h) | (at.width > w)).any()):
        raise ValueError("atlas entries reach outside the atlas data")


def trace_fast_diff(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                    time: torch.Tensor, seed: int, max_depth: int,
                    features: SceneFeatures):
    """Differentiable fast trace: all ``max_depth + 1`` bounces at full
    width, no compaction (twin of the reference's ``trace_fast_diff``,
    ``fastpath.py:1568``). Gradients flow to the scene's leaves through
    the attribute table, the closest hit's backward, the rect, box and
    media sweeps and the atlas gather. Returns (radiance [R, 3], segments
    [] int64 on the device). Scenes of :func:`diff_refusal` raise."""
    diff_supported(features, scene)
    if features.has_image:
        _check_atlas(scene)
    table = winner_table(scene, features)
    soa = build_sphere_soa(scene, motion=features.has_motion)
    R = ro.shape[0]
    dev = ro.device
    state = FastState(
        ro=ro, rd=rd, time=time,
        radiance=torch.zeros((R, 3), dtype=ro.dtype, device=dev),
        throughput=torch.ones((R, 3), dtype=ro.dtype, device=dev),
        alive=torch.ones(R, dtype=torch.bool, device=dev),
        lane=torch.arange(R, dtype=torch.int32, device=dev),
    )
    seed = int(seed)
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(max_depth + 1):
        segs = segs + state.alive.sum()
        state = fast_bounce(table, soa, scene, state, seed, depth, max_depth,
                            features)
    return state.radiance, segs
