"""Closest hit through the whole-scene BVH: the CUDA kernel of
``csrc/bvh_traverse.cu`` and its plain PyTorch version.

It replaces no TPU kernel. The reference traverses in XLA, a lock-step
``lax.while_loop`` over the whole wavefront
(``pathtrace_tpu/models/bvh.py:635-785``, ``bvh_scene_nearest``): every
step gathers one node per ray, tests its box against the ray's running
best t and, at a leaf, runs that primitive's test. Its trip count is
the longest ray's path, and its straggler slicing (``:1104-1186``)
exists only because XLA needs static shapes. In PyTorch the same loop
would be ~40 launches and one host readback a step, ~100 steps a
bounce. On the card the natural form is one thread a ray walking the
escape-index tree: the ray visits the same nodes in the same order as in
the lock-step loop, so the kernel's (t, gid) equal the plain version's
bit for bit.

The operand (:func:`tree_operand`) is laid out for the card: each node
is two 16-byte rows, (min xyz, escape) and (max xyz, prim), read through
the read-only cache, and in a scene of world-space spheres each sphere
leaf carries its sphere inline (centre, radius, and with motion delta,
time0 and inv_dt: one or three more rows), as the reference packs them
(``:672-684``), so a sphere leaf needs no second read. Every other leaf
reads its primitive's 96-byte record (:data:`PRIM_W` floats, by global
id): instanced spheres, rects, boxes and media. The media's free flights
``-log(max(u, 1e-38)) / density`` come in as a [n_media, R] operand
computed once in PyTorch (:func:`media_flights`) for the kernel and the
plain version alike, so the kernel has no transcendental.

What it keeps of the reference: the box test ``min(tf, best_t) >
max(tn, t_min)`` with ``rcp = 1 / (|d| < 1e-12 ? 1e-12 : d)`` (a tiny
negative component becomes +1e-12), the strict ``cand < best_t`` (on a
tie the first leaf visited wins), the miss convention (t = MAX_T, gid
0), the step cap ``4 * n_nodes`` (never reached: a cursor only grows),
and each kind's leaf arithmetic, written as explicit sums in one fixed
order in both versions (the affine maps as ``((m0 x + m1 y) + m2 z) +
m3``). min and max propagate a NaN in both (PTX ``min.NaN``, as
``torch.minimum``), so a ray with a NaN misses every box in both. The
plain version roots in float64 and rounds once (the correctly rounded
float32 sqrt that the kernel's IEEE ``sqrtf`` gives).

The wide-node tree (``models.bvh.WideBVH``, the reference's
``wide_scene_nearest``, ``:978-1101``) has its own operand
(:func:`wide_operand`: the pack's rows, with each leaf's filled slots and
kind in the header), plain version (:func:`wide_traverse_plain`) and
kernel (``csrc/bvh_wide_traverse.cu``: the flat kernel's instances, by
the rule :func:`traverse_plan` mirrors), with the leaf tests of
``csrc/bvh_leaf.cuh`` and the same (t, gid) as the flat tree's;
:func:`bvh_traverse` takes either operand. Its counts are
``WIDE_LAUNCHES`` and ``WIDE_PLAIN_CALLS``; :func:`wide_yardsticks` is its
bound. The reference's straggler slicing of the wide loop
(``_WIDE_BULK_IT``, ``_WIDE_SLICE_N``) is not here, as for the flat tree.

Bound on the card: issue slots, not bytes. With ``-fmad=false`` a box
test is ~24 instructions and a leaf test 25-60; the reads are two node
rows a visit (L2-resident: ~975 nodes on the cover scene, ~8,200 on xl)
and 28 bytes a ray in and 8 out. The kernel keeps each warp's lanes in
lock-step, as the reference's loop keeps the wavefront: neighbouring rays
visit the same nodes at the same step, so a node's rows are one broadcast
load. It has an instance for trees of inline static spheres alone and one
for inline moving spheres alone (:func:`traverse_plan` mirrors the pick).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import MEDIUM_SPHERE
from pathtrace_tpu_torch.ops.box_media_kernel import media_flights as _flights

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)
WIDE_LAUNCHES = 0     # the same for the wide tree's kernel
WIDE_PLAIN_CALLS = 0

_INF = float(MAX_T)
THREADS = 128    # threads a block of the flat kernel, one ray a thread
PRIM_W = 24      # floats a primitive record (rows of 4: 3 data, 3 affine)
AFFINE = 12      # first float of a record's obj_from_world (3x4 row-major)

# operand flags (csrc/bvh_traverse.cu reads the same bits)
F_INLINE = 1      # sphere leaves carry their sphere (world-space spheres)
F_MOTION = 2      # centres lerp to the ray's time
F_SPHERES = 4     # the kinds the leaf tests take (the scene's features)
F_RECTS = 8
F_BOXES = 16
F_MEDIA = 32
F_RECT_INST = 64  # rect leaves map the ray to object space

# a wide leaf's kind, header column 3 (csrc/bvh_wide_traverse.cu LeafKind)
WIDE_KIND_SPHERE, WIDE_KIND_RECT, WIDE_KIND_BOX, WIDE_KIND_MEDIUM = 0, 1, 2, 3

# per-visit and per-leaf-test operations (one instruction each under
# -fmad=false), for the issue bound; sqrt and a division count 1
OPS_VISIT = 24
OPS_LEAF = {"sphere": 24, "sphere_inst": 50, "rect": 18, "rect_inst": 42,
            "box": 58, "media": 80}
# the wide tree: an inner visit tests two child boxes and picks the next
# node (2 x 24 + 6), a leaf visit reads its header and moves on (6); a
# sphere slot whose discriminant is positive takes the inline leaf's test
# (24), one whose is not stops after the discriminant (18); with motion
# each slot 8 more for the lerp
OPS_WIDE_INNER = 54
OPS_WIDE_LEAF = 6
OPS_WIDE_SLOT_MISS = 18
OPS_WIDE_MOTION = 8


class TreeOperand(NamedTuple):
    nodes: torch.Tensor     # [M, 4 * rows] f32 (int planes as bits)
    prims: torch.Tensor     # [P, PRIM_W] f32 leaf records by global id
    density: torch.Tensor   # [n_media] f32 (media scenes; else empty)
    n_nodes: int
    offsets: Tuple[int, int, int, int]  # sphere, rect, box, medium starts
    flags: int

    @property
    def node_rows(self) -> int:
        return self.nodes.shape[1] // 4


def _np(x):
    return x.detach().cpu().numpy()


def tree_operand(bvh, scene, features, offsets, device) -> TreeOperand:
    """The kernel's operand of a built tree (``models.bvh.FlatBVH``) over
    ``scene``'s primitives, global ids laid out by ``offsets``; on
    ``device``."""
    off_s, off_r, off_b, off_m = (int(o) for o in offsets)
    sp = scene.spheres
    flags = _flags(scene, features)
    inline = bool(flags & F_INLINE)
    motion = bool(flags & F_MOTION)
    rows = 2 + ((3 if motion else 1) if inline else 0)
    M = bvh.n_nodes
    prim = np.asarray(bvh.prim, np.int32)
    nodes = np.zeros((M, 4 * rows), np.float32)
    nodes[:, 0:3] = bvh.bb_min
    nodes[:, 3] = np.asarray(bvh.escape, np.int32).view(np.float32)
    nodes[:, 4:7] = bvh.bb_max
    nodes[:, 7] = prim.view(np.float32)
    if inline:
        data = [_np(sp.center), _np(sp.radius)[:, None]]
        if motion:
            data += [_np(sp.center_delta), _np(sp.time0)[:, None],
                     _np(sp.inv_time_delta)[:, None]]
        sph = np.concatenate(data, axis=1).astype(np.float32)
        leaf = (prim >= 0) & (prim < off_r)
        lid = np.clip(prim - off_s, 0, sp.count - 1)
        nodes[leaf, 8:8 + sph.shape[1]] = sph[lid[leaf]]

    prims, density = _prim_records(scene, features, (off_s, off_r, off_b,
                                                     off_m), device)
    return TreeOperand(
        nodes=torch.from_numpy(nodes).to(torch.device(device)),
        prims=prims, density=density, n_nodes=M,
        offsets=(off_s, off_r, off_b, off_m), flags=flags)


class WideOperand(NamedTuple):
    """The wide-node tree's operand (``models.bvh.WideBVH``; see
    :func:`wide_operand` for the row layout)."""
    nodes: torch.Tensor     # [M, 4 * node_rows] f32 (int columns as bits)
    prims: torch.Tensor     # [P, PRIM_W] f32 records of non-sphere leaves
    density: torch.Tensor   # [n_media] f32 (media scenes; else empty)
    n_nodes: int
    offsets: Tuple[int, int, int, int]
    flags: int
    leaf_m: int             # slots a leaf
    slot_base: int          # first column of slot 0's sphere
    slot_f: int             # floats a slot's sphere (4 static, 12 moving)

    @property
    def node_rows(self) -> int:
        return self.nodes.shape[1] // 4


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def wide_operand(wide, scene, features, offsets, device) -> WideOperand:
    """The wide kernel's operand of a ``models.bvh.WideBVH`` (its pack,
    the reference's ``[M, W]`` rows) over ``scene``'s non-sphere
    primitives, on ``device``. The pack's rows are re-laid for 16-byte
    loads, its int columns moved as int32 bits:

    * columns 0-3: nav (inner: the right child; leaf: -1), escape, and
      the port's own header fields: the leaf's filled slots (a prefix of
      its ``leaf_m``; 0 at an inner node) and its kind (``WIDE_KIND_*`` of
      its first slot's id; -1 at an inner node), which the kernel's loop
      and branch read instead of the ids;
    * inner, columns 4-15: the left child's box (min xyz, max xyz), then
      the right child's;
    * leaf, columns 4 .. 4 + MP: the slots' global ids (-1 empty; MP the
      slot count rounded up to 4), then from ``slot_base`` each slot's
      sphere: centre xyz, radius; with motion also delta xyz, time0,
      inv_dt and 3 zeros (12 floats, three float4 rows).

    The spheres are the pack's (its build-time snapshot); a non-sphere
    leaf reads its record by global id, as the flat tree's does."""
    off_s, off_r, off_b, off_m = (int(o) for o in offsets)
    flags = _flags(scene, features)
    if features.has_spheres and bool(features.has_motion) != wide.has_motion:
        raise ValueError("the wide tree was built for another motion "
                         "setting than the features'")
    pack = wide.pack.detach().cpu().numpy()
    pack_i = pack.view(np.int32)
    M = pack.shape[0]
    lm, sd = wide.leaf_m, wide.slot_f
    SD = 12 if wide.has_motion else 4
    base = 4 + _round4(lm)
    nodes = np.zeros((M, _round4(max(16, base + lm * SD))), np.float32)
    nodes_i = nodes.view(np.int32)
    nodes_i[:, 0:2] = pack_i[:, 0:2]
    inner = pack_i[:, 0] >= 0
    nodes[inner, 4:16] = pack[inner, 2:14]
    leaf = ~inner
    nodes_i[leaf, 4:base] = -1
    nodes_i[leaf, 4:4 + lm] = pack_i[leaf, 2:2 + lm]
    ids = pack_i[:, 2:2 + lm]
    nodes_i[:, 2] = np.where(leaf, (ids >= 0).sum(axis=1), 0)
    nodes_i[:, 3] = np.where(leaf, wide_leaf_kind(ids[:, 0], offsets), -1)
    for m in range(lm):
        src = 2 + lm + m * sd
        dst = base + m * SD
        nodes[leaf, dst:dst + sd] = pack[leaf, src:src + sd]
    prims, density = _prim_records(scene, features, (off_s, off_r, off_b,
                                                     off_m), device)
    return WideOperand(
        nodes=torch.from_numpy(nodes).to(torch.device(device)),
        prims=prims, density=density, n_nodes=M,
        offsets=(off_s, off_r, off_b, off_m), flags=flags, leaf_m=lm,
        slot_base=base, slot_f=SD)


def wide_leaf_kind(gid: np.ndarray, offsets) -> np.ndarray:
    """The ``WIDE_KIND_*`` of leaves whose first slot holds global id
    ``gid``: a sphere leaf holds spheres only, any other leaf one
    primitive (``models.bvh.widen_flat_bvh``)."""
    _, off_r, off_b, off_m = (int(o) for o in offsets)
    return np.select([gid < off_r, gid < off_b, gid < off_m],
                     [WIDE_KIND_SPHERE, WIDE_KIND_RECT, WIDE_KIND_BOX],
                     WIDE_KIND_MEDIUM).astype(np.int32)


def _flags(scene, features) -> int:
    f = features
    inline = bool(f.has_spheres) and not scene.spheres.instanced
    return ((F_INLINE if inline else 0)
            | (F_MOTION if f.has_motion else 0)
            | (F_SPHERES if f.has_spheres else 0)
            | (F_RECTS if f.has_rects else 0)
            | (F_BOXES if f.has_boxes else 0)
            | (F_MEDIA if f.has_media else 0)
            | (F_RECT_INST if scene.rects.instanced else 0))


def _prim_records(scene, features, offsets, device):
    """(records [P, PRIM_W], media densities) of every primitive by global
    id, on ``device``: what a leaf reads that does not carry its
    primitive inline."""
    off_s, off_r, off_b, off_m = offsets
    sp, rc, bx, md = scene.spheres, scene.rects, scene.boxes, scene.media
    P = off_m + md.count
    prims = np.zeros((P, PRIM_W), np.float32)

    def affine(lo, n, m):
        if m is not None:
            prims[lo:lo + n, AFFINE:] = _np(m).reshape(n, 12)

    ns = sp.count
    blk = prims[off_s:off_s + ns]
    blk[:, 0:3], blk[:, 3] = _np(sp.center), _np(sp.radius)
    blk[:, 4:7], blk[:, 7] = _np(sp.center_delta), _np(sp.time0)
    blk[:, 8], blk[:, 9] = _np(sp.inv_time_delta), _np(sp.mask)
    affine(off_s, ns, sp.obj_from_world)
    blk = prims[off_r:off_r + rc.count]
    for k, x in enumerate((rc.axis, rc.a0, rc.a1, rc.b0, rc.b1, rc.k,
                           rc.mask)):
        blk[:, k] = _np(x)
    affine(off_r, rc.count, rc.obj_from_world)
    blk = prims[off_b:off_b + bx.count]
    blk[:, 0:3], blk[:, 3:6], blk[:, 6] = (_np(bx.p0), _np(bx.p1),
                                           _np(bx.mask))
    affine(off_b, bx.count, bx.obj_from_world)
    blk = prims[off_m:off_m + md.count]
    blk[:, 0:3], blk[:, 3:6], blk[:, 6] = (_np(md.p0), _np(md.p1),
                                           _np(md.mask))
    blk[:, 7], blk[:, 8] = _np(md.kind), _np(md.radius)
    affine(off_m, md.count, md.obj_from_world)
    dev = torch.device(device)
    density = (md.density.detach().to(dev, torch.float32).contiguous()
               if features.has_media else torch.zeros(0, device=dev))
    return torch.from_numpy(prims).to(dev), density


def media_flights(op: TreeOperand, uniforms) -> Optional[torch.Tensor]:
    """[n_media, R] free-flight distances ``-log(max(u, 1e-38)) /
    density`` of the media's uniforms (a list of [R], or [n_media, R]),
    the form the reference's leaf test computes; None without media."""
    return (_flights(op.density, uniforms) if op.flags & F_MEDIA
            else None)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # float64 root rounded once = the correctly rounded float32 sqrt
    return torch.sqrt(x.double()).float()


def _maximum3(a, b, c):
    return torch.maximum(torch.maximum(a, b), c)


def _minimum3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def _affine(m, x, y, z, translate: bool):
    """``m`` [A, 12] (3x4 row-major) applied to the points (or, without
    ``translate``, the directions) (x, y, z): a list of 3 [A]."""
    out = []
    for r in range(3):
        v = m[:, 4 * r] * x + m[:, 4 * r + 1] * y + m[:, 4 * r + 2] * z
        out.append(v + m[:, 4 * r + 3] if translate else v)
    return out


def _slab(p0, p1, o, d):
    """(t_enter, t_exit) of the object-space rays (o, d) against boxes
    [p0, p1] (lists of 3 [A]), a tiny direction component as +1e-12."""
    lo, hi = [], []
    for k in range(3):
        rcp = 1.0 / torch.where(torch.abs(d[k]) < 1e-12, 1e-12, d[k])
        d0 = (p0[k] - o[k]) * rcp
        d1 = (p1[k] - o[k]) * rcp
        lo.append(torch.minimum(d0, d1))
        hi.append(torch.maximum(d0, d1))
    return _maximum3(*lo), _minimum3(*hi)


def _root_pick(t0, t1, valid, best_t, t_min):
    t0_ok = valid & (t0 > t_min) & (t0 < best_t)
    t1_ok = valid & (t1 > t_min) & (t1 < best_t)
    return torch.where(t0_ok, t0, torch.where(t1_ok, t1, _INF))


def _leaf_sphere_inline(row, o, d, tm, best_t, t_min, motion, base=8,
                        crosses=False):
    """The unit-direction sphere test of a sphere inline in ``row`` from
    column ``base``: centre, radius, then delta, time0 and inv_dt. With
    ``crosses`` also whether the discriminant is positive."""
    c = [row[:, base], row[:, base + 1], row[:, base + 2]]
    r = row[:, base + 3]
    if motion:
        s = (tm - row[:, base + 7]) * row[:, base + 8]
        c = [c[k] + s * row[:, base + 4 + k] for k in range(3)]
    oc = [o[k] - c[k] for k in range(3)]
    b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r
    disc = b * b - cc
    sq = _sqrt(torch.where(disc > 0.0, disc, 1.0))
    cand = _root_pick(-b - sq, -b + sq, disc > 0.0, best_t, t_min)
    return (cand, disc > 0.0) if crosses else cand


def _leaf_sphere_instanced(rec, o, d, tm, best_t, t_min, motion):
    c = [rec[:, 0], rec[:, 1], rec[:, 2]]
    r = rec[:, 3]
    if motion:
        s = (tm - rec[:, 7]) * rec[:, 8]
        c = [c[k] + s * rec[:, 4 + k] for k in range(3)]
    m = rec[:, AFFINE:]
    os_ = _affine(m, *o, translate=True)
    ds = _affine(m, *d, translate=False)
    a = ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]
    oc = [os_[k] - c[k] for k in range(3)]
    b = oc[0] * ds[0] + oc[1] * ds[1] + oc[2] * ds[2]
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r
    disc = b * b - a * cc
    sq = _sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    valid = (disc > 0.0) & (rec[:, 9] > 0.5)
    return _root_pick((-b - sq) * inv_a, (-b + sq) * inv_a, valid, best_t,
                      t_min)


def _leaf_rect(rec, o, d, best_t, t_min, instanced):
    if instanced:
        m = rec[:, AFFINE:]
        o = _affine(m, *o, translate=True)
        d = _affine(m, *d, translate=False)
    axis = rec[:, 0].to(torch.int64)

    def pick(v, ax):
        return torch.where(ax == 0, v[0], torch.where(ax == 1, v[1], v[2]))

    a_ax = torch.where(axis == 0, 1, 0)
    b_ax = torch.where(axis == 2, 1, 2)
    d_n = pick(d, axis)
    d_n = torch.where(torch.abs(d_n) < 1e-12, 1e-12, d_n)
    t = (rec[:, 5] - pick(o, axis)) / d_n
    pa = pick(o, a_ax) + t * pick(d, a_ax)
    pb = pick(o, b_ax) + t * pick(d, b_ax)
    ok = ((rec[:, 6] > 0.5) & (t > t_min) & (t < best_t)
          & (pa >= rec[:, 1]) & (pa <= rec[:, 2])
          & (pb >= rec[:, 3]) & (pb <= rec[:, 4]))
    return torch.where(ok, t, _INF)


def _leaf_box(rec, o, d, best_t, t_min):
    m = rec[:, AFFINE:]
    oo = _affine(m, *o, translate=True)
    do = _affine(m, *d, translate=False)
    t_enter, t_exit = _slab([rec[:, k] for k in range(3)],
                            [rec[:, 3 + k] for k in range(3)], oo, do)
    crosses = (t_exit > t_enter) & (rec[:, 6] > 0.5)
    enter_ok = crosses & (t_enter > t_min) & (t_enter < best_t)
    exit_ok = (crosses & (t_enter <= t_min) & (t_exit > t_min)
               & (t_exit < best_t))
    return torch.where(enter_ok, t_enter, torch.where(exit_ok, t_exit, _INF))


def _leaf_media(rec, o, d, flight, best_t, t_min):
    m = rec[:, AFFINE:]
    oo = _affine(m, *o, translate=True)
    do = _affine(m, *d, translate=False)
    t1b, t2b = _slab([rec[:, k] for k in range(3)],
                     [rec[:, 3 + k] for k in range(3)], oo, do)
    # the sphere boundary takes the world ray (centre in p0)
    oc = [o[k] - rec[:, k] for k in range(3)]
    b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
    rad = rec[:, 8]
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rad * rad
    disc = b * b - cc
    sq = _sqrt(torch.where(disc > 0.0, disc, 1.0))
    is_sph = rec[:, 7] == float(MEDIUM_SPHERE)
    t1 = torch.where(is_sph, -b - sq, t1b)
    t2 = torch.where(is_sph, -b + sq, t2b)
    crosses = torch.where(is_sph, disc > 0.0, t2b > t1b) & (rec[:, 6] > 0.5)
    t1 = torch.clamp(t1, min=t_min)
    ok = crosses & (t1 < t2)
    t1 = torch.clamp(t1, min=0.0)
    inside = flight < (t2 - t1)
    hit = t1 + flight
    return torch.where(ok & inside & (hit < best_t), hit, _INF)


def _inline_row(rec: torch.Tensor) -> torch.Tensor:
    """A sphere's record [A, PRIM_W] laid out as the inline leaf row that
    :func:`_leaf_sphere_inline` reads (centre and radius from float 8,
    then delta, time0 and inv_dt)."""
    row = torch.zeros((rec.shape[0], 17), dtype=rec.dtype, device=rec.device)
    row[:, 8:12] = rec[:, 0:4]
    row[:, 12:15] = rec[:, 4:7]
    row[:, 15:17] = rec[:, 7:9]
    return row


def leaf_candidate(op: TreeOperand, gid: torch.Tensor, rays: torch.Tensor,
                   time: Optional[torch.Tensor] = None,
                   flights: Optional[torch.Tensor] = None,
                   best_t: Optional[torch.Tensor] = None,
                   t_min: float = MIN_T) -> torch.Tensor:
    """The candidate t of one primitive a ray, by its global id ``gid``
    [R] (the reference's ``_leaf_candidate``, ``models/bvh.py:513``): the
    plain traversal's leaf test of the id's kind, against ``best_t`` [R]
    (default MAX_T); MAX_T where it misses. ``rays`` [6, R], ``time``
    and ``flights`` as :func:`bvh_traverse_plain`'s."""
    dev = rays.device
    R = rays.shape[1]
    off_s, off_r, off_b, off_m = op.offsets
    fl = op.flags
    motion = bool(fl & F_MOTION)
    o = [rays[k] for k in range(3)]
    d = [rays[3 + k] for k in range(3)]
    gid = gid.to(torch.int64)
    bt = (torch.full((R,), _INF, dtype=torch.float32, device=dev)
          if best_t is None else best_t)
    tm = time if motion else None
    rec = op.prims[torch.clamp(gid, 0, op.prims.shape[0] - 1)]
    cand = torch.full((R,), _INF, dtype=torch.float32, device=dev)
    if fl & F_SPHERES:
        if fl & F_INLINE:
            c = _leaf_sphere_inline(_inline_row(rec), o, d, tm, bt, t_min,
                                    motion)
        else:
            c = _leaf_sphere_instanced(rec, o, d, tm, bt, t_min, motion)
        cand = torch.where(gid < off_r, c, cand)
    if fl & F_RECTS:
        c = _leaf_rect(rec, o, d, bt, t_min, bool(fl & F_RECT_INST))
        cand = torch.where((gid >= off_r) & (gid < off_b), c, cand)
    if fl & F_BOXES:
        c = _leaf_box(rec, o, d, bt, t_min)
        cand = torch.where((gid >= off_b) & (gid < off_m), c, cand)
    if fl & F_MEDIA:
        mid = torch.clamp(gid - off_m, 0, flights.shape[0] - 1)
        flight = flights[mid, torch.arange(R, device=dev)]
        c = _leaf_media(rec, o, d, flight, bt, t_min)
        cand = torch.where(gid >= off_m, c, cand)
    return cand


def _leaf_tests(op, gid, ray, o_all, d_all, time, flights, best_t, t_min,
                tests=None, inline_rows=None) -> torch.Tensor:
    """The candidate t of the leaves ``gid`` [A] (global ids) of the rays
    ``ray`` [A] against their ``best_t``, by kind: an inline sphere from
    ``inline_rows`` [A, ...] (the flat tree's node rows), every other kind
    from its record. ``tests`` ({kind: [R] int32}) counts the tests run."""
    off_s, off_r, off_b, off_m = op.offsets
    fl = op.flags
    motion = bool(fl & F_MOTION)
    cand = torch.full((gid.shape[0],), _INF, dtype=torch.float32,
                      device=gid.device)
    kinds = (
        ("sphere" if fl & F_INLINE else "sphere_inst",
         gid < off_r, F_SPHERES),
        ("rect_inst" if fl & F_RECT_INST else "rect",
         (gid >= off_r) & (gid < off_b), F_RECTS),
        ("box", (gid >= off_b) & (gid < off_m), F_BOXES),
        ("media", gid >= off_m, F_MEDIA),
    )
    for name, sel, flag in kinds:
        if not fl & flag:
            continue
        j = torch.nonzero(sel).flatten()
        if j.numel() == 0:
            continue
        r_ = ray[j]
        oj = [x[r_] for x in o_all]
        dj = [x[r_] for x in d_all]
        bj = best_t[r_]
        if name == "sphere":
            c = _leaf_sphere_inline(inline_rows[j], oj, dj,
                                    time[r_] if motion else None, bj, t_min,
                                    motion)
        else:
            rec = op.prims[gid[j].to(torch.int64)]
            if name == "sphere_inst":
                c = _leaf_sphere_instanced(
                    rec, oj, dj, time[r_] if motion else None, bj, t_min,
                    motion)
            elif name in ("rect", "rect_inst"):
                c = _leaf_rect(rec, oj, dj, bj, t_min, name == "rect_inst")
            elif name == "box":
                c = _leaf_box(rec, oj, dj, bj, t_min)
            else:
                mid = (gid[j] - off_m).to(torch.int64)
                c = _leaf_media(rec, oj, dj, flights[mid, r_], bj, t_min)
        cand[j] = c
        if tests is not None:
            tests[name][r_] += 1
    return cand


def bvh_traverse_plain(op: TreeOperand, rays: torch.Tensor,
                       time: Optional[torch.Tensor] = None,
                       flights: Optional[torch.Tensor] = None,
                       t_min: float = MIN_T, t_max: float = MAX_T,
                       stats: bool = False):
    """Plain PyTorch version of the traversal: the reference's lock-step
    loop (``_run_traversal``'s unsliced branch), each step over the rays
    whose cursor is still inside the tree (a finished ray's state does
    not change, so leaving it out changes no bit). ``rays`` [6, R] (ro
    xyz, rd xyz, |rd| = 1), ``time`` [R] (moving or instanced-moving
    spheres), ``flights`` [n_media, R] (:func:`media_flights`). Returns
    (t [R] f32, gid [R] int32); with ``stats`` also the nodes each ray
    visited and the leaf tests it ran by kind ({kind: [R] int32})."""
    dev = rays.device
    R = rays.shape[1]
    M = op.n_nodes
    nodes = op.nodes
    nodes_i = nodes.view(torch.int32)
    o_all = [rays[k] for k in range(3)]
    d_all = [rays[3 + k] for k in range(3)]
    rcp_all = [1.0 / torch.where(torch.abs(x) < 1e-12, 1e-12, x)
               for x in d_all]
    tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    cursor = torch.zeros(R, dtype=torch.int64, device=dev)
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int32, device=dev)
    visits = torch.zeros(R, dtype=torch.int32, device=dev)
    tests = {k: torch.zeros(R, dtype=torch.int32, device=dev)
             for k in OPS_LEAF}
    live = torch.arange(R, device=dev)
    step = 0
    while live.numel() > 0 and step < 4 * M:
        cur = cursor[live]
        row = nodes[cur]
        o = [x[live] for x in o_all]
        bt = best_t[live]
        d0 = [(row[:, k] - o[k]) * rcp_all[k][live] for k in range(3)]
        d1 = [(row[:, 4 + k] - o[k]) * rcp_all[k][live] for k in range(3)]
        tn = _maximum3(*(torch.minimum(d0[k], d1[k]) for k in range(3)))
        tf = _minimum3(*(torch.maximum(d0[k], d1[k]) for k in range(3)))
        hit = torch.minimum(tf, bt) > torch.maximum(tn, tmin_t)
        prim = nodes_i[cur, 7]
        esc = nodes_i[cur, 3].to(torch.int64)
        leaf = torch.nonzero(hit & (prim >= 0)).flatten()
        if leaf.numel():
            ray = live[leaf]
            gid = prim[leaf]
            cand = _leaf_tests(op, gid, ray, o_all, d_all, time, flights,
                               best_t, t_min, tests if stats else None,
                               inline_rows=row[leaf])
            better = cand < best_t[ray]
            best_t[ray] = torch.where(better, cand, best_t[ray])
            best_i[ray] = torch.where(better, gid, best_i[ray])
        nxt = torch.where(hit & (prim < 0), cur + 1, esc)
        cursor[live] = nxt
        visits[live] += 1
        step += 1
        live = live[nxt < M]
    t = torch.where(best_t < t_max, best_t, _INF)
    if stats:
        return t, best_i, visits, tests
    return t, best_i


def wide_traverse_plain(op: WideOperand, rays: torch.Tensor,
                        time: Optional[torch.Tensor] = None,
                        flights: Optional[torch.Tensor] = None,
                        t_min: float = MIN_T, t_max: float = MAX_T,
                        stats: bool = False):
    """Plain PyTorch version of the wide traversal: the reference's
    lock-step loop of ``wide_scene_nearest`` (``models/bvh.py:978-1101``,
    unsliced), each step over the rays still inside the tree. One row a
    ray a step: at an inner node both child boxes are tested against the
    running best t and the ray moves to the left child if it is hit
    (pre-order), else the right one, else the escape; at a leaf of
    sphere kind each filled slot's inline sphere is tested in slot order
    (the unit-direction test of the flat tree's inline leaf), at a leaf of
    another kind its one primitive through its record (the header's slot
    count and kind, as the kernel reads them); a leaf moves to its
    escape. Arguments and returns as :func:`bvh_traverse_plain`'s;
    ``stats`` counts inner visits (``"inner"``), leaf visits (``"leaf"``),
    sphere slots tested with a positive discriminant (``"sphere"``) and
    without (``"sphere_miss"``, which the kernel stops before the square
    root), and other leaf tests by kind."""
    dev = rays.device
    R = rays.shape[1]
    M = op.n_nodes
    fl = op.flags
    motion = bool(fl & F_MOTION)
    nodes = op.nodes
    nodes_i = nodes.view(torch.int32)
    o_all = [rays[k] for k in range(3)]
    d_all = [rays[3 + k] for k in range(3)]
    rcp_all = [1.0 / torch.where(torch.abs(x) < 1e-12, 1e-12, x)
               for x in d_all]
    tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    cursor = torch.zeros(R, dtype=torch.int64, device=dev)
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int32, device=dev)
    visits = torch.zeros(R, dtype=torch.int32, device=dev)
    tests = {k: torch.zeros(R, dtype=torch.int32, device=dev)
             for k in ("inner", "leaf", "sphere_miss", *OPS_LEAF)}

    def child_hit(box, o, rc, bt, b):
        d0 = [(box[:, b + k] - o[k]) * rc[k] for k in range(3)]
        d1 = [(box[:, b + 3 + k] - o[k]) * rc[k] for k in range(3)]
        tn = _maximum3(*(torch.minimum(d0[k], d1[k]) for k in range(3)))
        tf = _minimum3(*(torch.maximum(d0[k], d1[k]) for k in range(3)))
        return torch.minimum(tf, bt) > torch.maximum(tn, tmin_t)

    live = torch.arange(R, device=dev)
    step = 0
    while live.numel() > 0 and step < 4 * M:
        cur = cursor[live]
        nav = nodes_i[cur, 0].to(torch.int64)
        nxt = nodes_i[cur, 1].to(torch.int64)        # the escape
        inner = torch.nonzero(nav >= 0).flatten()
        if inner.numel():
            r_ = live[inner]
            c_ = cur[inner]
            box = nodes[c_, 4:16]
            o = [x[r_] for x in o_all]
            rc = [x[r_] for x in rcp_all]
            bt = best_t[r_]
            l_hit = child_hit(box, o, rc, bt, 0)
            r_hit = child_hit(box, o, rc, bt, 6)
            nxt[inner] = torch.where(l_hit, c_ + 1,
                                     torch.where(r_hit, nav[inner],
                                                 nxt[inner]))
            if stats:
                tests["inner"][r_] += 1
        leaf = torch.nonzero(nav < 0).flatten()
        if leaf.numel():
            r_ = live[leaf]
            row = nodes[cur[leaf]]
            row_i = row.view(torch.int32)
            count, kind = row_i[:, 2], row_i[:, 3]
            spheres = kind == WIDE_KIND_SPHERE
            bt = best_t[r_]
            bi = best_i[r_]
            if fl & F_SPHERES:
                o = [x[r_] for x in o_all]
                d = [x[r_] for x in d_all]
                tm = time[r_] if motion else None
                for m in range(op.leaf_m):
                    gid = row_i[:, 4 + m]
                    valid = spheres & (m < count)
                    if not bool(valid.any()):
                        continue
                    c, crosses = _leaf_sphere_inline(
                        row, o, d, tm, bt, t_min, motion,
                        base=op.slot_base + m * op.slot_f, crosses=True)
                    c = torch.where(valid, c, _INF)
                    better = c < bt
                    bt = torch.where(better, c, bt)
                    bi = torch.where(better, gid, bi)
                    if stats:
                        tests["sphere"][r_] += (valid & crosses).to(
                            torch.int32)
                        tests["sphere_miss"][r_] += (valid & ~crosses).to(
                            torch.int32)
            gid0 = row_i[:, 4]
            other = torch.nonzero(~spheres).flatten()
            if other.numel():
                best_t[r_], best_i[r_] = bt, bi
                ray = r_[other]
                cand = _leaf_tests(op, gid0[other], ray, o_all, d_all, time,
                                   flights, best_t, t_min,
                                   tests if stats else None)
                better = cand < bt[other]
                bt[other] = torch.where(better, cand, bt[other])
                bi[other] = torch.where(better, gid0[other], bi[other])
            best_t[r_], best_i[r_] = bt, bi
            if stats:
                tests["leaf"][r_] += 1
        cursor[live] = nxt
        visits[live] += 1
        step += 1
        live = live[nxt < M]
    t = torch.where(best_t < t_max, best_t, _INF)
    if stats:
        return t, best_i, visits, tests
    return t, best_i


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check(op: TreeOperand, rays, time, flights) -> None:
    dev = rays.device
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be float32 [6, R], got {rays.dtype} "
                         f"{tuple(rays.shape)}")
    if rays.stride(1) != 1:
        raise ValueError("ray rows must be unit-stride")
    for name, x in (("nodes", op.nodes), ("prims", op.prims)):
        if x.device != dev or not x.is_contiguous() or x.dtype != torch.float32:
            raise ValueError(f"operand {name} must be contiguous float32 on "
                             f"{dev}")
    R = rays.shape[1]
    if op.flags & F_MOTION and (time is None or time.shape != (R,)
                                or time.device != dev):
        raise ValueError("a scene with motion needs the rays' time [R]")
    if op.flags & F_MEDIA:
        n_media = op.density.shape[0]
        if (flights is None or flights.shape != (n_media, R)
                or flights.device != dev or not flights.is_contiguous()):
            raise ValueError(f"a media scene needs flights [{n_media}, {R}]")


def bvh_traverse(op: TreeOperand, rays: torch.Tensor,
                 time: Optional[torch.Tensor] = None,
                 flights: Optional[torch.Tensor] = None,
                 t_min: float = MIN_T, t_max: float = MAX_T,
                 visits: bool = False):
    """Closest hit through the tree for every ray: (t [R] f32, gid [R]
    int32), and with ``visits`` the nodes each ray visited ([R] int32).
    ``op`` is a flat tree's :class:`TreeOperand` (the kernel of
    ``csrc/bvh_traverse.cu``) or a wide tree's :class:`WideOperand`
    (``csrc/bvh_wide_traverse.cu``); both give the same (t, gid).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot build or launch)."""
    global PLAIN_CALLS, WIDE_PLAIN_CALLS
    _check(op, rays, time, flights)
    wide = isinstance(op, WideOperand)
    if rays.device.type == "cpu":
        if wide:
            WIDE_PLAIN_CALLS += 1
            plain = wide_traverse_plain
        else:
            PLAIN_CALLS += 1
            plain = bvh_traverse_plain
        out = plain(op, rays, time, flights, t_min, t_max, stats=visits)
        return out[:3] if visits else out
    if rays.device.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {rays.device}")
    return _launch(op, rays, time, flights, t_min, t_max, visits)


def _launch(op, rays, time, flights, t_min, t_max, visits):
    global LAUNCHES, WIDE_LAUNCHES
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R = rays.shape[1]
    dev = rays.device
    t_out = torch.empty(R, dtype=torch.float32, device=dev)
    g_out = torch.empty(R, dtype=torch.int32, device=dev)
    v_out = torch.empty(R, dtype=torch.int32, device=dev) if visits else None
    if R:
        time_c = (time.to(torch.float32).contiguous()
                  if op.flags & F_MOTION else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        off_s, off_r, off_b, off_m = op.offsets
        head = (rays.data_ptr(), rays.stride(0), R,
                time_c.data_ptr() if time_c is not None else None,
                op.nodes.data_ptr(), op.n_nodes, op.node_rows)
        tail = (op.prims.data_ptr(),
                flights.data_ptr() if flights is not None else None,
                off_r, off_b, off_m, op.flags, float(t_min), float(t_max),
                t_out.data_ptr(), g_out.data_ptr(),
                v_out.data_ptr() if v_out is not None else None, stream)
        if isinstance(op, WideOperand):
            code = lib.pt_bvh_wide_traverse(
                *head, op.leaf_m, op.slot_base, op.slot_f, *tail)
            _cuda_build.check(code, "bvh_wide_traverse launch")
            WIDE_LAUNCHES += 1
        else:
            code = lib.pt_bvh_traverse(*head, *tail)
            _cuda_build.check(code, "bvh_traverse launch")
            LAUNCHES += 1
    return (t_out, g_out, v_out) if visits else (t_out, g_out)


# the flat and wide kernels' instances (csrc/bvh_leaf.cuh kinds_of)
INSTANCE_ANY, INSTANCE_SPHERES, INSTANCE_MOVING_SPHERES = 0, 1, 2


def traverse_plan(n_rays: int, flags: int) -> dict:
    """The launch ``pt_bvh_traverse`` and ``pt_bvh_wide_traverse`` make
    for ``n_rays`` rays of a tree with operand ``flags``
    (``pt_bvh_traverse_plan`` and ``pt_bvh_wide_traverse_plan`` give the C
    side's, ``csrc/bvh_leaf.cuh`` ``traverse_plan``):
    one thread a ray in blocks of :data:`THREADS`, and the instance, one
    for inline static spheres alone, one for inline moving spheres alone,
    the general one for every other set of kinds."""
    if flags == F_INLINE | F_SPHERES:
        instance = INSTANCE_SPHERES
    elif flags == F_INLINE | F_SPHERES | F_MOTION:
        instance = INSTANCE_MOVING_SPHERES
    else:
        instance = INSTANCE_ANY
    return {"blocks": -(-n_rays // THREADS) if n_rays > 0 else 0,
            "threads": THREADS, "instance": instance}


def yardsticks(op: TreeOperand, R: int, visits: torch.Tensor,
               tests: dict, n_media: int = 0) -> dict:
    """The least time the card could take for one traversal of ``R``
    rays that visited ``visits`` nodes and ran ``tests`` leaf tests (the
    plain version's counts): operations at one instruction each over the
    33.5 T/s issue rate, against the bytes of rays in, results out, node
    rows and records read once."""
    ops = OPS_VISIT * int(visits.sum()) + sum(
        OPS_LEAF[k] * int(v.sum()) for k, v in tests.items())
    return _bound(op, R, visits, tests, n_media, ops)


def wide_yardsticks(op: WideOperand, R: int, visits: torch.Tensor,
                    tests: dict, n_media: int = 0) -> dict:
    """:func:`yardsticks` for the wide traversal, from its plain version's
    counts: ``OPS_WIDE_INNER`` an inner visit, ``OPS_WIDE_LEAF`` a leaf
    visit, a sphere slot's test (``OPS_LEAF["sphere"]`` with a positive
    discriminant, else ``OPS_WIDE_SLOT_MISS``; ``OPS_WIDE_MOTION`` more
    with motion) and other leaf tests at ``OPS_LEAF``."""
    lerp = OPS_WIDE_MOTION if op.flags & F_MOTION else 0
    per = {"inner": OPS_WIDE_INNER, "leaf": OPS_WIDE_LEAF,
           "sphere": OPS_LEAF["sphere"] + lerp,
           "sphere_miss": OPS_WIDE_SLOT_MISS + lerp}
    ops = sum(per.get(k, OPS_LEAF.get(k, 0)) * int(v.sum())
              for k, v in tests.items())
    return _bound(op, R, visits, tests, n_media, ops)


def _bound(op, R, visits, tests, n_media, ops) -> dict:
    from pathtrace_tpu_torch.tools._probe import HBM_BYTES_PER_S, ISSUE_PER_S

    nbytes = (R * (24 + (4 if op.flags & F_MOTION else 0) + 4 * n_media + 8)
              + op.nodes.numel() * 4 + op.prims.numel() * 4)
    ops_ms = ops / ISSUE_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "issue_ceiling_ms": ops_ms, "bytes_ms": bytes_ms,
            "operations": ops, "bytes": nbytes,
            "mean_visits": float(visits.double().mean()),
            "max_visits": int(visits.max()) if R else 0,
            "leaf_tests": {k: int(v.sum()) for k, v in tests.items()
                           if int(v.sum())}}
