"""The whole-scene BVH behind ``-B`` (counterpart of the flat tree of
``pathtrace_tpu/models/bvh.py``): the host-side build, the flattened
arrays, the traversal and the hit records of its winners.

* **Build** (host): the native builder (``utils/native.py``, the
  repository's ``native/bvh_builder.cpp``), or the numpy builders of the
  reference, reachable only with ``use_native=False``: the full-sweep SAH
  (``_build_numpy_sah``) and the reference's random-axis median split on
  AABB minima (``_build_numpy``, seeded as the reference seeds it). One
  primitive a leaf, DFS pre-order with escape indices.
* **Scene tree** (:func:`build_scene_bvh`): one tree over every kind's
  AABBs, global ids laid out sphere | rect | box | medium from each kind's
  *array* count (masked primitives are not in the tree), SAH by default.
* **Traversal** (:func:`bvh_scene_nearest`): on a CUDA device the kernel
  of ``csrc/bvh_traverse.cu``; on the CPU its plain version, the
  reference's lock-step loop (``ops/bvh_kernel.py``). Both give (t [R],
  global id [R]); a miss is (MAX_T, 0).
* **Records** (:func:`scene_record_from_gid`, :func:`make_bvh_intersect_fn`):
  the winner's record from the per-kind builders of ``ops/intersect.py``,
  the general integrator's ``intersect_fn``.

:func:`bvh_sphere_nearest` is the reference's sphere-only traversal
(``:308-408``), plain only: no entry point reaches it. Its sphere test
keeps the full quadratic (``a = |rd|^2``, and a division), unlike the
scene traversal's unit-direction leaf.

* **Wide tree** (:class:`WideBVH`, :func:`widen_flat_bvh`,
  :func:`build_scene_wide_bvh`; the reference's ``:815-970``): a
  host-side post-pass over the flat tree. Child boxes live in the
  parent's row, and an all-sphere subtree of at most ``leaf_m`` leaves
  becomes one leaf carrying its spheres inline. Every provider below
  and the fast path take it wherever they take the flat tree; its
  traversal is ``csrc/bvh_wide_traverse.cu`` on the card and its plain
  version on the CPU, with the flat tree's (t, gid). ``-B`` builds the
  flat tree, as the reference does.

The reference's straggler slicing (``_BULK_IT``, ``_SLICE_N`` and the
wide tree's ``_WIDE_BULK_IT``, ``_WIDE_SLICE_N``) is not here: it is a
static-shape workaround that gives the plain loop's bits.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import (
    MEDIUM_SPHERE,
    Scene,
    SceneFeatures,
    Spheres,
)
from pathtrace_tpu_torch.ops import bvh_kernel

_INF = float(MAX_T)


@dataclasses.dataclass
class FlatBVH:
    """Flattened BVH in DFS pre-order with escape indices (numpy, host)."""

    bb_min: np.ndarray   # [M, 3] f32
    bb_max: np.ndarray   # [M, 3] f32
    escape: np.ndarray   # [M] i32: the next node on a miss (M = the end)
    prim: np.ndarray     # [M] i32: the primitive of a leaf, -1 inner
    builder: str = "numpy"  # "native" or "numpy"
    _operands: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def n_nodes(self) -> int:
        return self.bb_min.shape[0]

    def operand(self, scene: Scene, features: SceneFeatures, offsets,
                device) -> bvh_kernel.TreeOperand:
        """The traversal's operand over ``scene`` on ``device``, kept for
        the next call with the same scene tensors."""
        return _cached_operand(self, bvh_kernel.tree_operand, scene, features,
                               offsets, device)


def _cached_operand(tree, build, scene, features, offsets, device):
    """``build(tree, scene, features, offsets, device)``, kept in the
    tree's ``_operands`` for the next call with the same scene tensors."""
    key = (str(torch.device(device)), features._key(), tuple(offsets))
    hit = tree._operands.get(key)
    if hit is not None and hit[0] is scene.spheres.center:
        return hit[1]
    op = build(tree, scene, features, offsets, device)
    tree._operands[key] = (scene.spheres.center, op)
    return op


@dataclasses.dataclass
class BVHStats:
    """Build census (the reference's ``BVHStats``)."""

    node_count: int
    leaf_count: int
    max_depth: int


def _np64(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      np.float64)


# ---------------------------------------------------------------------------
# AABBs
# ---------------------------------------------------------------------------

def _transform_aabb(world_from_obj, mn, mx):
    """Object AABBs to world space per axis (the sign-select form)."""
    m = _np64(world_from_obj)
    lin, trans = m[:, :, :3], m[:, :, 3]
    lo = np.where(lin > 0, lin * mn[:, None, :], lin * mx[:, None, :]).sum(axis=2)
    hi = np.where(lin > 0, lin * mx[:, None, :], lin * mn[:, None, :]).sum(axis=2)
    return (lo + trans).astype(np.float32), (hi + trans).astype(np.float32)


def sphere_aabbs(spheres: Spheres):
    """Per-sphere AABBs over both motion end points, with ``|r|`` (a
    negative radius would invert the box); an instance's object box
    mapped to world space."""
    c = _np64(spheres.center)
    d = _np64(spheres.center_delta)
    r = np.abs(_np64(spheres.radius))[:, None]
    c1 = c + d
    mn = np.minimum(c - r, c1 - r)
    mx = np.maximum(c + r, c1 + r)
    if spheres.instanced:
        return _transform_aabb(spheres.world_from_obj, mn, mx)
    return mn.astype(np.float32), mx.astype(np.float32)


def rect_aabbs(rects):
    """Per-rect AABBs, 1e-4 thick along the normal axis."""
    n = rects.count
    axis = rects.axis.cpu().numpy().astype(np.int64)
    a_axis = np.where(axis == 0, 1, 0)
    b_axis = np.where(axis == 2, 1, 2)
    mn = np.zeros((n, 3), np.float64)
    mx = np.zeros((n, 3), np.float64)
    rows = np.arange(n)
    k = _np64(rects.k)
    mn[rows, axis] = k - 1e-4
    mx[rows, axis] = k + 1e-4
    mn[rows, a_axis] = _np64(rects.a0)
    mx[rows, a_axis] = _np64(rects.a1)
    mn[rows, b_axis] = _np64(rects.b0)
    mx[rows, b_axis] = _np64(rects.b1)
    if rects.instanced:
        return _transform_aabb(rects.world_from_obj, mn, mx)
    return mn.astype(np.float32), mx.astype(np.float32)


def box_aabbs(boxes):
    return _transform_aabb(boxes.world_from_obj, _np64(boxes.p0),
                           _np64(boxes.p1))


def media_aabbs(media):
    """Boundary AABBs: the transformed box, or centre +- |r| for a
    sphere boundary."""
    mn_b, mx_b = _transform_aabb(media.world_from_obj, _np64(media.p0),
                                 _np64(media.p1))
    c = media.p0.detach().cpu().numpy().astype(np.float32)
    r = np.abs(media.radius.detach().cpu().numpy().astype(np.float32))[:, None]
    is_sph = (media.kind.cpu().numpy() == MEDIUM_SPHERE)[:, None]
    return np.where(is_sph, c - r, mn_b), np.where(is_sph, c + r, mx_b)


def scene_aabbs(scene: Scene):
    """(bb_min [P, 3], bb_max [P, 3], mask [P], offsets): every primitive
    in global-id order; ``offsets`` are the sphere, rect, box and medium
    blocks' starts (from each kind's array count)."""
    parts = [sphere_aabbs(scene.spheres), rect_aabbs(scene.rects),
             box_aabbs(scene.boxes), media_aabbs(scene.media)]
    mn = np.concatenate([p[0] for p in parts], axis=0)
    mx = np.concatenate([p[1] for p in parts], axis=0)
    mask = np.concatenate([k.mask.cpu().numpy() for k in
                           (scene.spheres, scene.rects, scene.boxes,
                            scene.media)])
    ns, nr, nb = (p[0].shape[0] for p in parts[:3])
    return mn, mx, mask, (0, ns, ns + nr, ns + nr + nb)


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------

def build_flat_bvh(bb_min: np.ndarray, bb_max: np.ndarray,
                   mask: Optional[np.ndarray] = None, seed: int = 0,
                   use_native: bool = True,
                   strategy: str = "median") -> Tuple[FlatBVH, BVHStats]:
    """Build and flatten a BVH over the primitive AABBs whose ``mask`` is
    set. ``use_native``: the native builder, which raises if it cannot be
    built or loaded; else the numpy builders. ``strategy``: "median" (the
    reference's random-axis median split) or "sah"."""
    ids = np.arange(bb_min.shape[0], dtype=np.int32)
    if mask is not None:
        ids = ids[np.asarray(mask, bool)]
    if ids.size == 0:
        raise ValueError("cannot build BVH over empty primitive set")
    if use_native:
        from pathtrace_tpu_torch.utils.native import native_build_bvh

        arrays, (nodes, leaves, depth) = native_build_bvh(
            bb_min, bb_max, ids, seed, strategy=strategy)
        return (FlatBVH(**arrays, builder="native"),
                BVHStats(node_count=nodes, leaf_count=leaves, max_depth=depth))
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    if strategy == "sah":
        return _build_numpy_sah(bb_min, bb_max, ids)
    return _build_numpy(bb_min, bb_max, ids, seed)


def _flatten(nodes_min, nodes_max, nodes_prim, stats) -> Tuple[FlatBVH, BVHStats]:
    """Pre-order node lists -> FlatBVH, escape = index + subtree size."""
    M = len(nodes_prim)
    stats.node_count = M
    prim = np.asarray(nodes_prim, np.int32)
    sizes = np.ones(M, np.int64)
    # children follow their parent in pre-order: a reverse scan sizes
    # every subtree (the left child is i + 1, the right one after it)
    for i in range(M - 1, -1, -1):
        if prim[i] < 0:
            left = i + 1
            sizes[i] = 1 + sizes[left] + sizes[left + sizes[left]]
    escape = (np.arange(M, dtype=np.int64) + sizes).astype(np.int32)
    return FlatBVH(bb_min=np.asarray(nodes_min, np.float32),
                   bb_max=np.asarray(nodes_max, np.float32),
                   escape=escape, prim=prim), stats


def _build_numpy_sah(bb_min, bb_max, ids) -> Tuple[FlatBVH, BVHStats]:
    """Full-sweep SAH: per node, try all 3 axes sorted by centroid and
    pick the split minimizing area_L * n_L + area_R * n_R (the first
    minimum); past depth 64 an axis-0 centroid median."""
    cent = (bb_min + bb_max) * 0.5
    nodes_min, nodes_max, nodes_prim = [], [], []
    stats = BVHStats(node_count=0, leaf_count=0, max_depth=0)

    def emit(mn, mx, prim):
        nodes_min.append(mn)
        nodes_max.append(mx)
        nodes_prim.append(prim)

    def half_area(mns, mxs):
        d = np.maximum(mxs - mns, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]

    def build(subset: np.ndarray, depth: int):
        stats.max_depth = max(stats.max_depth, depth)
        mn = bb_min[subset].min(axis=0)
        mx = bb_max[subset].max(axis=0)
        if subset.size == 1:
            stats.leaf_count += 1
            emit(mn, mx, int(subset[0]))
            return
        if depth >= 64:
            s = subset[np.argsort(cent[subset, 0], kind="stable")]
            emit(mn, mx, -1)
            build(s[: s.size // 2], depth + 1)
            build(s[s.size // 2:], depth + 1)
            return
        best = None
        for ax in range(3):
            s = subset[np.argsort(cent[subset, ax], kind="stable")]
            pm = np.minimum.accumulate(bb_min[s], 0)
            px = np.maximum.accumulate(bb_max[s], 0)
            sm = np.minimum.accumulate(bb_min[s][::-1], 0)[::-1]
            sx = np.maximum.accumulate(bb_max[s][::-1], 0)[::-1]
            a_l = half_area(pm, px)
            a_r = half_area(sm, sx)
            k = np.arange(1, s.size, dtype=np.float64)
            cost = a_l[:-1] * k + a_r[1:] * (s.size - k)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (float(cost[j]), s, j + 1)
        _, s, midp = best
        emit(mn, mx, -1)
        build(s[:midp], depth + 1)
        build(s[midp:], depth + 1)

    _recurse(build, ids.astype(np.int64))
    return _flatten(nodes_min, nodes_max, nodes_prim, stats)


def _build_numpy(bb_min, bb_max, ids, seed) -> Tuple[FlatBVH, BVHStats]:
    """The reference's split: a random axis (``default_rng(seed)``), a
    stable sort on the AABB minima along it, the median."""
    rng = np.random.default_rng(seed)
    nodes_min, nodes_max, nodes_prim = [], [], []
    stats = BVHStats(node_count=0, leaf_count=0, max_depth=0)

    def build(subset: np.ndarray, depth: int):
        stats.max_depth = max(stats.max_depth, depth)
        mn = bb_min[subset].min(axis=0)
        mx = bb_max[subset].max(axis=0)
        if subset.size == 1:
            stats.leaf_count += 1
            nodes_min.append(mn)
            nodes_max.append(mx)
            nodes_prim.append(int(subset[0]))
            return
        axis = int(rng.integers(0, 3))
        subset = subset[np.argsort(bb_min[subset, axis], kind="stable")]
        mid = subset.size // 2
        nodes_min.append(mn)
        nodes_max.append(mx)
        nodes_prim.append(-1)
        build(subset[:mid], depth + 1)
        build(subset[mid:], depth + 1)

    _recurse(build, ids.astype(np.int64))
    return _flatten(nodes_min, nodes_max, nodes_prim, stats)


def _recurse(build, ids) -> None:
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        build(ids, 1)
    finally:
        sys.setrecursionlimit(old)


def build_scene_bvh(scene: Scene, seed: int = 0, use_native: bool = True,
                    strategy: str = "sah"):
    """The whole-scene tree (every kind): (flat, stats, offsets). SAH by
    default, as the reference builds it for ``-B``."""
    mn, mx, mask, offsets = scene_aabbs(scene)
    flat, stats = build_flat_bvh(mn, mx, mask=mask, seed=seed,
                                 use_native=use_native, strategy=strategy)
    return flat, stats, offsets


# ---------------------------------------------------------------------------
# the wide-node tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WideBVH:
    """Packed wide-node rows (the reference's ``WideBVH``).

    ``pack`` [M, W] float32, int columns as int32 bits, W = max(14, 2 +
    leaf_m * (1 + slot_f)):

    * column 0, nav: an inner node's right child, -1 at a leaf;
    * column 1, the escape: the next node when the subtree is done;
    * inner: columns 2-7 the left child's box (min xyz, max xyz), 8-13
      the right child's;
    * leaf: columns 2 .. 2 + leaf_m - 1 the slots' global ids (-1 empty),
      then each slot's sphere, ``slot_f`` floats: centre xyz, radius and
      with motion delta xyz, time0, inv_dt. A non-sphere leaf has one slot
      and zeros for its sphere.
    """

    pack: torch.Tensor   # [M, W] f32
    leaf_m: int
    has_motion: bool
    builder: str = "numpy"  # the flat tree's builder
    _operands: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def n_nodes(self) -> int:
        return self.pack.shape[0]

    @property
    def slot_f(self) -> int:
        return 9 if self.has_motion else 4

    def operand(self, scene: Scene, features: SceneFeatures, offsets,
                device) -> bvh_kernel.WideOperand:
        """The wide traversal's operand on ``device``
        (:func:`~pathtrace_tpu_torch.ops.bvh_kernel.wide_operand`), kept
        for the next call with the same scene tensors."""
        return _cached_operand(self, bvh_kernel.wide_operand, scene, features,
                               offsets, device)


def widen_flat_bvh(flat: FlatBVH, scene: Scene, offsets,
                   features: Optional[SceneFeatures] = None,
                   leaf_m: Optional[int] = None) -> WideBVH:
    """Collapse a flat tree into wide-node rows (numpy, on the host), as
    the reference's ``widen_flat_bvh``: each inner row carries its
    children's boxes; a flat leaf, or a subtree of spheres only with at
    most ``leaf_m`` leaves, becomes one leaf row, its spheres inlined.
    ``leaf_m`` defaults to 8 in a static scene, 4 with motion, 1 without
    spheres. Rows are emitted in pre-order (the left child next), so the
    rows' order is the flat tree's.

    Snapshot semantics, as in the reference: the spheres' centres, radii
    and motion are copied into the rows here, so the tree intersects the
    scene as it was at this call. The flat tree's operand reads the live
    sphere tensors; a wide tree kept across parameter updates (a training
    loop) must be rebuilt, or it answers for the old geometry.

    Instanced spheres or rects raise ``ValueError``: their leaves need
    the object-space records the flat tree keeps."""
    f = features or SceneFeatures.from_scene(scene)
    if scene.spheres.instanced or scene.rects.instanced:
        raise ValueError("widen_flat_bvh inlines world-space leaf data; "
                         "instanced scenes use the flat tree")
    has_motion = bool(f.has_motion)
    if leaf_m is None:
        leaf_m = (8 if not has_motion else 4) if f.has_spheres else 1
    off_s, off_r = int(offsets[0]), int(offsets[1])
    prim = np.asarray(flat.prim, np.int64)
    esc = np.asarray(flat.escape, np.int64)
    is_leaf = prim >= 0
    is_sph = is_leaf & (prim < off_r)
    # prefix sums: a subtree [i, esc[i]) has leaf_pre[esc] - leaf_pre[i]
    # leaves, sph_pre[...] of them spheres
    leaf_pre = np.concatenate([[0], np.cumsum(is_leaf)])
    sph_pre = np.concatenate([[0], np.cumsum(is_sph)])
    sd = 9 if has_motion else 4
    W = max(14, 2 + leaf_m * (1 + sd))
    sp = scene.spheres
    data = [_np64(sp.center), _np64(sp.radius)[:, None]]
    if has_motion:
        data += [_np64(sp.center_delta), _np64(sp.time0)[:, None],
                 _np64(sp.inv_time_delta)[:, None]]
    sph = np.concatenate(data, axis=1).astype(np.float32)

    rows, nav = [], []
    # (flat node, wide row of the parent whose nav it sets, or -1)
    stack = [(0, -1)]
    while stack:
        i, parent = stack.pop()
        me = len(rows)
        row = np.zeros(W, np.float32)
        rows.append(row)
        nav.append(-1)
        if parent >= 0:
            nav[parent] = me
        n_leaf = leaf_pre[esc[i]] - leaf_pre[i]
        n_sph = sph_pre[esc[i]] - sph_pre[i]
        if is_leaf[i] or (n_sph == n_leaf and n_leaf <= leaf_m):
            gids = prim[i:esc[i]]
            gids = gids[gids >= 0]
            bits = np.full(leaf_m, -1, np.int32)
            bits[:gids.size] = gids
            row[2:2 + leaf_m] = bits.view(np.float32)
            for k, g in enumerate(gids):
                if g < off_r:
                    b = 2 + leaf_m + k * sd
                    row[b:b + sd] = sph[g - off_s]
            continue
        left, right = i + 1, esc[i + 1]
        row[2:5], row[5:8] = flat.bb_min[left], flat.bb_max[left]
        row[8:11], row[11:14] = flat.bb_min[right], flat.bb_max[right]
        nav[me] = 0   # an inner row: set when its right child is emitted
        stack.append((right, me))
        stack.append((left, -1))
    M = len(rows)
    nav_a = np.asarray(nav, np.int64)
    # escapes: a row's subtree is the row, its left child's subtree (the
    # next row) and its right child's (from nav)
    size = np.ones(M, np.int64)
    for r in range(M - 1, -1, -1):
        if nav_a[r] >= 0:
            size[r] = 1 + size[r + 1] + size[nav_a[r]]
    pack = np.stack(rows)
    pack_i = pack.view(np.int32)
    pack_i[:, 0] = nav_a
    pack_i[:, 1] = np.arange(M) + size
    return WideBVH(pack=torch.from_numpy(pack), leaf_m=leaf_m,
                   has_motion=has_motion, builder=flat.builder)


def build_scene_wide_bvh(scene: Scene,
                         features: Optional[SceneFeatures] = None,
                         seed: int = 0, leaf_m: Optional[int] = None,
                         use_native: bool = True):
    """The whole-scene wide tree: (wide, stats, offsets), ``stats`` the
    flat tree's census."""
    flat, stats, offsets = build_scene_bvh(scene, seed=seed,
                                           use_native=use_native)
    wide = widen_flat_bvh(flat, scene, offsets, features=features,
                          leaf_m=leaf_m)
    return wide, stats, offsets


# ---------------------------------------------------------------------------
# traversal (either tree)
# ---------------------------------------------------------------------------

def bvh_scene_nearest(bvh, scene: Scene, ro: torch.Tensor,
                      rd: torch.Tensor, time: torch.Tensor, med_u=None,
                      t_min: float = MIN_T, t_max: float = MAX_T,
                      features: Optional[SceneFeatures] = None,
                      offsets=(0, 0, 0, 0)):
    """Closest hit over the whole scene through the tree: (t [R], global
    id [R] int32) for rays ``ro``, ``rd`` [R, 3] (unit directions) at
    ``time`` [R]; ``med_u`` the media's [R, n_media] free-flight uniforms.
    The same winners as the brute per-kind sweep (``ops/intersect.py``),
    the reference's ``bvh_scene_nearest``; through a :class:`WideBVH`
    its ``wide_scene_nearest``, with the same winners. The kernel on a
    CUDA device, the plain version on the CPU."""
    f = features or SceneFeatures.from_scene(scene)
    op = bvh.operand(scene, f, offsets, ro.device)
    rays = torch.cat([ro.T, rd.T]).to(torch.float32).contiguous()
    flights = None
    if f.has_media:
        flights = bvh_kernel.media_flights(op, med_u.T)
    return bvh_kernel.bvh_traverse(op, rays, time, flights, t_min, t_max)


def leaf_candidate(bvh, scene: Scene, gid: torch.Tensor,
                   ro: torch.Tensor, rd: torch.Tensor, time: torch.Tensor,
                   med_u=None, best_t: Optional[torch.Tensor] = None,
                   t_min: float = MIN_T,
                   features: Optional[SceneFeatures] = None,
                   offsets=(0, 0, 0, 0)) -> torch.Tensor:
    """The candidate t [R] of one primitive a ray, by its global id
    ``gid`` [R] (the reference's ``_leaf_candidate``): the leaf test of
    the plain traversal (``bvh_kernel.leaf_candidate``) against
    ``best_t``, MAX_T where it misses. Rays, time and ``med_u`` as
    :func:`bvh_scene_nearest`'s."""
    f = features or SceneFeatures.from_scene(scene)
    op = bvh.operand(scene, f, offsets, ro.device)
    rays = torch.cat([ro.T, rd.T]).to(torch.float32).contiguous()
    flights = bvh_kernel.media_flights(op, med_u.T) if f.has_media else None
    return bvh_kernel.leaf_candidate(op, gid, rays, time, flights, best_t,
                                     t_min)


def bvh_sphere_nearest(bvh: FlatBVH, spheres: Spheres, ro: torch.Tensor,
                       rd: torch.Tensor, time: torch.Tensor,
                       t_min: float = MIN_T, t_max: float = MAX_T,
                       has_motion: bool = True):
    """The reference's sphere-only lock-step traversal (plain PyTorch):
    (t [R], sphere index [R] int32) over a tree of world-space spheres.
    Its leaf keeps the full quadratic: ``a = |rd|^2``, roots divided by
    ``a``, the mask checked."""
    if spheres.instanced:
        raise ValueError("instanced spheres traverse through "
                         "bvh_scene_nearest's object-space leaf")
    dev = ro.device
    R = ro.shape[0]
    M = bvh.n_nodes
    bb_min = torch.from_numpy(bvh.bb_min).to(dev)
    bb_max = torch.from_numpy(bvh.bb_max).to(dev)
    prim_all = torch.from_numpy(bvh.prim).to(dev)
    esc_all = torch.from_numpy(bvh.escape).to(dev).to(torch.int64)
    rcp = 1.0 / torch.where(torch.abs(rd) < 1e-12, 1e-12, rd)
    tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    cursor = torch.zeros(R, dtype=torch.int64, device=dev)
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int32, device=dev)
    live = torch.arange(R, device=dev)
    step = 0
    while live.numel() > 0 and step < 4 * M:
        cur = cursor[live]
        o, rc_, bt = ro[live], rcp[live], best_t[live]
        d0 = (bb_min[cur] - o) * rc_
        d1 = (bb_max[cur] - o) * rc_
        lo, hi = torch.minimum(d0, d1), torch.maximum(d0, d1)
        tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        hit = torch.minimum(tf, bt) > torch.maximum(tn, tmin_t)
        prim = prim_all[cur]
        leaf = torch.nonzero(hit & (prim >= 0)).flatten()
        if leaf.numel():
            ray = live[leaf]
            pid = prim[leaf].to(torch.int64)
            c = spheres.center[pid]
            if has_motion:
                s = (time[ray] - spheres.time0[pid]) * spheres.inv_time_delta[pid]
                c = c + s[:, None] * spheres.center_delta[pid]
            r = spheres.radius[pid]
            o_, d_ = ro[ray], rd[ray]
            oc = o_ - c
            a = d_[:, 0] * d_[:, 0] + d_[:, 1] * d_[:, 1] + d_[:, 2] * d_[:, 2]
            b = oc[:, 0] * d_[:, 0] + oc[:, 1] * d_[:, 1] + oc[:, 2] * d_[:, 2]
            cc = (oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1]
                  + oc[:, 2] * oc[:, 2] - r * r)
            disc = b * b - a * cc
            sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0).double()).float()
            t0 = (-b - sq) / a
            t1 = (-b + sq) / a
            btl = best_t[ray]
            valid = (disc > 0.0) & spheres.mask[pid]
            t0_ok = valid & (t0 > t_min) & (t0 < btl)
            t1_ok = valid & (t1 > t_min) & (t1 < btl)
            cand = torch.where(t0_ok, t0, torch.where(t1_ok, t1, _INF))
            better = cand < btl
            best_t[ray] = torch.where(better, cand, btl)
            best_i[ray] = torch.where(better, prim[leaf], best_i[ray])
        nxt = torch.where(hit & (prim < 0), cur + 1, esc_all[cur])
        cursor[live] = nxt
        step += 1
        live = live[nxt < M]
    return torch.where(best_t < t_max, best_t, _INF), best_i


def make_bvh_sphere_nearest(bvh: FlatBVH):
    """Bind a built tree into the ``sphere_nearest_fn`` interface."""

    def fn(spheres, ro, rd, time, t_min=MIN_T, t_max=MAX_T, has_motion=True):
        return bvh_sphere_nearest(bvh, spheres, ro, rd, time, t_min, t_max,
                                  has_motion=has_motion)

    return fn


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def scene_record_from_gid(scene: Scene, t: torch.Tensor, gid: torch.Tensor,
                          ro, rd, time, offsets,
                          features: Optional[SceneFeatures] = None):
    """The hit record of global-id winners: each kind's record from
    ``ops/intersect.py`` on its lanes, merged by the id's block."""
    from pathtrace_tpu_torch.ops import intersect as isect

    f = features or SceneFeatures.from_scene(scene)
    off_s, off_r, off_b, off_m = offsets
    gid = gid.long()
    hit = t < _INF
    rec = None

    def merge(rec, nxt, in_kind):
        return nxt if rec is None else isect._select_record(~in_kind, rec, nxt)

    kinds = (("spheres", f.has_spheres, off_s, off_r),
             ("rects", f.has_rects, off_r, off_b),
             ("boxes", f.has_boxes, off_b, off_m),
             ("media", f.has_media, off_m, None))
    for name, on, lo, hi in kinds:
        if not on:
            continue
        prims = getattr(scene, name)
        in_k = hit & (gid >= lo) if hi is None else hit & (gid >= lo) & (gid < hi)
        pid = torch.clamp(gid - lo, 0, prims.count - 1)
        t_k = torch.where(in_k, t, _INF)
        if name == "spheres":
            nxt = isect.sphere_record(prims, t_k, pid, ro, rd, time,
                                      with_uv=f.has_image)
        elif name == "rects":
            nxt = isect.rect_record(prims, t_k, pid, ro, rd)
        elif name == "boxes":
            nxt = isect.box_record(prims, t_k, pid, ro, rd)
        else:
            nxt = isect.media_record(prims, t_k, pid, ro, rd)
        rec = merge(rec, nxt, in_k)
    return isect._miss_record(ro) if rec is None else rec


def make_bvh_intersect_fn(bvh, offsets, features: SceneFeatures):
    """Bind a scene tree (flat or wide) into the general integrator's
    ``intersect_fn`` slot: ``fn(scene, ro, rd, time, med_u, t_min,
    t_max)`` -> HitRecord."""

    def fn(scene, ro, rd, time, med_u, t_min=MIN_T, t_max=MAX_T):
        t, gid = bvh_scene_nearest(bvh, scene, ro, rd, time, med_u, t_min,
                                   t_max, features=features, offsets=offsets)
        return scene_record_from_gid(scene, t, gid, ro, rd, time, offsets,
                                     features=features)

    return fn
