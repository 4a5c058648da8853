"""The port's whole-scene BVH (``-B``) on the CPU against the JAX package:
the trees, the traversal, the global-id map onto the fast path's table,
the ``-B`` fast frames, ``--mode compacted`` (with and without the tree)
and the CLI.

JAX's side is the committed fixture ``tests/goldens/torch_port_bvh.npz``,
which this file's ``__main__`` writes (``PYTHONPATH=. python
tests/test_torch_bvh.py``, JAX on the CPU, ~2 min):

* trees: JAX's numpy SAH tree and its numpy median tree at seed 1
  (arrays and census) of ``random_spheres``, ``random`` (motion-expanded
  boxes), ``cornell_smoke`` and ``final_full``. The port's native build
  (``-ffp-contract=off``) and its numpy SAH build equal the first
  exactly, its numpy median build the second. (JAX's own native build,
  compiled ``-march=native``, contracts the SAH's area sums into FMAs on
  this sandbox's CPU and differs from its numpy twin at 13 of
  ``final_full``'s 2,817 nodes, so it is no fixed reference.)
* traversal: JAX's ``bvh_scene_nearest`` (t, gid) over its SAH tree on
  4,096 numpy rays (:func:`scene_rays`) of ``random_spheres``,
  ``random``, ``cornell``, ``cornell_smoke``, ``final_full`` and a scene
  of instanced spheres and rects; ``bvh_sphere_nearest`` on the two
  sphere scenes.
* the global-id map: JAX's ``_gid_to_table_row`` on every id of every
  preset with a tree, and the blocks of its table.
* frames: JAX's ``render_frame_fast`` with the tree (64x32, 2 spp, depth
  8, ``PRNGKey(3)``, seed 12345: ``tests/test_bvh_wide.py``'s frames,
  with the flat tree) of ``random_spheres``, ``simple_light`` and
  ``cornell_smoke``; ``render_frame_compacted`` of ``final_full`` through
  the tree and of ``random_spheres`` without it (``min_size`` 128, so the
  ladder compacts at this size).

Bounds: the traversal as ``tests/test_bvh.py``'s ``test_matches_brute_force``
(hit masks equal, t within rtol 1e-3 / atol 1e-4, gid equal on >= 99.9%
of hits), except that up to 0.1% of hits may leave the t bound. Both
sides compute ``|ro - c|^2 - r^2``, which cancels for a ray that starts
near the radius-1000 ground sphere (|ro - c|^2 ~ 1e6, whose float32 ULP
is 0.0625): XLA on the CPU contracts the sums into FMAs, the port rounds
each operation, and ray 3119 of ``random_spheres``, 1.6e-3 inside the
ground, gets c = 3.875 in JAX and 3.8125 in the port and leaves at t =
0.18675 against 0.18371. Against the port's brute sweep, whose K1
expands the quadratic further (PR 1: a ray inside the ground moves by
2.4e-4 at t = 0.08; 3 of 2,945 hits leave the t bound), K1's own lane
contract: at most 0.5% of the hits outside 1e-3.

``--mode compacted`` keys a lane's uniforms by its slot, so a lane whose
alive flag flips between the packages (K1 against XLA's sweep, PR 1)
moves every later alive lane to another slot, and other uniforms, at the
next compaction. ``final_full`` through the tree (whose winners flip far
less) holds the per-pixel budget; 88% of its pixels are black at this
film, so it checks the tree's records and estimator, not the slots (with
the slots reversed it reads 2.3% against 1.7%). ``random_spheres``
through K1 carries the slot check: it must
leave at most half as many pixels outside JAX's compacted frame as the
port's own frame traced without compaction (its slots never move) does
(measured: 54 against 163 of 1,536), which a ladder that slotted lanes
otherwise than the reference's would not. Frames: at most ``1 - (1 - b)^S`` of the pixels outside
1e-3 (``b`` = ``DEPTH10_BUDGET``); against the port's brute frames
``test_bvh_wide.py``'s bounds.
"""

import io
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.models import bvh as pbvh  # noqa: E402
from pathtrace_tpu_torch.models import build as pbuild  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import _cuda_build, bvh_kernel  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as fp  # noqa: E402
from pathtrace_tpu_torch.render.compaction import (  # noqa: E402
    render_frame_compacted,
)
from pathtrace_tpu_torch.render.frame import render_frame  # noqa: E402
from pathtrace_tpu_torch.utils import native  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from torch_port_util import DEPTH10_BUDGET, lane_close  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_bvh.npz")
ASPECT = 16 / 9
N_RAYS = 4096
TREE_SCENES = ("random_spheres", "random", "cornell_smoke", "final_full")
TRAV_SCENES = ("random_spheres", "random", "cornell", "cornell_smoke",
               "final_full", "instanced")
FRAME_SCENES = ("random_spheres", "simple_light", "cornell_smoke")
FRAME = dict(width=64, height=32, samples=2, depth=8, key=3, seed=12345)
# compacted frames: (preset, through the tree, width, height, spp, depth)
COMPACTED = (("final_full", True, 32, 24, 4, 6),
             ("random_spheres", False, 48, 32, 2, 8))
COMPACT_KEY, COMPACT_MIN = 5, 128


def instanced_scene(mod):
    """Instanced spheres (an ellipsoid, a rotated sphere, a world-space
    one) and instanced rects (rotated, composed, world-space), built by
    either package's build module."""
    b = mod.SceneBuilder()
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    b.sphere((0.0, 0.0, 0.0), 1.0, mat,
             transform=np.array([[2.0, 0, 0, 0], [0, 1.0, 0, 0.5],
                                 [0, 0, 0.5, -1.0]], np.float32))
    b.sphere((0.0, 0.0, 0.0), 0.7, b.metal((0.8, 0.8, 0.8), 0.1),
             transform=mod.affine_from_axis_angle((0.0, 1.0, 0.0), 90.0,
                                                  (1.5, 0.0, 0.0)))
    b.sphere((-1.5, 0.0, 0.0), 0.6, b.dielectric(1.5))
    b.rect_xy(-2.0, 2.0, -1.0, 1.0, 0.5, False, mat,
              transform=mod.affine_from_axis_angle((0.0, 1.0, 0.0), 90.0))
    b.rect_xz(-1.0, 1.0, -1.0, 1.0, 0.0, True, mat,
              transform=mod.affine_compose(
                  mod.affine_from_axis_angle((1.0, 0.0, 1.0), 30.0),
                  mod.affine_from_rotation_y_translation(10.0, (0, 0.3, 0))))
    b.rect_yz(-1.0, 1.0, -1.0, 1.0, -1.0, False, mat)
    return b.finish()


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def scene_rays(name: str, n: int = N_RAYS, seed: int = 7):
    """(ro, rd, time, media uniforms [n, n_media]) made with numpy: half
    camera rays of the preset's camera, half from points along camera
    rays (up to 1.5x the focus distance) in random directions; the
    instanced scene's from around (0, 1, 5) towards -z."""
    rng = np.random.default_rng(seed)
    if name == "instanced":
        ro = (rng.standard_normal((n, 3)) * 0.3 + [0.0, 1.0, 5.0]).astype(
            np.float32)
        rd = _unit(rng.standard_normal((n, 3)) * 0.5 + [0.0, -0.1, -1.0])
        tm = rng.random(n, dtype=np.float32)
        return ro, rd, tm, np.zeros((n, 1), np.float32)
    scene, cam = presets.from_name(name, ASPECT, seed=0)
    o, ll, h, v = (x.numpy().astype(np.float32) for x in (
        cam.origin, cam.lower_left_corner, cam.horizontal, cam.vertical))
    half = n // 2
    s, t = rng.random(half, dtype=np.float32), rng.random(half, dtype=np.float32)
    d1 = ll[None] + s[:, None] * h[None] + t[:, None] * v[None] - o[None]
    s2 = rng.random(n - half, dtype=np.float32)
    t2 = rng.random(n - half, dtype=np.float32)
    c2 = _unit(ll[None] + s2[:, None] * h[None] + t2[:, None] * v[None]
               - o[None])
    depth = (rng.random(n - half, dtype=np.float32) * 1.5
             * np.linalg.norm(ll + 0.5 * h + 0.5 * v - o)).astype(np.float32)
    ro = np.concatenate([np.broadcast_to(o, (half, 3)),
                         o[None] + depth[:, None] * c2]).astype(np.float32)
    rd = _unit(np.concatenate([d1, rng.standard_normal((n - half, 3))]))
    tm = rng.random(n, dtype=np.float32)
    med_u = rng.random((n, scene.media.count), dtype=np.float32)
    return ro, rd, tm, med_u


def port_scene(name: str):
    if name == "instanced":
        return instanced_scene(pbuild)
    return presets.from_name(name, ASPECT, seed=0)[0]


@pytest.fixture(scope="module")
def ref():
    return np.load(FIXTURE)


def _tree_arrays(flat):
    return {k: getattr(flat, k) for k in ("bb_min", "bb_max", "escape", "prim")}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", ["native-sah", "numpy-sah", "numpy-median"])
@pytest.mark.parametrize("name", TREE_SCENES)
def test_tree_equals_jax(ref, name, build):
    backend, strategy = build.split("-")
    mn, mx, mask, offsets = pbvh.scene_aabbs(port_scene(name))
    assert tuple(ref[f"offsets.{name}"]) == offsets
    seed = 1 if strategy == "median" else 0
    flat, stats = pbvh.build_flat_bvh(mn, mx, mask=mask, seed=seed,
                                      use_native=backend == "native",
                                      strategy=strategy)
    assert flat.builder == backend
    for k, v in _tree_arrays(flat).items():
        np.testing.assert_array_equal(v, ref[f"tree.{name}.{strategy}.{k}"],
                                      err_msg=f"{name} {build} {k}")
    assert (stats.node_count, stats.leaf_count, stats.max_depth) == tuple(
        ref[f"tree.{name}.{strategy}.stats"])


@pytest.mark.parametrize("strategy", ["median", "sah"])
@pytest.mark.parametrize("name", TREE_SCENES)
def test_stats(name, strategy):
    """The twin of tests/test_bvh.py's TestBuild.test_stats and
    test_escape_indices_well_formed, on the whole-scene tree."""
    scene = port_scene(name)
    mn, mx, mask, _ = pbvh.scene_aabbs(scene)
    flat, stats = pbvh.build_flat_bvh(mn, mx, mask=mask, seed=1,
                                      use_native=False, strategy=strategy)
    n = int(mask.sum())
    assert stats.leaf_count == n and stats.node_count == 2 * n - 1
    assert stats.max_depth <= 2 * int(np.ceil(np.log2(n))) + 2
    M = flat.n_nodes
    assert np.all(flat.escape > np.arange(M)) and flat.escape.max() <= M
    leaves = flat.prim >= 0
    np.testing.assert_array_equal(flat.escape[leaves], np.arange(M)[leaves] + 1)
    np.testing.assert_array_equal(np.sort(flat.prim[leaves]),
                                  np.nonzero(mask)[0])


def test_native_builds_outside_native_dir():
    """The native library lands in the port's build directory; the
    source directory gains nothing."""
    before = sorted(os.listdir(native.SOURCE.parent))
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parent == _cuda_build.BUILD_ROOT.parent
    assert sorted(os.listdir(native.SOURCE.parent)) == before


def test_empty_scene_raises():
    scene = port_scene("final")
    with pytest.raises(ValueError, match="empty primitive set"):
        pbvh.build_scene_bvh(scene)


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _traverse(name, use_native=True):
    scene = port_scene(name)
    feats = SceneFeatures.from_scene(scene)
    flat, _, offsets = pbvh.build_scene_bvh(scene, use_native=use_native)
    ro, rd, tm, med_u = scene_rays(name)
    t, gid = pbvh.bvh_scene_nearest(
        flat, scene, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(tm), torch.from_numpy(med_u), features=feats,
        offsets=offsets)
    return scene, feats, flat, offsets, t.numpy(), gid.numpy()


def _assert_matches(t, gid, t_ref, gid_ref, what):
    hit, hit_ref = t < 1e30, t_ref < 1e30
    np.testing.assert_array_equal(hit, hit_ref, err_msg=f"{what}: hit mask")
    close = np.isclose(t[hit], t_ref[hit], rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.999, (
        f"{what}: {int((~close).sum())} of {close.size} hits' t apart")
    assert (gid[hit] == gid_ref[hit]).mean() >= 0.999, what


@pytest.mark.parametrize("name", TRAV_SCENES)
def test_traversal_matches_jax(ref, name):
    _, _, _, _, t, gid = _traverse(name)
    _assert_matches(t, gid, ref[f"trav.{name}.t"], ref[f"trav.{name}.gid"],
                    name)
    assert (t < 1e30).mean() > 0.1  # the rays do hit the scene


@pytest.mark.parametrize("name", TRAV_SCENES)
def test_traversal_matches_brute_sweep(name):
    """The tree's winners against the port's per-kind sweep (the fast
    path's closest hit: K1 or K3 and the plane loops; the general path's
    object-space branch for the instanced scene), the tree's global ids
    through the table map."""
    scene, feats, flat, offsets, t, gid = _traverse(name)
    ro, rd, tm, med_u = scene_rays(name)
    if name == "instanced":  # no fast path: the general path's sweep
        from pathtrace_tpu_torch.ops import intersect as isect

        rec = isect.intersect_scene(scene, torch.from_numpy(ro),
                                    torch.from_numpy(rd), torch.from_numpy(tm),
                                    None, None, feats)
        t_b = rec.t.numpy()
        hit = t_b < 1e30
        np.testing.assert_array_equal(t < 1e30, hit)
        np.testing.assert_allclose(t[hit], t_b[hit], rtol=1e-3, atol=1e-4)
        return
    st = fp.make_state(torch.from_numpy(ro), torch.from_numpy(rd),
                       torch.from_numpy(tm))
    brute = fp.prep_tables(scene, feats)
    tree = fp.prep_tables(scene, feats, bvh=flat, bvh_offsets=offsets)
    t_b, idx_b = (x.numpy() for x in fp.closest_hit(brute, st, 0, feats, 5))
    t_v, idx_v = (x.numpy() for x in fp.closest_hit(tree, st, 0, feats, 5))
    hit, hit_b = t_v < 1e30, t_b < 1e30
    np.testing.assert_array_equal(hit, hit_b)
    apart = ~lane_close(t_v[hit], t_b[hit])
    assert apart.mean() <= 0.005, f"{name}: {int(apart.sum())} t apart"
    assert (idx_v[hit] == idx_b[hit]).mean() >= 0.999


@pytest.mark.parametrize("name", ["random_spheres", "random"])
def test_sphere_nearest_matches_jax(ref, name):
    """``bvh_sphere_nearest`` (the sphere-only tree, numpy SAH) against
    JAX's: the twins of test_matches_brute_force and test_moving_spheres."""
    scene = port_scene(name)
    mn, mx = pbvh.sphere_aabbs(scene.spheres)
    flat, _ = pbvh.build_flat_bvh(mn, mx, mask=scene.spheres.mask.numpy(),
                                  seed=1, use_native=False, strategy="sah")
    ro, rd, tm, _ = scene_rays(name)
    t, idx = pbvh.bvh_sphere_nearest(
        flat, scene.spheres, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(tm), has_motion=name == "random")
    _assert_matches(t.numpy(), idx.numpy(), ref[f"sph.{name}.t"],
                    ref[f"sph.{name}.idx"], name)


def test_traversal_chunks_bit_equal():
    """A ray's result does not depend on the rays beside it: traversing
    the rays in four chunks gives the whole set's bits (the property the
    reference's straggler slicing rests on), and the plain version visits
    at most every node once a ray."""
    scene = port_scene("final_full")
    feats = SceneFeatures.from_scene(scene)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    op = flat.operand(scene, feats, offsets, "cpu")
    ro, rd, tm, med_u = (torch.from_numpy(x) for x in scene_rays("final_full"))
    rays = torch.cat([ro.T, rd.T]).contiguous()
    flights = bvh_kernel.media_flights(op, med_u.T)
    t, gid, visits, tests = bvh_kernel.bvh_traverse_plain(
        op, rays, tm, flights, stats=True)
    assert int(visits.max()) <= flat.n_nodes and int(visits.min()) >= 1
    assert sum(int(v.sum()) for v in tests.values()) > 0
    for k in range(4):
        sl = slice(k * 1024, (k + 1) * 1024)
        tc, gc = bvh_kernel.bvh_traverse_plain(
            op, rays[:, sl].contiguous(), tm[sl], flights[:, sl].contiguous())
        assert torch.equal(tc, t[sl]) and torch.equal(gc, gid[sl])


# ---------------------------------------------------------------------------
# the fast path's table map and frames
# ---------------------------------------------------------------------------

def _kind_local(rows, blocks):
    """(kind, local id) of table rows under a table's block starts
    (sphere 0, then ``blocks`` = rect, box, medium starts)."""
    kind = np.zeros_like(rows)
    start = np.zeros_like(rows)
    for k, b in enumerate(blocks, start=1):
        at = rows >= b
        kind = np.where(at, k, kind)
        start = np.where(at, b, start)
    return kind, rows - start


@pytest.mark.parametrize("name", [n for n in presets.names() if n != "final"])
def test_gid_map_matches_jax(ref, name):
    """Every global id of the preset: the port's row names the primitive
    JAX's row names. The port's table has no rect, box or medium block in
    a scene without that kind (JAX's always has a 128-row rect block), so
    the rows are decoded by each table's blocks; an id of a kind the port
    has no block for is a masked padding entry, never in the tree."""
    scene = port_scene(name)
    feats = SceneFeatures.from_scene(scene)
    _, _, mask, offsets = pbvh.scene_aabbs(scene)
    gid = torch.arange(mask.shape[0], dtype=torch.int32)
    rows = fp.table_rows(scene, feats)
    port = fp._gid_to_table_row(gid, offsets, rows).numpy()
    jax_rows = ref[f"gid.{name}.row"]
    assert jax_rows.shape == port.shape
    kind = np.searchsorted(np.asarray(offsets[1:]), gid.numpy(), side="right")
    has = np.array([True, feats.has_rects, feats.has_boxes, feats.has_media])
    covered = has[kind]
    assert not mask[~covered].any()
    pk, pl = _kind_local(port, (rows.rect, rows.box, rows.media))
    jk, jl = _kind_local(jax_rows, tuple(ref[f"gid.{name}.blocks"]))
    np.testing.assert_array_equal(pk[covered], kind[covered])
    np.testing.assert_array_equal(jk[covered], kind[covered])
    np.testing.assert_array_equal(pl[covered], jl[covered])
    if feats.has_rects:  # then the blocks coincide: the rows themselves
        np.testing.assert_array_equal(port[covered], jax_rows[covered])


def _bvh_frame(name, bvh: bool):
    scene, cam = presets.from_name(name, 2.0, seed=0)
    feats = SceneFeatures.from_scene(scene)
    kw = {}
    if bvh:
        flat, _, offsets = pbvh.build_scene_bvh(scene)
        kw = dict(bvh=flat, bvh_offsets=offsets)
    f = FRAME
    return fp.render_frame_fast(scene, cam, f["width"], f["height"],
                                f["samples"], f["depth"], PRNGKey(f["key"]),
                                f["seed"], feats, **kw)


def _pixel_budget(samples: int) -> float:
    return 1.0 - (1.0 - DEPTH10_BUDGET) ** samples


@pytest.mark.parametrize("name", FRAME_SCENES)
def test_bvh_fast_frame_matches_jax_and_brute(ref, name):
    """The ``-B`` fast frame against JAX's (the per-pixel budget) and
    against the port's brute frame (test_bvh_wide.py's bounds)."""
    before = bvh_kernel.PLAIN_CALLS
    res = _bvh_frame(name, True)
    assert bvh_kernel.PLAIN_CALLS > before  # the tree was the closest hit
    img = res.image.numpy()
    golden = ref[f"frame.{name}.img"]
    outside = ~lane_close(img, golden).all(axis=-1)
    assert outside.mean() <= _pixel_budget(FRAME["samples"]), (
        f"{name}: {int(outside.sum())} pixels outside 1e-3")
    rays_ref = int(ref[f"frame.{name}.rays"])
    assert abs(int(res.ray_count) - rays_ref) <= 0.01 * rays_ref
    brute = _bvh_frame(name, False)
    diff = np.abs(img - brute.image.numpy())
    assert diff.mean() < 1e-3
    assert (diff < 1e-3).mean() > 0.98
    rb = int(brute.ray_count)
    assert abs(int(res.ray_count) - rb) <= max(rb, 1) * 0.01


def test_nee_shadow_rays_through_tree():
    """NEE's shadow rays go through the tree on a media scene (draws
    ``8 + n_media + j``): the occlusion distances equal the brute sweep's
    to the traversal's bound, the image stays within the brute frame's."""
    scene, cam = presets.from_name("cornell_smoke", 2.0, seed=0)
    feats = SceneFeatures.from_scene(scene)
    from pathtrace_tpu_torch.ops.lights import build_light_table

    lights = build_light_table(scene)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    kw = dict(nee_lights=lights, rr_start=3)
    a = fp.render_frame_fast(scene, cam, 48, 32, 2, 6, PRNGKey(1), 77, feats,
                             bvh=flat, bvh_offsets=offsets, **kw)
    b = fp.render_frame_fast(scene, cam, 48, 32, 2, 6, PRNGKey(1), 77, feats,
                             **kw)
    diff = np.abs(a.image.numpy() - b.image.numpy())
    assert (diff < 1e-3).mean() > 0.98
    assert int(a.ray_count) == pytest.approx(int(b.ray_count), rel=0.01)


def test_trace_fast_diff_refuses_bvh():
    scene, _ = presets.from_name("random_spheres", 1.0, seed=0)
    feats = SceneFeatures.from_scene(scene)
    flat, _, _ = pbvh.build_scene_bvh(scene)
    ro = torch.zeros((4, 3))
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    with pytest.raises(ValueError, match="not differentiable"):
        fp.trace_fast_diff(scene, ro, rd, torch.zeros(4), 0, 2, feats,
                           bvh=flat)


# ---------------------------------------------------------------------------
# the general path: intersect_fn and --mode compacted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", COMPACTED, ids=lambda c: c[0])
def test_compacted_frame_matches_jax(ref, case):
    name, tree, w, h, spp, depth = case
    scene, cam = presets.from_name(name, w / h, seed=0)
    feats = SceneFeatures.from_scene(scene)
    fn = None
    if tree:
        flat, _, offsets = pbvh.build_scene_bvh(scene)
        fn = pbvh.make_bvh_intersect_fn(flat, offsets, feats)
    before = bvh_kernel.PLAIN_CALLS
    img, count = render_frame_compacted(scene, cam, w, h, spp, depth,
                                        PRNGKey(COMPACT_KEY), features=feats,
                                        intersect_fn=fn, min_size=COMPACT_MIN)
    assert (bvh_kernel.PLAIN_CALLS > before) == tree
    golden = ref[f"compacted.{name}.img"]
    outside = ~lane_close(img.numpy(), golden).all(axis=-1)
    if tree:
        budget = _pixel_budget(spp)
    else:  # the same frame with its slots fixed (no compaction)
        fixed, _ = render_frame_compacted(
            scene, cam, w, h, spp, depth, PRNGKey(COMPACT_KEY),
            features=feats, min_size=w * h * spp)
        budget = (~lane_close(fixed.numpy(), golden).all(axis=-1)).mean()
        assert budget > 2 * _pixel_budget(spp)  # the slots do matter here
        budget /= 2
    assert outside.mean() <= budget, (
        f"{name}: {int(outside.sum())} pixels outside 1e-3")
    rays_ref = int(ref[f"compacted.{name}.rays"])
    assert abs(count - rays_ref) <= 0.01 * rays_ref


def test_general_frame_through_tree_matches_sweep():
    """``render_frame(intersect_fn=...)`` (``--mode general -B``, NEE and
    roulette: the shadow rays through the tree too) against the sweep."""
    scene, cam = presets.from_name("cornell_smoke", 1.5, seed=0)
    feats = SceneFeatures.from_scene(scene)
    from pathtrace_tpu_torch.ops.lights import build_light_table

    lights = build_light_table(scene)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    fn = pbvh.make_bvh_intersect_fn(flat, offsets, feats)
    kw = dict(features=feats, nee_lights=lights, rr_start=3)
    a, ca = render_frame(scene, cam, 36, 24, 2, 6, PRNGKey(2),
                         intersect_fn=fn, **kw)
    b, cb = render_frame(scene, cam, 36, 24, 2, 6, PRNGKey(2), **kw)
    assert (~lane_close(a.numpy(), b.numpy()).all(axis=-1)).mean() <= 0.02
    assert int(ca) == pytest.approx(int(cb), rel=0.01)


# ---------------------------------------------------------------------------
# the CLI and the wrapper's device rule
# ---------------------------------------------------------------------------

def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(["--device", "cpu", "-W", "24", "-H", "16", "-S", "1",
                       "-D", "3", "-O", *argv])
    return rc, out.getvalue(), err.getvalue()


def test_cli_bvh_and_compacted(tmp_path):
    out = str(tmp_path / "o.npy")
    rc, text, _ = _cli("-P", "random_spheres", "-B", "--out", out)
    assert rc == 0
    assert "render path: fast (--mode auto, intersect: bvh)" in text
    assert "bvh stats: BVHStats(node_count=975, leaf_count=488" in text
    assert np.isfinite(np.load(out)).all()
    rc, text, _ = _cli("-P", "final_full", "-B", "--out", out)
    assert rc == 0
    assert "render path: compacted (--mode auto, intersect: bvh)" in text
    assert "the fast path refuses the scene" in text
    assert "(compacted path, bvh)" in text
    rc, text, _ = _cli("-P", "small", "--mode", "compacted", "--out", out)
    assert rc == 0 and "render path: compacted (--mode compacted, " \
                       "intersect: sweep)" in text
    rc, text, _ = _cli("-P", "small", "--mode", "general", "-B", "--out", out)
    assert rc == 0 and "(general path, bvh)" in text
    rc, _, err = _cli("-P", "final", "-B", "--out", out)
    assert rc == 2 and "cannot build BVH over empty primitive set" in err
    rc, text, _ = _cli("-P", "small", "--mode", "sharded", "--out", out)
    assert rc == 0 and "render path: sharded (--mode sharded" in text
    assert "(sharded path, sweep)" in text and np.isfinite(np.load(out)).all()


def test_no_plain_fallback_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: with the
    kernel library's loader failing, the launch path raises and the plain
    version does not run; a device that is neither raises too."""
    scene = port_scene("cornell_smoke")
    feats = SceneFeatures.from_scene(scene)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    op = flat.operand(scene, feats, offsets, "cpu")
    ro, rd, tm, med_u = (torch.from_numpy(x) for x in
                         scene_rays("cornell_smoke", 64))
    rays = torch.cat([ro.T, rd.T]).contiguous()
    flights = bvh_kernel.media_flights(op, med_u.T)

    def broken():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda_build, "library", broken)
    before = bvh_kernel.PLAIN_CALLS
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bvh_kernel._launch(op, rays, tm, flights, 0.001, 3.4e38, False)
    assert bvh_kernel.PLAIN_CALLS == before
    meta = rays.to("meta")
    op_meta = op._replace(nodes=op.nodes.to("meta"),
                          prims=op.prims.to("meta"),
                          density=op.density.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        bvh_kernel.bvh_traverse(op_meta, meta, tm.to("meta"),
                                flights.to("meta"))
    assert bvh_kernel.PLAIN_CALLS == before


# ---------------------------------------------------------------------------
# the fixture (JAX, CPU)
# ---------------------------------------------------------------------------

def write_fixture(path: str = FIXTURE) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pathtrace_tpu.models import build as jbuild
    from pathtrace_tpu.models import bvh as jbvh
    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops import fastpath as jfp
    from pathtrace_tpu.render.compaction import (
        render_frame_compacted as j_compacted,
    )

    out = {}

    def jscene(name, aspect=ASPECT):
        if name == "instanced":
            return instanced_scene(jbuild)
        return jpresets.from_name(name, aspect, seed=0)[0]

    for name in TREE_SCENES:
        mn, mx, mask, offsets = jbvh.scene_aabbs(jscene(name))
        out[f"offsets.{name}"] = np.asarray(offsets, np.int64)
        for strategy, seed in (("sah", 0), ("median", 1)):
            flat, st = jbvh.build_flat_bvh(mn, mx, mask=mask, seed=seed,
                                           use_native=False,
                                           strategy=strategy)
            for k in ("bb_min", "bb_max", "escape", "prim"):
                out[f"tree.{name}.{strategy}.{k}"] = np.asarray(getattr(flat, k))
            out[f"tree.{name}.{strategy}.stats"] = np.asarray(
                [st.node_count, st.leaf_count, st.max_depth], np.int64)
    for name in TRAV_SCENES:
        js = jscene(name)
        feats = JFeatures.from_scene(js)
        flat, _, offsets = jbvh.build_scene_bvh(js, seed=0, use_native=False)
        ro, rd, tm, med_u = scene_rays(name)
        t, gid = jbvh.bvh_scene_nearest(
            flat, js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm),
            jnp.asarray(med_u), features=feats, offsets=offsets)
        out[f"trav.{name}.t"], out[f"trav.{name}.gid"] = (np.asarray(t),
                                                          np.asarray(gid))
    for name in ("random_spheres", "random"):
        js = jscene(name)
        mn, mx = jbvh.sphere_aabbs(js.spheres)
        flat, _ = jbvh.build_flat_bvh(mn, mx, mask=js.spheres.mask, seed=1,
                                      use_native=False, strategy="sah")
        ro, rd, tm, _ = scene_rays(name)
        t, idx = jbvh.bvh_sphere_nearest(
            flat, js.spheres, jnp.asarray(ro), jnp.asarray(rd),
            jnp.asarray(tm), has_motion=name == "random")
        out[f"sph.{name}.t"], out[f"sph.{name}.idx"] = (np.asarray(t),
                                                        np.asarray(idx))
    for name in presets.names():
        if name == "final":
            continue
        js = jscene(name)
        feats = JFeatures.from_scene(js)
        _, _, mask, offsets = jbvh.scene_aabbs(js)
        (sph, _rect, box, _media), _, _ = jfp.prep_tables(js, feats)
        box_rows = box.shape[0] if box is not None else 0
        gid = jnp.arange(mask.shape[0], dtype=jnp.int32)
        out[f"gid.{name}.row"] = np.asarray(jfp._gid_to_table_row(
            gid, offsets, sph.shape[0], box_rows))
        out[f"gid.{name}.blocks"] = np.asarray(
            [sph.shape[0], sph.shape[0] + 128, sph.shape[0] + 128 + box_rows],
            np.int64)
    f = FRAME
    for name in FRAME_SCENES:
        js, jcam = jpresets.from_name(name, 2.0, seed=0)
        feats = JFeatures.from_scene(js)
        flat, _, offsets = jbvh.build_scene_bvh(js, seed=0, use_native=False)
        img, rays = jfp.render_frame_fast(
            js, jcam, f["width"], f["height"], f["samples"], f["depth"],
            jax.random.PRNGKey(f["key"]), f["seed"], feats, bvh=flat,
            bvh_offsets=offsets)
        out[f"frame.{name}.img"] = np.asarray(img)
        out[f"frame.{name}.rays"] = np.asarray(int(rays), np.int64)
    for name, tree, w, h, spp, depth in COMPACTED:
        js, jcam = jpresets.from_name(name, w / h, seed=0)
        feats = JFeatures.from_scene(js)
        fn = None
        if tree:
            flat, _, offsets = jbvh.build_scene_bvh(js, seed=0,
                                                    use_native=False)
            fn = jbvh.make_bvh_intersect_fn(flat, offsets, feats)
        img, rays = j_compacted(js, jcam, w, h, spp, depth,
                                jax.random.PRNGKey(COMPACT_KEY),
                                features=feats, intersect_fn=fn,
                                min_size=COMPACT_MIN)
        out[f"compacted.{name}.img"] = np.asarray(img)
        out[f"compacted.{name}.rays"] = np.asarray(int(rays), np.int64)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    write_fixture()
