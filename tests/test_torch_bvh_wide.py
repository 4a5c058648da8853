"""The port's wide-node BVH and interleaved compaction ladder on the CPU
against the JAX package (the twin of ``tests/test_bvh_wide.py``).

JAX's side is the committed fixture ``tests/goldens/torch_port_bvh_wide.npz``,
which this file's ``__main__`` writes (``PYTHONPATH=. python
tests/test_torch_bvh_wide.py``, JAX on the CPU at XLA's backend
optimisation level 0, ~1 min); the reference's ``wide_scene_nearest``
compiles a while-loop per scene, so no test runs it. It holds, for
``random_spheres``, ``random``, ``cornell``, ``cornell_smoke`` and
``simple_light`` (aspect 1, seed 0, JAX's numpy SAH tree, which the port's
trees equal): ``widen_flat_bvh``'s pack, and ``wide_scene_nearest``'s (t,
gid) on 2048 rays made as ``tests/test_bvh_wide.py:_rays`` makes them
(``PRNGKey(5)``; the media's uniforms from ``PRNGKey(9)``), rays stored.
At level 0 XLA rounds every operation as the port does, and the port's
(t, gid) equal JAX's bit for bit; its optimised build contracts the
sphere test's products into FMAs and parts on 8-503 of the 2048 rays'
t (the winners stay equal).

* The pack: the port's ``widen_flat_bvh`` equals JAX's bit for bit, the
  int columns compared as int32, at the default widths and at the others
  the card measured (``WIDTHS``: ``leaf_m`` 2 and 4 static, 2 moving; the
  fixture's ``pack.<scene>.m<leaf_m>``); on ``random_spheres`` (``leaf_m``
  8) it has at most a quarter of the flat tree's nodes. The operand's
  header (slots filled, leaf kind) agrees with the pack's ids.
* The plain traversal: bit for bit the port's flat traversal and the
  fixture's JAX (t, gid), from the port's tree at every width and from
  JAX's pack carried in by ``convert.wide_bvh_from_numpy``.
* The fast path: frames through the wide tree equal frames through the
  flat one bit for bit (64x32, 2 spp, depth 8), compaction changes no
  bit, and the general path's ``make_bvh_intersect_fn`` gives the same
  records with either tree.
* The interleaved ladder (``tests/test_bvh_wide.py::
  test_interleaved_ladder_bit_exact_with_bvh``'s twin, knobs patched as
  there): 2048 rays in chunks of 1024 equal the uncompacted trace bit for
  bit, segments included; with NEE and roulette too (each chunk flushes
  its lanes' radiance at its own compactions, and every flush here gives
  the same bits); readbacks stop at or below the count floor. A trace
  through either tree stays on one ladder above the chunk (where the
  reference interleaves it: the card measured that slower) and equals
  its uncompacted trace.
* Refusal: an instanced scene raises.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.models import bvh as pbvh  # noqa: E402
from pathtrace_tpu_torch.models import build as pbuild  # noqa: E402
from pathtrace_tpu_torch.models import convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import _cuda_build, bvh_kernel  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as fp  # noqa: E402
from pathtrace_tpu_torch.ops.lights import build_light_table  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_bvh_wide.npz")
SCENES = ("random_spheres", "random", "cornell", "cornell_smoke",
          "simple_light")
FRAME_SCENES = ("random_spheres", "simple_light", "cornell_smoke")
N_RAYS = 2048
# the widths the card measured beside each scene's default
WIDTHS = {"random_spheres": (2, 4), "random": (2,)}
# (scene, leaf_m) cases: each scene at its default width (None), then the
# widths above; the default cases keep the scene's name as their id
WIDTH_CASES = ([pytest.param(n, None, id=n) for n in SCENES]
               + [pytest.param(n, m, id=f"{n}-m{m}")
                  for n, ms in WIDTHS.items() for m in ms])


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(FIXTURE))


def _scene(name, aspect=1.0):
    scene, cam = presets.from_name(name, aspect, seed=0)
    return scene, cam, SceneFeatures.from_scene(scene)


@functools.lru_cache(maxsize=None)
def _trees(name, leaf_m=None):
    scene, _, feats = _scene(name)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    wide = pbvh.widen_flat_bvh(flat, scene, offsets, features=feats,
                               leaf_m=leaf_m)
    return scene, feats, flat, wide, offsets


def _pack_key(name, leaf_m):
    return f"pack.{name}" if leaf_m is None else f"pack.{name}.m{leaf_m}"


def _rays(ref, name):
    ro, rd, tm = (torch.from_numpy(ref[f"rays.{k}"]) for k in ("ro", "rd",
                                                              "tm"))
    key = f"med_u.{name}"
    return ro, rd, tm, (torch.from_numpy(ref[key]) if key in ref else None)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,leaf_m", WIDTH_CASES)
def test_pack_equals_jax(ref, name, leaf_m):
    _, _, _, wide, _ = _trees(name, leaf_m)
    assert wide.leaf_m == (int(ref[f"leaf_m.{name}"]) if leaf_m is None
                           else leaf_m)
    assert wide.has_motion == bool(ref[f"has_motion.{name}"])
    np.testing.assert_array_equal(_bits(wide.pack.numpy()),
                                  _bits(ref[_pack_key(name, leaf_m)]))


@pytest.mark.parametrize("name,leaf_m", WIDTH_CASES)
def test_operand_header_agrees_with_pack(name, leaf_m):
    """The operand's header columns 2-3: a leaf's filled slots (its ids
    >= 0, a prefix) and its kind (its first id's, by the offsets); 0 and
    -1 at an inner node."""
    scene, feats, _, wide, offsets = _trees(name, leaf_m)
    op = wide.operand(scene, feats, offsets, "cpu")
    head = op.nodes.view(torch.int32)[:, :4].numpy()
    p = wide.pack.numpy().view(np.int32)
    ids = p[:, 2:2 + wide.leaf_m]
    leaf = p[:, 0] < 0
    np.testing.assert_array_equal(head[:, :2], p[:, :2])
    filled = (ids >= 0).sum(axis=1)
    np.testing.assert_array_equal(head[leaf, 2], filled[leaf])
    # the filled slots are a prefix
    assert ((ids[leaf] >= 0)
            == (np.arange(wide.leaf_m) < filled[leaf, None])).all()
    _, off_r, off_b, off_m = offsets
    g = ids[leaf, 0]
    kind = np.where(g < off_r, bvh_kernel.WIDE_KIND_SPHERE,
                    np.where(g < off_b, bvh_kernel.WIDE_KIND_RECT,
                             np.where(g < off_m, bvh_kernel.WIDE_KIND_BOX,
                                      bvh_kernel.WIDE_KIND_MEDIUM)))
    np.testing.assert_array_equal(head[leaf, 3], kind)
    # a leaf of another kind holds one primitive
    assert (head[leaf, 2][kind != bvh_kernel.WIDE_KIND_SPHERE] == 1).all()
    assert (head[~leaf, 2] == 0).all() and (head[~leaf, 3] == -1).all()


def test_collapses_nodes():
    _, _, flat, wide, _ = _trees("random_spheres")
    assert wide.leaf_m == 8
    assert wide.n_nodes * 4 <= flat.n_nodes


def test_leaf_m_defaults_and_escapes():
    """8 slots static, 4 with motion, 1 without spheres; escapes as the
    reference's: a leaf's is the next row, an inner row's the row after
    its subtree, the root's the row count."""
    for name, m in (("random_spheres", 8), ("random", 4), ("cornell", 1)):
        _, _, _, wide, _ = _trees(name)
        assert wide.leaf_m == m
        p = wide.pack.numpy().view(np.int32)
        nav, esc = p[:, 0], p[:, 1]
        M = wide.n_nodes
        assert esc[0] == M
        leaf = nav < 0
        np.testing.assert_array_equal(esc[leaf], np.nonzero(leaf)[0] + 1)
        inner = np.nonzero(~leaf)[0]
        # the right child starts where the left child's subtree ends
        np.testing.assert_array_equal(nav[inner], esc[inner + 1])
        np.testing.assert_array_equal(esc[inner], esc[nav[inner]])


# ---------------------------------------------------------------------------
# the plain traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,leaf_m", WIDTH_CASES)
def test_plain_traversal_equals_flat_and_jax(ref, name, leaf_m):
    scene, feats, flat, wide, offsets = _trees(name, leaf_m)
    ro, rd, tm, med_u = _rays(ref, name)
    before = bvh_kernel.WIDE_PLAIN_CALLS
    t_w, g_w = pbvh.bvh_scene_nearest(wide, scene, ro, rd, tm, med_u,
                                      features=feats, offsets=offsets)
    assert bvh_kernel.WIDE_PLAIN_CALLS == before + 1
    t_f, g_f = pbvh.bvh_scene_nearest(flat, scene, ro, rd, tm, med_u,
                                      features=feats, offsets=offsets)
    np.testing.assert_array_equal(_bits(t_w), _bits(t_f))
    np.testing.assert_array_equal(g_w.numpy(), g_f.numpy())
    np.testing.assert_array_equal(_bits(t_w), _bits(ref[f"t.{name}"]))
    np.testing.assert_array_equal(g_w.numpy(), ref[f"gid.{name}"])
    assert (t_w < 1e30).float().mean() > 0.2


@pytest.mark.parametrize("name", SCENES)
def test_jax_pack_carried_in(ref, name):
    """JAX's pack through ``wide_bvh_from_numpy`` traverses to JAX's (t,
    gid); the operand keeps the int columns' bits (-1 is a NaN pattern
    in a float column)."""
    scene, feats, _, _, offsets = _trees(name)
    wide = convert.wide_bvh_from_numpy(
        ref[f"pack.{name}"], int(ref[f"leaf_m.{name}"]),
        bool(ref[f"has_motion.{name}"]), device="cpu")
    op = wide.operand(scene, feats, offsets, "cpu")
    nodes_i = op.nodes.view(torch.int32)
    pack_i = _bits(ref[f"pack.{name}"])
    np.testing.assert_array_equal(nodes_i[:, :2].numpy(), pack_i[:, :2])
    leaf = pack_i[:, 0] < 0
    np.testing.assert_array_equal(nodes_i[leaf, 4:4 + wide.leaf_m].numpy(),
                                  pack_i[leaf, 2:2 + wide.leaf_m])
    ro, rd, tm, med_u = _rays(ref, name)
    t, gid = pbvh.bvh_scene_nearest(wide, scene, ro, rd, tm, med_u,
                                    features=feats, offsets=offsets)
    np.testing.assert_array_equal(_bits(t), _bits(ref[f"t.{name}"]))
    np.testing.assert_array_equal(gid.numpy(), ref[f"gid.{name}"])


def test_nan_rays_miss_and_stats():
    """A ray with a NaN misses every box and escapes, as in the
    reference; the plain version's counts feed the yardsticks."""
    scene, feats, flat, wide, offsets = _trees("random")
    op = wide.operand(scene, feats, offsets, "cpu")
    rng = np.random.default_rng(3)
    R = 256
    ro = torch.from_numpy((rng.random((R, 3)) * 8 - 4).astype(np.float32))
    d = rng.standard_normal((R, 3)).astype(np.float32)
    rd = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    ro[:16, 0] = float("nan")
    rd[16:32, 2] = float("nan")
    tm = torch.from_numpy(rng.random(R, dtype=np.float32))
    rays = torch.cat([ro.T, rd.T]).contiguous()
    t, gid, visits, tests = bvh_kernel.wide_traverse_plain(op, rays, tm,
                                                           stats=True)
    assert bool((t[:32] == fp.MAX_T).all()) and bool((gid[:32] == 0).all())
    t_f, g_f = bvh_kernel.bvh_traverse_plain(
        flat.operand(scene, feats, offsets, "cpu"), rays, tm)
    assert torch.equal(t, t_f) and torch.equal(gid, g_f)
    assert bool((visits[:32] == 1).all())  # the root, then its escape
    assert int(tests["inner"].sum() + tests["leaf"].sum()) == int(
        visits.sum())
    # a slot tested with a positive discriminant pays the whole test, one
    # without stops before the square root; both carry the lerp here
    assert int(tests["sphere"].sum()) > 0
    assert int(tests["sphere_miss"].sum()) > 0
    ys = bvh_kernel.wide_yardsticks(op, R, visits, tests)
    assert ys["bound_ms"] == max(ys["issue_ceiling_ms"], ys["bytes_ms"]) > 0
    lerp = bvh_kernel.OPS_WIDE_MOTION
    assert ys["operations"] == (
        bvh_kernel.OPS_WIDE_INNER * int(tests["inner"].sum())
        + bvh_kernel.OPS_WIDE_LEAF * int(tests["leaf"].sum())
        + (bvh_kernel.OPS_LEAF["sphere"] + lerp) * int(tests["sphere"].sum())
        + (bvh_kernel.OPS_WIDE_SLOT_MISS + lerp)
        * int(tests["sphere_miss"].sum()))


def test_instanced_scene_refused():
    b = pbuild.SceneBuilder()
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    b.sphere((0.0, 0.0, 0.0), 1.0, mat,
             transform=np.array([[2.0, 0, 0, 0], [0, 1.0, 0, 0.5],
                                 [0, 0, 0.5, -1.0]], np.float32))
    b.sphere((-1.5, 0.0, 0.0), 0.6, mat)
    scene = b.finish()
    with pytest.raises(ValueError, match="instanced"):
        pbvh.build_scene_wide_bvh(scene)


def test_no_plain_fallback_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper launches the wide kernel or raises."""
    scene, feats, _, wide, offsets = _trees("cornell_smoke")
    op = wide.operand(scene, feats, offsets, "cpu")
    rays = torch.zeros((6, 8))
    rays[5] = 1.0

    def broken():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda_build, "library", broken)
    before = bvh_kernel.WIDE_PLAIN_CALLS
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bvh_kernel._launch(op, rays, None, torch.zeros((1, 8)), 0.001,
                           3.4e38, False)
    assert bvh_kernel.WIDE_PLAIN_CALLS == before
    assert "pt_bvh_wide_traverse" in _cuda_build._SIGNATURES


# ---------------------------------------------------------------------------
# the fast path and the general provider
# ---------------------------------------------------------------------------

FRAME = dict(width=64, height=32, samples=2, depth=8, key=3, seed=12345)


@functools.lru_cache(maxsize=None)
def _frame(name, tree):
    """(image, segments) of the frame through the ``tree`` ("flat" or
    "wide"); 4096 rays, which the default ``min_size`` never compacts."""
    scene, cam, feats = _scene(name, 2.0)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    bvh = (flat if tree == "flat"
           else pbvh.widen_flat_bvh(flat, scene, offsets, features=feats))
    f = FRAME
    before = bvh_kernel.WIDE_PLAIN_CALLS
    res = fp.render_frame_fast(scene, cam, f["width"], f["height"],
                               f["samples"], f["depth"], PRNGKey(f["key"]),
                               f["seed"], feats, bvh=bvh,
                               bvh_offsets=offsets)
    assert (bvh_kernel.WIDE_PLAIN_CALLS > before) == (tree == "wide")
    return res.image.numpy(), int(res.ray_count)


@pytest.mark.parametrize("name", FRAME_SCENES)
def test_fast_frames_wide_equal_flat(name):
    a, ca = _frame(name, "wide")
    b, cb = _frame(name, "flat")
    np.testing.assert_array_equal(a, b)
    assert ca == cb


def test_compaction_bit_invariant_with_wide_tree(monkeypatch):
    """The wide tree's frame traced at ``min_size`` 128 (the ladder
    compacts at this size) equals the frame that never compacts."""
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    sizes = []
    compact = fp.compact_util.compact

    def spy(out, state, indices, next_size, identity=False):
        sizes.append(next_size)
        return compact(out, state, indices, next_size, identity)

    monkeypatch.setattr(fp.compact_util, "compact", spy)

    scene, cam, feats = _scene("random_spheres", 2.0)
    wide, _, offsets = pbvh.build_scene_wide_bvh(scene, features=feats)
    f = FRAME
    w, h, spp = f["width"], f["height"], f["samples"]
    ro, rd, tm = generate_primary_rays(cam, w, h, spp, PRNGKey(f["key"]))
    R = w * h * spp
    res = fp.trace_fast(scene, ro.reshape(R, 3), rd.reshape(R, 3),
                        tm.reshape(R), f["seed"], f["depth"], feats,
                        min_size=128, bvh=wide, bvh_offsets=offsets)
    assert sizes
    img = res.radiance.reshape(h, w, spp, 3).mean(dim=2).numpy()
    ref_img, ref_count = _frame("random_spheres", "wide")
    np.testing.assert_array_equal(img, ref_img)
    assert int(res.ray_count) == ref_count


@pytest.mark.parametrize("name", ["random", "cornell_smoke"])
def test_general_intersect_fn_same_records(ref, name):
    scene, feats, flat, wide, offsets = _trees(name)
    ro, rd, tm, med_u = _rays(ref, name)
    recs = [pbvh.make_bvh_intersect_fn(tree, offsets, feats)(
        scene, ro, rd, tm, med_u) for tree in (flat, wide)]
    for field in recs[0]._fields:
        x, y = getattr(recs[0], field), getattr(recs[1], field)
        if torch.is_tensor(x):
            assert torch.equal(x, y), field


def test_device_trace_mesh_and_progressive_take_the_wide_tree():
    """``trace_fast_device``, the mesh's fast shards (two virtual CPU
    shards) and ``render_progressive(bvh=...)`` accept a wide tree."""
    from pathtrace_tpu_torch.config import Params
    from pathtrace_tpu_torch.parallel import mesh as pmesh
    from pathtrace_tpu_torch.render.progressive import render_progressive

    scene, cam, feats = _scene("random_spheres", 2.0)
    wide, stats, offsets = pbvh.build_scene_wide_bvh(scene, features=feats)
    rng = np.random.default_rng(0)
    R = 256
    ro = torch.from_numpy(np.tile(cam.origin.numpy(), (R, 1)))
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    rd = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    tm = torch.zeros(R)
    dev_rad, dev_cnt = fp.trace_fast_device(scene, ro, rd, tm, 9, 4, feats,
                                            bvh=wide, bvh_offsets=offsets)
    res = fp.trace_fast(scene, ro, rd, tm, 9, 4, feats, compaction=False,
                        bvh=wide, bvh_offsets=offsets)
    assert torch.equal(dev_rad, res.radiance)
    assert int(dev_cnt) == int(res.ray_count)
    sh_rad, sh_cnt = pmesh.trace_sharded(
        scene, ro, rd, tm, None, 4, pmesh.make_render_mesh(["cpu", "cpu"]),
        features=feats, mode="fast", seed=9, bvh=wide, bvh_offsets=offsets)
    assert torch.equal(sh_rad, dev_rad) and int(sh_cnt) == int(dev_cnt)
    lines = []
    out = render_progressive(scene, cam, Params(width=16, height=8,
                                                samples=1, max_depth=3),
                             1, "cpu", log=lines.append,
                             bvh=(wide, stats, offsets))
    assert out.path == "fast" and np.isfinite(out.image).all()
    assert any("bvh stats" in line for line in lines)


# ---------------------------------------------------------------------------
# the interleaved ladder
# ---------------------------------------------------------------------------

def test_interleave_bounds():
    """Balanced chunks rounded up to 1024, as the reference's: a 1280x720
    x 4 frame in chunks of 2^21 is two of 1,843,200."""
    assert fp.interleave_bounds(3_686_400, 1 << 21) == [
        (0, 1_843_200), (1_843_200, 3_686_400)]
    assert fp.interleave_bounds(10_000, 2048) == [
        (0, 2048), (2048, 4096), (4096, 6144), (6144, 8192), (8192, 10_000)]
    assert fp.interleave_bounds(8192, 2048) == [
        (k * 2048, (k + 1) * 2048) for k in range(4)]


def _ladder_rays(n=8192, seed=31):
    rng = np.random.default_rng(seed)
    scene, cam, feats = _scene("random_spheres")
    o = cam.origin.numpy()
    ll, h, v = (x.numpy() for x in (cam.lower_left_corner, cam.horizontal,
                                    cam.vertical))
    s, t = rng.random((2, n), dtype=np.float32)
    d = ll[None] + s[:, None] * h[None] + t[:, None] * v[None] - o[None]
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ro = np.broadcast_to(o, (n, 3)).astype(np.float32)
    return (torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(rng.random(n, dtype=np.float32)))


LADDER_DEPTH = 4


def _spy_ladders(monkeypatch):
    """Record each ladder's call: ("interleaved", chunk sizes) or
    ("host", lanes)."""
    calls = []
    inter, host = fp._interleaved_ladder, fp._host_ladder

    def spy_inter(step, states, *a, **k):
        calls.append(("interleaved", [s.alive.shape[0] for s in states]))
        return inter(step, states, *a, **k)

    def spy_host(step, state, *a, **k):
        calls.append(("host", state.alive.shape[0]))
        return host(step, state, *a, **k)

    monkeypatch.setattr(fp, "_interleaved_ladder", spy_inter)
    monkeypatch.setattr(fp, "_host_ladder", spy_host)
    return calls


def test_interleaved_ladder_bit_exact(monkeypatch):
    scene, _, feats = _scene("random_spheres")
    ro, rd, tm = _ladder_rays(2048)
    b = fp.trace_fast(scene, ro, rd, tm, 5, LADDER_DEPTH, feats,
                      compaction=False)
    monkeypatch.setattr(fp, "INTERLEAVE_CHUNK", 1024)
    monkeypatch.setattr(fp, "COUNT_SKIP_SIZE", 256)
    calls = _spy_ladders(monkeypatch)
    sizes = []
    compact = fp.compact_util.compact

    def spy(out, state, indices, next_size, identity=False):
        sizes.append(next_size)
        return compact(out, state, indices, next_size, identity)

    monkeypatch.setattr(fp.compact_util, "compact", spy)
    a = fp.trace_fast(scene, ro, rd, tm, 5, LADDER_DEPTH, feats,
                      min_size=128)
    assert calls == [("interleaved", [1024, 1024])]
    assert a.readbacks > 0 and sizes
    np.testing.assert_array_equal(a.radiance.numpy(), b.radiance.numpy())
    assert int(a.ray_count) == int(b.ray_count)


@pytest.mark.parametrize("tree", ["flat", "wide"])
def test_bvh_trace_stays_on_one_ladder(tree, monkeypatch):
    """Above the chunk a trace through either tree runs one ladder, which
    compacts and equals its uncompacted trace bit for bit."""
    scene, feats, flat, wide, offsets = _trees("random_spheres")
    kw = dict(bvh=flat if tree == "flat" else wide, bvh_offsets=offsets)
    ro, rd, tm = _ladder_rays(1024)
    b = fp.trace_fast(scene, ro, rd, tm, 5, 2, feats, compaction=False, **kw)
    monkeypatch.setattr(fp, "INTERLEAVE_CHUNK", 512)
    calls = _spy_ladders(monkeypatch)
    a = fp.trace_fast(scene, ro, rd, tm, 5, 2, feats, min_size=128, **kw)
    assert calls == [("host", 1024)] and a.readbacks > 0
    np.testing.assert_array_equal(a.radiance.numpy(), b.radiance.numpy())
    assert int(a.ray_count) == int(b.ray_count)


def test_interleaved_ladder_with_nee(monkeypatch):
    """NEE and roulette under the interleaved ladder: the same paths and
    segments as the uncompacted trace, and radiance to the last bit of
    the flushes (measured: equal bits)."""
    scene, cam, feats = _scene("simple_light")
    lights = build_light_table(scene)
    ro, rd, tm = _ladder_rays(1024)
    ro = torch.from_numpy(np.tile(cam.origin.numpy(), (ro.shape[0], 1)))
    kw = dict(nee_lights=lights, rr_start=3)
    monkeypatch.setattr(fp, "INTERLEAVE_CHUNK", 512)
    monkeypatch.setattr(fp, "COUNT_SKIP_SIZE", 256)
    a = fp.trace_fast(scene, ro, rd, tm, 11, 4, feats, min_size=128, **kw)
    b = fp.trace_fast(scene, ro, rd, tm, 11, 4, feats, compaction=False,
                      **kw)
    assert a.readbacks > 0
    assert int(a.ray_count) == int(b.ray_count)
    np.testing.assert_array_equal(a.radiance.numpy(), b.radiance.numpy())


def test_readbacks_stop_at_the_count_floor(monkeypatch):
    """A chunk at or below the floor reads no count: with the floor at the
    chunk's size the ladder reads none and compacts nothing; with a lower
    one every read finds the chunk above the floor."""
    scene, _, feats = _scene("random_spheres")
    ro, rd, tm = _ladder_rays(2048)
    monkeypatch.setattr(fp, "INTERLEAVE_CHUNK", 1024)
    sizes = []
    compact = fp.compact_util.compact

    def spy(out, state, indices, next_size, identity=False):
        sizes.append((state.alive.shape[0], next_size))
        return compact(out, state, indices, next_size, identity)

    monkeypatch.setattr(fp.compact_util, "compact", spy)
    monkeypatch.setattr(fp, "COUNT_SKIP_SIZE", 1024)
    a = fp.trace_fast(scene, ro, rd, tm, 5, 4, feats, min_size=128)
    assert a.readbacks == 0 and sizes == []
    monkeypatch.setattr(fp, "COUNT_SKIP_SIZE", 256)
    b = fp.trace_fast(scene, ro, rd, tm, 5, 4, feats, min_size=128)
    assert b.readbacks > 0 and sizes
    # a compaction follows a read, and reads happen only above the floor
    assert all(size > 256 for size, _ in sizes)
    np.testing.assert_array_equal(a.radiance.numpy(), b.radiance.numpy())


# ---------------------------------------------------------------------------
# the fixture (JAX, CPU, XLA backend optimisation level 0)
# ---------------------------------------------------------------------------

def write_fixture(path: str = FIXTURE) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pathtrace_tpu.models import bvh as jbvh
    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures

    R = N_RAYS
    ro = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (R, 3)))
    ro = jnp.asarray(ro * 24 - 12, jnp.float32)
    d = jax.random.normal(jax.random.PRNGKey(6), (R, 3))
    rd = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tm = jax.random.uniform(jax.random.PRNGKey(7), (R,))
    out = {"rays.ro": np.asarray(ro), "rays.rd": np.asarray(rd),
           "rays.tm": np.asarray(tm)}
    for name in SCENES:
        js, _ = jpresets.from_name(name, aspect=1.0, seed=0)
        feats = JFeatures.from_scene(js)
        flat, _, offsets = jbvh.build_scene_bvh(js, seed=0, use_native=False)
        wide = jbvh.widen_flat_bvh(flat, js, offsets, features=feats)
        med_u = None
        if feats.has_media:
            med_u = jax.random.uniform(jax.random.PRNGKey(9),
                                       (R, js.media.count))
            out[f"med_u.{name}"] = np.asarray(med_u)
        t, gid = jbvh.wide_scene_nearest(wide, js, ro, rd, tm, med_u,
                                         features=feats, offsets=offsets)
        out[f"pack.{name}"] = np.asarray(wide.pack)
        for m in WIDTHS.get(name, ()):
            out[f"pack.{name}.m{m}"] = np.asarray(jbvh.widen_flat_bvh(
                flat, js, offsets, features=feats, leaf_m=m).pack)
        out[f"leaf_m.{name}"] = np.asarray(wide.leaf_m, np.int64)
        out[f"has_motion.{name}"] = np.asarray(wide.has_motion)
        out[f"t.{name}"], out[f"gid.{name}"] = np.asarray(t), np.asarray(gid)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    # XLA's backend optimisation level 0 (read when the backend starts):
    # its optimised CPU build contracts the sphere test's products into
    # FMAs, which the port (and the card, -fmad=false) does not
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")
    write_fixture()
