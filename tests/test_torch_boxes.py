"""Box scenes on the port's fast path against the JAX package (CPU).

* The builder: ``cornell`` and ``torch_port_util.mixed_scene`` (a box
  under ``affine_from_axis_angle`` composed with a rotation about y, an
  unrotated box, a sphere medium and a box medium) equal JAX's leaf for
  leaf; the converted JAX ``cornell`` equals the port's preset.
* The box sweep: the port's one form (the plane loop) against the
  reference's ``box_nearest_planes`` (t and idx bit for bit) and its
  [R, N] form ``box_nearest`` (idx equal; t within ``COLS_RTOL``: the
  [R, N] form maps the rays with an einsum that rounds in another order)
  at N = 2 (``cornell``) and N = 20, on camera rays, on rays from random
  points (some inside a box: the exit-face branch) and on rays with zero
  direction components.
* The box table (``build_box_table``) bit for bit JAX's.
* The plain K2 with ``FLAG_BOX`` against ``shade_bounce_planes`` (Pallas in
  interpret mode) over three bounces of ``cornell`` and of the mixed scene
  under the lane contract of tests/test_shade_pallas.py; the port's merged
  winners against JAX's; the normal and albedo rows of the
  ``FLAG_EMIT_SCALE`` output against JAX's ``_normal_planes`` and
  ``_albedo_planes``.
* A ray whose object-space direction has components exactly 0 (and -0):
  the box normal of both packages, entry and exit face.
* A rect winner of a box scene reads its own row of the winner table.
* The depth-10 ``trace_fast`` of ``cornell`` against the committed fixture
  ``tests/goldens/torch_port_cornell.npz`` (JAX's fused ``trace_fast`` on
  4096 camera rays, plain and, under ``nee.*``, with NEE and roulette from
  depth 3): radiance within 1e-3 with at most ``DEPTH10_BUDGET`` of the
  rays outside, compaction on and off; segment counts equal where no ray
  is outside. Measured on the CPU: 0 rays outside, segments equal.
  Regenerate the fixture with
  ``PYTHONPATH=. python tests/test_torch_boxes.py``.
* A one-ULP nudge of the fixture's directions: how far the estimator
  itself moves (none of the plain rays, 0.63% of the NEE ones), the room
  the card's trace needs against JAX's.
* The gates: the fast path, the CLI, ``trace_fast_diff`` and the trainer
  take ``cornell``; the megakernel refuses it with a ``ValueError``; the
  fast path refuses an image texture on a box.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import build as jbuild  # noqa: E402
from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu.ops import intersect as jisect  # noqa: E402
from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.models import build, convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_box, megakernel  # noqa: E402
from pathtrace_tpu_torch.ops import shade_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, PLANE_NAMES, assert_lanes_close, check_slice_contract,
    jax_camera_rays, jax_fused_state, jax_scene_leaves, jax_scene_winners,
    jax_shade_planes, lane_close, mixed_scene,
)

ASPECT = 16 / 9
FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_cornell.npz")
N_RAYS, SEED, MAX_DEPTH, UNIFORM_SEED, RR_START = 4096, 7, 10, 2025, 3
# t of the port's plane loop against the reference's [R, N] box sweep,
# whose einsum maps the rays to object space in another order: measured
# at most 3.8e-5 relative (rays parallel to an axis, 555-unit
# coordinates), 1.7e-5 on random rays, 2.6e-7 on camera rays
COLS_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _scenes(name):
    """(JAX scene, port scene) of ``cornell``, the mixed scene or twenty
    rotated boxes."""
    if name == "cornell":
        return jpresets.cornell(ASPECT)[0], presets.cornell(ASPECT)[0]
    if name == "mixed":
        return mixed_scene(jbuild), mixed_scene(build)
    out = []
    for mod in (jbuild, build):
        g = np.random.default_rng(5)
        b = mod.SceneBuilder()
        mat = b.lambertian_color((0.5, 0.5, 0.5))
        for _ in range(20):
            p0 = g.uniform(0.0, 400.0, 3)
            xf = mod.affine_from_axis_angle(g.normal(size=3),
                                            float(g.uniform(0.0, 90.0)),
                                            g.uniform(-50.0, 50.0, 3))
            b.box(p0, p0 + g.uniform(20.0, 120.0, 3), mat, xf)
        out.append(b.finish())
    return tuple(out)


def _rays(kind, n=2048, seed=11):
    """Camera rays of ``cornell``, rays from random points of the box in
    random directions, or rays with two direction components exactly 0."""
    if kind == "camera":
        ro, rd, _ = jax_camera_rays(jpresets.cornell(ASPECT)[1], n, seed=4)
        return ro, rd
    g = np.random.default_rng(seed)
    ro = g.uniform(0.0, 555.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    if kind == "parallel":
        d[:] = 0.0
        d[np.arange(n), np.arange(n) % 3] = np.where(np.arange(n) % 2, 1.0, -1.0)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


# ---------------------------------------------------------------------------
# the builder and the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "mixed", "twenty"])
def test_builder_equals_jax_leaf_for_leaf(name):
    jscene, scene = _scenes(name)
    ref = jax_scene_leaves(jscene)
    got = convert.scene_to_numpy(scene)
    assert set(got) == set(ref)
    for key, val in got.items():
        assert _bits_equal(ref[key], val), key
    if name == "cornell":
        conv = convert.scene_from_numpy(ref, device="cpu")
        for key, val in convert.scene_to_numpy(conv).items():
            assert _bits_equal(ref[key], val), key
        assert int(scene.boxes.mask.sum()) == 2
        assert not scene.media.mask.any() and not scene.spheres.mask.any()


@pytest.mark.parametrize("name", ["cornell", "mixed", "twenty"])
def test_box_table_bitwise(name):
    jscene, scene = _scenes(name)
    jfeat = JFeatures.from_scene(jscene)
    feats = SceneFeatures.from_scene(scene)
    assert feats._key() == jfeat._key() and feats.has_boxes
    k = tfp.attr_width(feats)
    assert k == jfp.attr_width(jfeat) == 48
    ref = np.asarray(jfp.build_box_table(jscene, k))
    got = tfp.build_box_table(scene, k).numpy()
    assert _bits_equal(ref, got)
    assert np.all(got[scene.boxes.mask.numpy(), 14] == 2.0)


# ---------------------------------------------------------------------------
# the box sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["camera", "random", "parallel"])
@pytest.mark.parametrize("name", ["cornell", "twenty"])
def test_box_sweep_equals_jax(name, kind):
    jscene, scene = _scenes(name)
    ro, rd = _rays(kind)
    planes = [*ro.T, *rd.T]
    t, idx = intersect_box.box_nearest(scene.boxes, *(_t(p) for p in planes))
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    t_ref, i_ref = jisect.box_nearest_planes(
        jscene.boxes, *(jnp.asarray(p) for p in planes))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    t_cols, i_cols = jisect.box_nearest(jscene.boxes, jnp.asarray(ro),
                                        jnp.asarray(rd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_cols))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_cols), rtol=COLS_RTOL)
    assert (t.numpy() < 1e30).mean() > 0.05


def test_box_sweep_from_inside_takes_the_exit_face():
    """Rays from each box's centre: every one hits its own box at the exit
    distance (the slab's t_exit), in both packages."""
    jscene, scene = _scenes("twenty")
    g = np.random.default_rng(3)
    wfo = scene.boxes.world_from_obj.numpy()
    mid = 0.5 * (scene.boxes.p0.numpy() + scene.boxes.p1.numpy())
    centres = np.einsum("nij,nj->ni", wfo[:, :, :3], mid) + wfo[:, :, 3]
    ro = np.repeat(centres, 64, axis=0).astype(np.float32)
    d = g.normal(size=ro.shape)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    planes = [*ro.T, *rd.T]
    t, idx = intersect_box.box_nearest(scene.boxes, *(_t(p) for p in planes))
    t_ref, i_ref = jisect.box_nearest_planes(
        jscene.boxes, *(jnp.asarray(p) for p in planes))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    own = np.repeat(np.arange(20), 64)
    # boxes overlap: a ray may leave through a nearer face of another box
    assert (idx.numpy() == own).mean() > 0.8
    assert (t.numpy() < 1e30).all()


def test_dead_boxes_never_hit():
    _, scene = _scenes("cornell")
    ro, rd = _rays("camera", 512)
    planes = [_t(p) for p in (*ro.T, *rd.T)]
    t, _ = intersect_box.box_nearest(scene.boxes, *planes)
    assert (t < 1e30).any()
    scene.boxes.mask[:] = False
    t, idx = intersect_box.box_nearest(scene.boxes, *planes)
    assert (t.numpy() == np.float32(3.402823466e38)).all()
    assert (idx == 0).all()


# ---------------------------------------------------------------------------
# K2's box branch, the merge and the NEE rows
# ---------------------------------------------------------------------------

def _camera_state(name, n, seed):
    cam = jpresets.cornell(ASPECT)[1] if name == "cornell" else \
        jpresets.small(ASPECT)[1]
    ro, rd, tm = jax_camera_rays(cam, n, seed=seed)
    if name == "mixed":
        # the small camera looks at -z from (3, 3, 2): move it back
        ro = ro + np.float32([3.0, 1.0, 4.0])
    return ro, rd, tm


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_k2_box_branch_and_merge_match_jax(name):
    """Three bounces: the port's merged winners equal JAX's (t to 1e-3
    under the lane contract, idx on 99.5% of lanes), the plain K2 with
    ``FLAG_BOX`` (and ``FLAG_MEDIUM`` in the mixed scene) on JAX's winners
    holds the lane contract against ``shade_bounce_planes``, and the normal
    and albedo rows of its ``FLAG_EMIT_SCALE`` output hold it against
    JAX's ``_normal_planes`` and ``_albedo_planes``. Box winners occur."""
    jscene, scene = _scenes(name)
    feats = SceneFeatures.from_scene(scene)
    jfeat = JFeatures.from_scene(jscene)
    tables = tfp.prep_tables(scene, feats)
    flags = tfp.feature_flags(feats)
    assert flags & shade_kernel.FLAG_BOX
    table = tables.table.numpy()
    n = 1024
    ro, rd, tm = _camera_state(name, n, seed=0)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm))
    box_wins = 0
    for depth in range(3):
        planes = st.planes.numpy()
        t, idx = jax_scene_winners(jscene, planes[0:3].T, planes[3:6].T,
                                   st.lane.numpy(), 11, depth)
        got_t, got_idx = (x.numpy() for x in tfp.closest_hit(
            tables, st, depth, feats, seed=11))
        assert_lanes_close(got_t, t, rtol=1e-3, atol=0.0, what="t")
        assert (got_idx == idx).mean() >= 0.995
        hit = t < 1e30
        box_wins += int((hit & (table[idx, 14] == 2.0)).sum())
        ref = jax_shade_planes(jscene, table, t, idx, st, 11, depth, 8)
        args = (tables.table, _t(idx), _t(t), st.planes, st.time, st.alive,
                st.lane, 11, depth, 8, tables.sky4)
        out, alive = shade_kernel.shade_from_winners(*args, flags)
        for k, plane in enumerate(PLANE_NAMES):
            assert_lanes_close(out[k].numpy(), ref[k],
                               what=f"depth {depth} {plane}")
        assert (alive.numpy() == (ref[12] > 0.5)).mean() >= 0.995
        st_e = tfp.FastStateP(torch.cat([st.planes, torch.ones(1, n)]),
                              st.time, st.alive, st.lane)
        out_e, _ = shade_kernel.shade_from_winners(
            *((args[0], args[1], args[2], st_e.planes) + args[4:]),
            flags | shade_kernel.FLAG_EMIT_SCALE)
        torch.testing.assert_close(out_e[:12], out, rtol=0.0, atol=0.0)
        attrs3 = jnp.asarray(np.ascontiguousarray(
            table[idx].reshape(n // 128, 128, -1).transpose(0, 2, 1)))
        nx, ny, nz, point = jfp._normal_planes(jnp.asarray(t), attrs3,
                                               jax_fused_state(st), jfeat)
        alb = jfp._albedo_planes(jnp.asarray(t), attrs3, point, jfeat)
        for k, ref_k in enumerate((nx, ny, nz, *alb)):
            assert_lanes_close(out_e[13 + k].numpy()[hit],
                               np.asarray(ref_k)[hit],
                               what=f"depth {depth} extra row {13 + k}")
        st = tfp.FastStateP(out, st.time, alive, st.lane)
    assert box_wins > 20


def test_box_normal_with_zero_direction_components():
    """An unrotated unit box hit along z by rays whose x and y components
    are exactly 0 or -0 (the slab test replaces them by +1e-12): the entry
    face from outside, the exit face from inside, in both packages; the
    normal is exact, not turned by the sign of a zero."""
    b, jb = build.SceneBuilder(), jbuild.SceneBuilder()
    for bb in (b, jb):
        bb.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
               bb.lambertian_color((0.5, 0.5, 0.5)))
        bb.sky = (0.0, 0.0, 0.0)
    scene, jscene = b.finish(), jb.finish()
    feats = SceneFeatures.from_scene(scene)
    ro = np.float32([[0.5, 0.5, -1.0], [0.25, 0.5, 0.5], [0.5, 0.75, 2.0],
                     [0.5, 0.5, 0.5]] * 32)
    rd = np.float32([[0.0, 0.0, 1.0], [-0.0, 0.0, 1.0], [0.0, -0.0, -1.0],
                     [-0.0, -0.0, -1.0]] * 32)
    want = np.float32([[0, 0, -1], [0, 0, 1], [0, 0, 1], [0, 0, -1]] * 32)
    tables = tfp.prep_tables(scene, feats)
    st = tfp.make_state(_t(ro), _t(rd), torch.zeros(128), nee=True)
    t, idx = tfp.closest_hit(tables, st, 0, feats)
    np.testing.assert_array_equal(t.numpy()[:4], np.float32([1.0, 0.5, 1.0, 0.5]))
    out, _ = shade_kernel.shade_from_winners(
        tables.table, idx, t, st.planes, st.time, st.alive, st.lane, 1, 0, 8,
        tables.sky4, tfp.feature_flags(feats) | shade_kernel.FLAG_EMIT_SCALE)
    np.testing.assert_array_equal(out[shade_kernel.NORMAL].numpy().T, want)
    table = tables.table.numpy()
    attrs3 = jnp.asarray(np.ascontiguousarray(
        table[idx.numpy()].reshape(1, 128, -1).transpose(0, 2, 1)))
    nx, ny, nz, _ = jfp._normal_planes(jnp.asarray(t.numpy()), attrs3,
                                       jax_fused_state(st),
                                       JFeatures.from_scene(jscene))
    np.testing.assert_array_equal(np.stack([np.asarray(c) for c in (nx, ny, nz)],
                                           axis=1), want)


def test_rect_winner_of_a_box_scene_reads_its_own_row():
    """In ``cornell`` the rect block is followed by the box rows: a rect
    winner takes row ``rows.rect + i``, whose plane holds the hit point,
    and a box winner a box row."""
    _, scene = _scenes("cornell")
    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    assert tables.rows == (128, 256, 258) and tables.table.shape[0] == 258
    ro, rd = _rays("camera", 4096)
    st = tfp.make_state(_t(ro), _t(rd), torch.zeros(4096))
    t, idx = tfp.closest_hit(tables, st, 0, feats)
    rows = tables.table[idx.long()]
    hit = t < 1e30
    kind = rows[:, 14]
    is_rect = hit & (kind == 1.0)
    assert is_rect.sum() > 1000 and (hit & (kind == 2.0)).sum() > 100
    assert ((idx >= 128) & (idx < 128 + scene.rects.count))[is_rect].all()
    point = _t(ro) + t[:, None] * _t(rd)
    axis = rows[is_rect, 15].long()
    on_plane = point[is_rect].gather(1, axis[:, None])[:, 0]
    torch.testing.assert_close(on_plane, rows[is_rect, 20], rtol=1e-4,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# the trace against the committed fixture
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    """4096 camera rays of ``cornell`` (numpy uniforms) and JAX's fused
    ``trace_fast`` radiance and segment count at depth 10: plain, and
    under ``nee.*`` with NEE and roulette from depth ``rr_start``."""
    from pathtrace_tpu.ops import lights as jlights

    jscene, jcam = jpresets.cornell(ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
    out = {"rays.ro": ro, "rays.rd": rd, "rays.time": tm,
           "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH),
           "rr_start": np.int64(RR_START)}
    for prefix, kw in (("", {}), ("nee.", {
            "nee_lights": jlights.build_light_table(jscene),
            "rr_start": RR_START})):
        rad, count = jfp.trace_fast(
            jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), SEED,
            MAX_DEPTH, JFeatures.from_scene(jscene), min_size=128, **kw)
        out[prefix + "radiance"] = np.asarray(rad)
        out[prefix + "ray_count"] = np.int64(int(count))
    return out


def test_fixture_rays_are_the_numpy_uniforms():
    ref = np.load(FIXTURE)
    rays = jax_camera_rays(jpresets.cornell(ASPECT)[1], N_RAYS,
                           seed=UNIFORM_SEED)
    for key, val in zip(("rays.ro", "rays.rd", "rays.time"), rays):
        np.testing.assert_array_equal(ref[key], val)
    assert (int(ref["seed"]), int(ref["max_depth"]),
            int(ref["rr_start"])) == (SEED, MAX_DEPTH, RR_START)


@pytest.mark.parametrize("compaction", [True, False])
@pytest.mark.parametrize("prefix", ["", "nee."])
def test_port_cpu_trace_holds_fixture(prefix, compaction):
    from pathtrace_tpu_torch.ops.lights import build_light_table

    ref = np.load(FIXTURE)
    scene, _ = presets.cornell(ASPECT)
    kw = ({"nee_lights": build_light_table(scene),
           "rr_start": int(ref["rr_start"])} if prefix else {})
    res = tfp.trace_fast(scene, *(_t(ref[k]) for k in
                                  ("rays.ro", "rays.rd", "rays.time")),
                         int(ref["seed"]), int(ref["max_depth"]),
                         SceneFeatures.from_scene(scene), min_size=128,
                         compaction=compaction, **kw)
    rad = res.radiance.numpy()
    assert np.isfinite(rad).all() and rad.shape == (N_RAYS, 3)
    frac = check_slice_contract(rad, res.ray_count, ref[prefix + "radiance"],
                                ref[prefix + "ray_count"], MAX_DEPTH,
                                budget=DEPTH10_BUDGET)
    if frac == 0.0:
        assert int(res.ray_count) == int(ref[prefix + "ray_count"])
    assert rad.mean() > 0.01  # the light reaches the camera


def test_one_ulp_nudge_of_the_rays():
    """How far the estimator itself moves when its inputs round
    differently: the fixture's camera directions moved by one ULP, traced
    on the CPU against the unmoved trace. Plain, no ray leaves 1e-3; with
    NEE and roulette some do (0.63% here: shadow rays on the 555-unit
    boxes), inside ``DEPTH10_BUDGET``. This is the room the card's trace,
    whose sin, cos and rsqrt round otherwise, needs against JAX's."""
    from pathtrace_tpu_torch.ops.lights import build_light_table

    ref = np.load(FIXTURE)
    scene, _ = presets.cornell(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    ro, rd, tm = (ref[k] for k in ("rays.ro", "rays.rd", "rays.time"))
    nudged = np.nextafter(rd, np.float32(2.0)).astype(np.float32)
    shares = {}
    for name, kw in (("plain", {}), ("nee", {
            "nee_lights": build_light_table(scene), "rr_start": RR_START})):
        a, b = (tfp.trace_fast(scene, _t(ro), _t(d), _t(tm), SEED, MAX_DEPTH,
                               feats, min_size=128, **kw).radiance.numpy()
                for d in (rd, nudged))
        shares[name] = float((~lane_close(b, a).all(axis=1)).mean())
    print(f"rays outside 1e-3 after a 1-ULP nudge: {shares}")
    assert shares["plain"] == 0.0
    assert 0.0 < shares["nee"] <= DEPTH10_BUDGET


# ---------------------------------------------------------------------------
# the gates and the CLI
# ---------------------------------------------------------------------------

def test_gates_on_box_scenes():
    """The fast path takes ``cornell`` and ``cornell_smoke``; the
    megakernel refuses them, as the reference's megakernel does; the
    differentiable trace and the trainer take them, as the reference's do;
    an image texture on a box is refused by the fast path (the reference
    shades it outside the fused kernel)."""
    from pathtrace_tpu_torch.parallel.inverse import make_inverse_renderer

    for name, kind in (("cornell", "boxes"), ("cornell_smoke", "media")):
        scene, cam = presets.from_name(name, ASPECT)
        feats = SceneFeatures.from_scene(scene)
        assert tfp.fastpath_supported(feats, scene)
        assert not megakernel.megakernel_supported(feats)
        ro = torch.zeros(8, 3)
        rd = torch.tensor([[0.0, 0.0, 1.0]] * 8)
        with pytest.raises(ValueError, match="boxes, media"):
            megakernel.trace_megakernel(megakernel.prep_tables(scene), ro, rd,
                                        torch.zeros(8), 0, 4, feats)
        assert getattr(feats, f"has_{kind}")
        rad, _ = tfp.trace_fast_diff(scene, ro, rd, torch.zeros(8), 0, 4,
                                     feats)
        assert rad.shape == (8, 3) and torch.isfinite(rad).all()
        assert make_inverse_renderer(scene, cam, 8, 8,
                                     device="cpu")[0].use_fast_path
    b = build.SceneBuilder()
    b.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
          b.lambertian(b.image_texture(np.ones((2, 2, 3), np.float32))))
    scene = b.finish()
    with pytest.raises(ValueError, match="image textures"):
        tfp.fastpath_supported(SceneFeatures.from_scene(scene), scene)


def test_cli_renders_cornell(tmp_path, capsys):
    out = tmp_path / "cornell.npy"
    argv = ["--device", "cpu", "-P", "cornell", "-W", "32", "-H", "18",
            "-S", "2", "-O", "--out", str(out)]
    assert cli.main(argv) == 0
    img = np.load(out)
    assert img.shape == (18, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    assert "wrote" in capsys.readouterr().out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
