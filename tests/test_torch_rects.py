"""Rect scenes on the port's fast path against the JAX package (CPU).

* The rect sweep: the port's one form (the plane loop) against both of
  the reference's, ``rect_nearest_planes`` and ``rect_nearest_cols``, on
  camera, random and axis-parallel rays, over ``simple_light`` and the
  boards of ``torch_port_util.boards_scene`` (rects of every axis,
  flipped and not): t and idx equal; dead rects never win; 20 rects (the
  reference's [R, N] form) sweep the same.
* The rect table (``build_rect_table``) and the fused table of
  ``prep_tables`` bit for bit JAX's, dead and padding rows included.
* The plain K2 with ``FLAG_RECT`` against ``shade_bounce_planes`` (Pallas
  in interpret mode) on the winners of ``simple_light`` and of the boards
  over three bounces, under the lane contract of tests/test_shade_pallas.py;
  the rect normal is onehot(axis) * flip.
* The winner merge: ``closest_hit``'s (t, idx) against JAX's closest hit
  over spheres and rects (a rect wins only when strictly nearer).
* The depth-10 ``trace_fast`` of ``simple_light`` against the committed
  fixture ``tests/goldens/torch_port_simple_light.npz`` (JAX's fused
  ``trace_fast`` on 4096 camera rays): radiance within 1e-3 with at most
  ``DEPTH10_BUDGET`` of the rays outside, segment counts equal where no
  ray is outside. Measured on the CPU: 1 ray of 4096 outside (0.02%),
  segments equal (6370).
  Regenerate the fixture with ``PYTHONPATH=. python tests/test_torch_rects.py``.
* ``trace_fast_diff`` of ``simple_light``: radiance and the default
  leaves' gradients against JAX's ``trace_fast_diff``; on the boards it
  equals the fused trace ray by ray (the rect normals of both paths).
* The gates: the fast path and the CLI take ``simple_light`` and refuse
  more than 128 rects.
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
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_rect, shade_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, GRAD_TOL, LIGHT_FIXTURE, PLANE_NAMES, assert_grads_close,
    assert_lanes_close, boards_scene, check_slice_contract, jax_camera_rays,
    jax_rect_scene_winners, jax_shade_planes, jax_trace_vjp, lane_close,
    numpy_uniforms, port_grads, port_light_fixture_trace, port_trace_diff,
    scene_pair,
)

ASPECT = 16 / 9
FIXTURE = LIGHT_FIXTURE
N_RAYS, SEED, MAX_DEPTH, UNIFORM_SEED = 4096, 7, 10, 2025


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(kind, n=2048):
    """Camera rays of ``simple_light``, rays from random points in random
    directions, or rays parallel to each rect plane (d_n = 0)."""
    if kind == "camera":
        ro, rd, _ = jax_camera_rays(jpresets.simple_light(ASPECT)[1], n, seed=4)
        return ro, rd
    g = np.random.default_rng(11)
    ro = g.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    if kind == "parallel":
        d[np.arange(n), np.arange(n) % 3] = 0.0
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


# ---------------------------------------------------------------------------
# the rect sweep and the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["camera", "random", "parallel"])
@pytest.mark.parametrize("form", ["planes", "cols"])
def test_rect_sweep_equals_jax(kind, form):
    """The port's plane loop against each of the reference's two forms,
    t and idx bit for bit."""
    jscene, _, _ = scene_pair("simple_light", ASPECT)
    jboard = boards_scene(jbuild.SceneBuilder())
    board = boards_scene(SceneBuilder())
    ro, rd = _rays(kind)
    planes = [*ro.T, *rd.T]
    jfn = getattr(jisect, f"rect_nearest_{form}")
    fn = intersect_rect.rect_nearest
    hits = 0
    for js, ts in ((jscene, presets.simple_light(ASPECT)[0]),
                   (jboard, board)):
        t_ref, i_ref = jfn(js.rects, *(jnp.asarray(p) for p in planes))
        t, idx = fn(ts.rects, *(_t(p) for p in planes))
        assert t.dtype == torch.float32 and idx.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
        hits += int((t < 1e30).sum())
    assert hits > 0 or kind == "parallel"


def test_rect_sweep_router_and_dead_rects():
    """20 stacked rects, more than the reference sweeps in its plane form:
    the port's plane loop gives the winners of JAX's [R, N] form, and a
    dead rect in front of a live one never wins, in either."""
    b = SceneBuilder()
    jb = jbuild.SceneBuilder()
    for bb in (b, jb):
        mat = bb.lambertian_color((0.5, 0.5, 0.5))
        for i in range(20):
            bb.rect_xy(-1.0, 1.0, -1.0, 1.0, -2.0 - 0.1 * i, False, mat)
    scene, jscene = b.finish(), jb.finish()
    ro, rd = _rays("random", 256)
    ro[:64] = 0.0
    rd[:64] = np.float32([0.0, 0.0, -1.0])
    planes = [*ro.T, *rd.T]
    t, idx = intersect_rect.rect_nearest(scene.rects, *(_t(p) for p in planes))
    t_ref, i_ref = jisect.rect_nearest_cols(jscene.rects,
                                            *(jnp.asarray(p) for p in planes))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    assert idx[:64].unique().tolist() == [0]
    assert float(t[0]) == pytest.approx(2.0)
    scene.rects.mask[0] = False
    t, idx = intersect_rect.rect_nearest(scene.rects, *(_t(p) for p in planes))
    assert idx[:64].unique().tolist() == [1]
    assert float(t[0]) == pytest.approx(2.1)


@pytest.mark.parametrize("name", ["simple_light", "boards"])
def test_rect_table_and_fused_table_bitwise(name):
    if name == "boards":
        jscene, scene = boards_scene(jbuild.SceneBuilder()), boards_scene(SceneBuilder())
    else:
        jscene, _, scene = scene_pair(name, ASPECT)
    feats = SceneFeatures.from_scene(scene)
    jfeat = JFeatures.from_scene(jscene)
    ref = np.asarray(jfp.build_rect_table(jscene, jfp.attr_width(jfeat)))
    got = tfp.build_rect_table(scene, tfp.attr_width(feats)).numpy()
    assert got.shape == ref.shape == (128, 24)
    assert got.tobytes() == ref.tobytes()
    n = scene.rects.count
    dead = np.concatenate([~scene.rects.mask.numpy(), np.ones(128 - n, bool)])
    assert np.all(got[dead][:, [16, 17, 20]] == np.float32([1, -1, 1e18]))
    assert np.all(got[~dead][:, 14] == 1.0)
    (j_sph, j_rect, _, _), _, _ = jfp.prep_tables(jscene, jfeat)
    tables = tfp.prep_tables(scene, feats)
    assert tables.rects is scene.rects
    assert tables.table.numpy().tobytes() == np.concatenate(
        [np.asarray(j_sph), np.asarray(j_rect)]).tobytes()


# ---------------------------------------------------------------------------
# the merge and K2's rect branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["simple_light", "boards"])
def test_k2_rect_branch_and_merge_match_jax(name):
    """Three bounces through ``simple_light`` (a rect light) and through
    the boards (Lambertian rects of every axis, which scatter off the rect
    normal), seen by ``simple_light``'s camera: the port's merged winners
    equal JAX's (t to 1e-3 under the lane contract, idx on 99.5% of lanes),
    and the plain K2 with ``FLAG_RECT`` on JAX's winners holds the lane
    contract against ``shade_bounce_planes``. Rect winners occur."""
    jscene, jcam, scene = scene_pair("simple_light", ASPECT)
    if name == "boards":
        jscene = boards_scene(jbuild.SceneBuilder())
        scene = boards_scene(SceneBuilder())
    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    flags = tfp.feature_flags(feats)
    assert flags & shade_kernel.FLAG_RECT
    table = tables.table.numpy()
    ro, rd, tm = jax_camera_rays(jcam, 1024, seed=0)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm))
    rect_wins = 0
    for depth in range(3):
        planes = st.planes.numpy()
        t, idx = jax_rect_scene_winners(jscene, planes[0:3].T, planes[3:6].T)
        got_t, got_idx = (x.numpy() for x in tfp.closest_hit(tables, st,
                                                               depth, feats))
        assert_lanes_close(got_t, t, rtol=1e-3, atol=0.0, what="t")
        assert (got_idx == idx).mean() >= 0.995
        rect_wins += int((idx >= table.shape[0] - tfp.RECT_ROWS).sum())
        ref = jax_shade_planes(jscene, table, t, idx, st, 11, depth, 8)
        out, alive = shade_kernel.shade_from_winners(
            tables.table, _t(idx), _t(t), st.planes, st.time, st.alive,
            st.lane, 11, depth, 8, tables.sky4, flags)
        for k, name in enumerate(PLANE_NAMES):
            assert_lanes_close(out[k].numpy(), ref[k],
                               what=f"depth {depth} {name}")
        assert (alive.numpy() == (ref[12] > 0.5)).mean() >= 0.995
        st = tfp.FastStateP(out, st.time, alive, st.lane)
    assert rect_wins > 0


def test_rect_normal_is_axis_times_flip():
    """Rect winners of every axis and flip: the plain K2's normal (the
    NEE output rows) is onehot(axis) * flip, not turned to the ray."""
    scene = boards_scene(SceneBuilder())
    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    rows = tables.table.shape[0] - 128 + torch.arange(4, dtype=torch.int32)
    R = rows.shape[0]
    st = tfp.make_state(torch.zeros(R, 3), torch.tensor([[0.0, 0.0, -1.0]] * R),
                        torch.zeros(R), nee=True)
    out, _ = shade_kernel.shade_from_winners(
        tables.table, rows, torch.ones(R), st.planes, st.time, st.alive,
        st.lane, 1, 0, 8, tables.sky4,
        tfp.feature_flags(feats) | shade_kernel.FLAG_EMIT_SCALE)
    rc = scene.rects
    want = torch.zeros(R, 3)
    want[torch.arange(R), rc.axis[:R].long()] = rc.flip[:R]
    assert torch.equal(out[shade_kernel.NORMAL].T, want)


# ---------------------------------------------------------------------------
# the trace against the committed fixture
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    """4096 camera rays of ``simple_light`` (numpy uniforms) and JAX's
    fused ``trace_fast`` radiance and segment count at depth 10."""
    jscene, jcam = jpresets.simple_light(ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
    rad, count = jfp.trace_fast(jscene, jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(tm), SEED, MAX_DEPTH,
                                JFeatures.from_scene(jscene), min_size=128)
    return {"rays.ro": ro, "rays.rd": rd, "rays.time": tm,
            "radiance": np.asarray(rad), "ray_count": np.int64(int(count)),
            "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH)}


def test_fixture_rays_are_the_numpy_uniforms():
    ref = np.load(FIXTURE)
    rays = jax_camera_rays(jpresets.simple_light(ASPECT)[1], N_RAYS,
                           seed=UNIFORM_SEED)
    for key, val in zip(("rays.ro", "rays.rd", "rays.time"), rays):
        np.testing.assert_array_equal(ref[key], val)
    s, _, _ = numpy_uniforms(N_RAYS, seed=UNIFORM_SEED)
    assert s.std() > 0.2
    assert (int(ref["seed"]), int(ref["max_depth"])) == (SEED, MAX_DEPTH)


@pytest.mark.parametrize("compaction", [True, False])
def test_port_cpu_trace_holds_fixture(compaction):
    ref = np.load(FIXTURE)
    res = port_light_fixture_trace(ref, min_size=128, compaction=compaction)
    rad = res.radiance.numpy()
    assert np.isfinite(rad).all() and rad.shape == (N_RAYS, 3)
    frac = check_slice_contract(rad, res.ray_count, ref["radiance"],
                                ref["ray_count"], MAX_DEPTH,
                                budget=DEPTH10_BUDGET)
    if frac == 0.0:
        assert int(res.ray_count) == int(ref["ray_count"])
    assert rad.mean() > 0.05  # the lights reach the camera


def test_trace_matches_megakernel_per_ray():
    """The wavefront and the megakernel draw the same counter hash on the
    same lanes: ray by ray they agree on ``simple_light``."""
    from pathtrace_tpu_torch.ops import megakernel

    ref = np.load(FIXTURE)
    rays = [_t(ref[k][:2048]) for k in ("rays.ro", "rays.rd", "rays.time")]
    scene, _ = presets.simple_light(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    fast = tfp.trace_fast(scene, *rays, 7, 10, feats)
    mk, segs = megakernel.trace_megakernel(megakernel.prep_tables(scene),
                                           *rays, 7, 10, feats)
    close = lane_close(fast.radiance.numpy(), mk.numpy()).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(int(segs) - int(fast.ray_count)) <= 0.01 * int(segs)


# ---------------------------------------------------------------------------
# the differentiable path
# ---------------------------------------------------------------------------

def test_trace_fast_diff_on_rects_matches_jax():
    """Radiance and the default leaves' gradients (depth 4) of 512 camera
    rays of ``simple_light``, against JAX's ``trace_fast_diff``: the rects
    take part in the closest hit and the normals."""
    jscene, jcam, scene = scene_pair("simple_light", ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, 512, seed=9)
    ref, vjp, jnames = jax_trace_vjp(jscene, ro, rd, tm, 5, 4)
    rad, params, names = port_trace_diff(scene, ro, rd, tm, 5, 4)
    assert names == jnames
    close = lane_close(rad.detach().numpy(), ref).all(axis=1)
    assert close.mean() >= 0.995
    w = np.random.default_rng(1).random(ref.shape).astype(np.float32)
    w *= close[:, None]
    assert_grads_close(port_grads(rad, params, w), vjp(w), names, GRAD_TOL,
                       "simple_light")


def test_trace_fast_diff_equals_trace_fast_on_boards():
    """On the boards (Lambertian rects of every axis) the differentiable
    trace and the fused trace shade the same rect normals: ray by ray
    within 1e-3 at depth 4, segments equal."""
    scene = boards_scene(SceneBuilder())
    feats = SceneFeatures.from_scene(scene)
    ro, rd, tm = (_t(x) for x in jax_camera_rays(
        jpresets.simple_light(ASPECT)[1], 1024, seed=6))
    with torch.no_grad():
        rad, segs = tfp.trace_fast_diff(scene, ro, rd, tm, 3, 4, feats)
    fast = tfp.trace_fast(scene, ro, rd, tm, 3, 4, feats, compaction=False)
    assert lane_close(rad.numpy(), fast.radiance.numpy()).all(axis=1).mean() >= 0.995
    assert int(segs) == int(fast.ray_count)
    assert (rad.numpy() > 0).any(axis=1).mean() > 0.2


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def test_gate_takes_rects_and_refuses_more_than_128():
    scene, _ = presets.simple_light(ASPECT)
    assert tfp.fastpath_supported(SceneFeatures.from_scene(scene), scene)
    b = SceneBuilder()
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    for i in range(129):
        b.rect_xz(0.0, 1.0, 0.0, 1.0, float(i), False, mat)
    many = b.finish()
    with pytest.raises(ValueError, match="at most 128"):
        tfp.fastpath_supported(SceneFeatures.from_scene(many), many)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
