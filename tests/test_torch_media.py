"""Participating media on the port's fast path against the JAX package
(CPU).

* The builder: ``cornell_smoke`` equals JAX's leaf for leaf; the media
  table (``build_media_table``) bit for bit JAX's on it, on
  ``torch_port_util.mixed_scene`` (a sphere medium and a box medium) and
  on twenty media of both kinds.
* The media sweep: the port's plane loop against the reference's
  ``media_nearest_planes`` and its [R, N] form ``media_nearest`` at N = 2
  and N = 20, on the same numpy uniforms as free-flight draws: idx and
  hit or miss equal, t within 1e-6 relative of the plane form
  (``torch.log`` and XLA's log may differ in the last place; measured
  1.6e-7) and 1e-5 of the [R, N] form (its einsum rounds the object-space
  rays in another order; measured 3.2e-6); rays that start inside a
  medium hit it.
* The plain K2 with ``FLAG_MEDIUM`` against ``shade_bounce_planes``
  (Pallas in interpret mode) over three bounces of ``cornell_smoke``, the
  port's merged winners (the media draw ``8 + j``) against JAX's, and the
  normal and albedo rows of the ``FLAG_EMIT_SCALE`` output against JAX's
  ``_normal_planes`` / ``_albedo_planes``: a medium's normal is (1, 0, 0)
  and its isotropic material scatters into the unit-sphere direction.
* The shadow rays: isotropic lanes take NEE; ``nearest_t_only`` with the
  shadow media draws ``8 + n_media + j`` against JAX's.
* The light table skips emissive boxes, as the reference's does.
* The depth-10 ``trace_fast`` of ``cornell_smoke`` with NEE and roulette
  from depth 3 against the committed fixture
  ``tests/goldens/torch_port_cornell_smoke_nee.npz`` (JAX's fused
  ``trace_fast`` on 4096 camera rays; the plain trace under ``plain.*``):
  radiance within 1e-3 with at most
  ``DEPTH10_BUDGET`` of the rays outside, compaction on and off; segment
  counts, shadow rays included, equal where no ray is outside (measured
  on the CPU: 0 rays outside, segments equal). The
  compacted trace follows the same paths as the uncompacted one: equal
  segments, radiance within 1e-6 (a lane that gains radiance both before
  and after a compaction sums it in another grouping, since the ladder
  flushes the radiance rows at each compaction). Regenerate the fixture with
  ``PYTHONPATH=. python tests/test_torch_media.py``.
* Unbiasedness: the plain, NEE and NEE + roulette means of a
  ``cornell_smoke`` film agree within 4 standard errors per channel.
* The CLI renders ``-P cornell_smoke -O --nee --rr 3``.
"""

import functools
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
from pathtrace_tpu.ops import lights as jlights  # noqa: E402
from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.models import build, convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_box, lights  # noqa: E402
from pathtrace_tpu_torch.ops import shade_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, PLANE_NAMES, assert_lanes_close, check_slice_contract,
    jax_camera_rays, jax_fused_state, jax_scene_leaves, jax_scene_winners,
    jax_shade_planes, mixed_scene,
)

ASPECT = 16 / 9
FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_cornell_smoke_nee.npz")
N_RAYS, SEED, MAX_DEPTH, UNIFORM_SEED, RR_START = 4096, 7, 10, 2025, 3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _scenes(name):
    """(JAX scene, port scene) of ``cornell_smoke``, the mixed scene or
    twenty media (every other one a sphere)."""
    if name == "cornell_smoke":
        return (jpresets.cornell_smoke(ASPECT)[0],
                presets.cornell_smoke(ASPECT)[0])
    if name == "mixed":
        return mixed_scene(jbuild), mixed_scene(build)
    out = []
    for mod in (jbuild, build):
        g = np.random.default_rng(9)
        b = mod.SceneBuilder()
        for i in range(20):
            p0 = g.uniform(0.0, 400.0, 3)
            tex = b.constant_texture(g.random(3))
            density = float(g.uniform(0.002, 0.05))
            if i % 2:
                b.medium_sphere(p0, float(g.uniform(20.0, 80.0)), density, tex)
            else:
                xf = mod.affine_from_axis_angle(g.normal(size=3),
                                                float(g.uniform(0.0, 90.0)),
                                                g.uniform(-50.0, 50.0, 3))
                b.medium_box(p0, p0 + g.uniform(20.0, 120.0, 3), density,
                             tex, xf)
        out.append(b.finish())
    return tuple(out)


def _rays(kind, n=2048, seed=11):
    if kind == "camera":
        ro, rd, _ = jax_camera_rays(jpresets.cornell_smoke(ASPECT)[1], n,
                                    seed=4)
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
# the builder and the table
# ---------------------------------------------------------------------------

def test_cornell_smoke_equals_jax_leaf_for_leaf():
    jscene, scene = _scenes("cornell_smoke")
    ref = jax_scene_leaves(jscene)
    got = convert.scene_to_numpy(scene)
    assert set(got) == set(ref)
    for key, val in got.items():
        assert _bits_equal(ref[key], val), key
    assert int(scene.media.mask.sum()) == 2 and not scene.boxes.mask.any()


@pytest.mark.parametrize("name", ["cornell_smoke", "mixed", "twenty"])
def test_media_table_bitwise(name):
    jscene, scene = _scenes(name)
    if name == "twenty":
        for key, val in convert.scene_to_numpy(scene).items():
            assert _bits_equal(jax_scene_leaves(jscene)[key], val), key
    jfeat = JFeatures.from_scene(jscene)
    feats = SceneFeatures.from_scene(scene)
    assert feats._key() == jfeat._key() and feats.has_media
    assert feats.has_isotropic
    k = tfp.attr_width(feats)
    assert k == jfp.attr_width(jfeat) == 48
    ref = np.asarray(jfp.build_media_table(jscene, k))
    got = tfp.build_media_table(scene, k).numpy()
    assert _bits_equal(ref, got)
    assert np.all(got[scene.media.mask.numpy(), 14] == 3.0)


# ---------------------------------------------------------------------------
# the media sweep
# ---------------------------------------------------------------------------

def _sweep_both(jscene, scene, ro, rd, seed=0):
    u = np.random.default_rng(seed).random((ro.shape[0], scene.media.count),
                                           dtype=np.float32)
    planes = [*ro.T, *rd.T]
    got = intersect_box.media_nearest(scene.media, *(_t(p) for p in planes),
                                      _t(u.T))
    ref = jisect.media_nearest_planes(
        jscene.media, *(jnp.asarray(p) for p in planes), jnp.asarray(u))
    cols = jisect.media_nearest(jscene.media, jnp.asarray(ro),
                                jnp.asarray(rd), jnp.asarray(u))
    return ([x.numpy() for x in got], [np.asarray(x) for x in ref],
            [np.asarray(x) for x in cols])


@pytest.mark.parametrize("kind", ["camera", "random", "parallel"])
@pytest.mark.parametrize("name", ["cornell_smoke", "twenty"])
def test_media_sweep_equals_jax(name, kind):
    jscene, scene = _scenes(name)
    ro, rd = _rays(kind)
    (t, idx), (t_ref, i_ref), (t_cols, i_cols) = _sweep_both(jscene, scene,
                                                             ro, rd)
    assert t.dtype == np.float32 and idx.dtype == np.int32
    for tr, ir, rtol in ((t_ref, i_ref, 1e-6), (t_cols, i_cols, 1e-5)):
        np.testing.assert_array_equal(idx, ir)
        np.testing.assert_array_equal(t < 1e30, tr < 1e30)
        np.testing.assert_allclose(t, tr, rtol=rtol)
    assert (t < 1e30).mean() > 0.02


def test_media_sweep_from_inside():
    """Rays from each medium's centre (box centres mapped to the world,
    sphere centres) with uniforms near 1, so free flights are short: each
    ray scatters inside its own medium, at the same t in both packages."""
    jscene, scene = _scenes("twenty")
    g = np.random.default_rng(4)
    md = scene.media
    wfo = md.world_from_obj.numpy()
    mid = 0.5 * (md.p0.numpy() + md.p1.numpy())
    box_c = np.einsum("nij,nj->ni", wfo[:, :, :3], mid) + wfo[:, :, 3]
    centres = np.where(md.kind.numpy()[:, None] == 1, md.p0.numpy(), box_c)
    ro = np.repeat(centres, 32, axis=0).astype(np.float32)
    d = g.normal(size=ro.shape)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u = np.full((ro.shape[0], md.count), 0.9999, np.float32)
    planes = [*ro.T, *rd.T]
    t, idx = intersect_box.media_nearest(md, *(_t(p) for p in planes), _t(u.T))
    t_ref, i_ref = jisect.media_nearest_planes(
        jscene.media, *(jnp.asarray(p) for p in planes), jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-6)
    own = np.repeat(np.arange(20), 32)
    # media overlap: where two hold the start, the denser scatters first
    assert (idx.numpy() == own).mean() >= 0.8
    assert (t.numpy() < 0.1).all()


# ---------------------------------------------------------------------------
# K2's medium branch, the merge, the NEE rows and the shadow rays
# ---------------------------------------------------------------------------

def test_k2_medium_branch_and_merge_match_jax():
    """Three bounces of ``cornell_smoke``'s camera rays: the port's merged
    winners (the media drawn with ``8 + j``) equal JAX's, the plain K2 with
    ``FLAG_MEDIUM`` holds the lane contract against
    ``shade_bounce_planes``, and its ``FLAG_EMIT_SCALE`` rows (the normal
    (1, 0, 0) in a medium, the albedo) against ``_normal_planes`` and
    ``_albedo_planes``. Medium winners occur, and isotropic lanes take
    NEE in ``shadow_rays``."""
    jscene, scene = _scenes("cornell_smoke")
    feats = SceneFeatures.from_scene(scene)
    jfeat = JFeatures.from_scene(jscene)
    light_table = lights.build_light_table(scene)
    tables = tfp.prep_tables(scene, feats, lights=light_table)
    flags = tfp.feature_flags(feats)
    assert flags & shade_kernel.FLAG_MEDIUM
    assert not flags & shade_kernel.FLAG_BOX
    table = tables.table.numpy()
    n = 1024
    ro, rd, tm = jax_camera_rays(jpresets.cornell_smoke(ASPECT)[1], n, seed=0)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm))
    med_wins = iso_nee = 0
    for depth in range(3):
        planes = st.planes.numpy()
        t, idx = jax_scene_winners(jscene, planes[0:3].T, planes[3:6].T,
                                   st.lane.numpy(), 11, depth)
        got_t, got_idx = (x.numpy() for x in tfp.closest_hit(
            tables, st, depth, feats, seed=11))
        assert_lanes_close(got_t, t, rtol=1e-3, atol=0.0, what="t")
        assert (got_idx == idx).mean() >= 0.995
        hit = t < 1e30
        is_med = hit & (table[idx, 14] == 3.0)
        med_wins += int(is_med.sum())
        ref = jax_shade_planes(jscene, table, t, idx, st, 11, depth, 8)
        args = (tables.table, _t(idx), _t(t), st.planes, st.time, st.alive,
                st.lane, 11, depth, 8, tables.sky4)
        out, alive = shade_kernel.shade_from_winners(*args, flags)
        for k, plane in enumerate(PLANE_NAMES):
            assert_lanes_close(out[k].numpy(), ref[k],
                               what=f"depth {depth} {plane}")
        assert (alive.numpy() == (ref[12] > 0.5)).mean() >= 0.995
        st_e = torch.cat([st.planes, torch.ones(1, n)])
        out_e, alive_e = shade_kernel.shade_from_winners(
            *(args[:3] + (st_e,) + args[4:]),
            flags | shade_kernel.FLAG_EMIT_SCALE)
        attrs3 = jnp.asarray(np.ascontiguousarray(
            table[idx].reshape(n // 128, 128, -1).transpose(0, 2, 1)))
        nx, ny, nz, point = jfp._normal_planes(jnp.asarray(t), attrs3,
                                               jax_fused_state(st), jfeat)
        alb = jfp._albedo_planes(jnp.asarray(t), attrs3, point, jfeat)
        for k, ref_k in enumerate((nx, ny, nz, *alb)):
            assert_lanes_close(out_e[13 + k].numpy()[hit],
                               np.asarray(ref_k)[hit],
                               what=f"depth {depth} extra row {13 + k}")
        normal = out_e[shade_kernel.NORMAL].numpy()
        assert np.all(normal[:, is_med].T == np.float32([1.0, 0.0, 0.0]))
        # an isotropic winner scatters into a unit direction, attenuated
        # by its albedo (the black fog's is 0)
        live = is_med & alive.numpy()
        np.testing.assert_allclose(np.linalg.norm(out[3:6].numpy()[:, live],
                                                  axis=0), 1.0, atol=1e-5)
        sh = tfp.shadow_rays(tables, _t(idx), out_e, alive_e, st.lane, 11,
                             depth)
        iso_nee += int((sh.mask.numpy() & is_med).sum())
        st = tfp.FastStateP(out, st.time, alive, st.lane)
    assert med_wins > 20 and iso_nee > 0


@pytest.mark.parametrize("name", ["cornell_smoke", "mixed"])
def test_nearest_t_only_with_media_matches_jax(name):
    """Shadow rays of sampled light directions from random points: the
    shadow media draw ``8 + n_media + j``; t under the lane contract, the
    hit/miss and the occlusion decisions on 99.5% of rays."""
    jscene, scene = _scenes(name)
    feats = SceneFeatures.from_scene(scene)
    jfeat = JFeatures.from_scene(jscene)
    light_table = lights.build_light_table(scene)
    n = 1024
    g = np.random.default_rng(8)
    lo, hi = ((0.0, 0.0, 0.0), (555.0, 550.0, 555.0)) if name != "mixed" \
        else ((-3.0, 0.0, -3.0), (3.0, 3.0, 3.0))
    p = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    u = g.random((3, n), dtype=np.float32)
    sample = lights.sample_light_dirs_planes(
        light_table, *(_t(c) for c in (*p.T, *u)))
    wi = np.stack(sample[:3], axis=1).astype(np.float32)
    dist = sample[3].numpy()
    lane = np.arange(n, dtype=np.int32) * 7 + 3
    n_media = scene.media.count
    j_lane = jnp.asarray(lane.astype(np.uint32))
    smed_u = jnp.stack([jfp.counter_uniform(j_lane, jnp.int32(5), 2,
                                            8 + n_media + j)
                        for j in range(n_media)], axis=-1)
    ref = np.asarray(jfp.nearest_t_only(
        jscene, jnp.asarray(p), jnp.asarray(wi), jnp.zeros(n, jnp.float32),
        jfeat, med_u=smed_u))
    tables = tfp.prep_tables(scene, feats)
    med_u = tfp.media_uniforms(_t(lane), 5, 2, n_media, 8 + n_media)
    got = tfp.nearest_t_only(tables, _t(np.concatenate([p.T, wi.T])),
                             torch.zeros(n), feats, med_u).numpy()
    hit = ref < 1e30  # the lights themselves are hit too
    assert hit.mean() > 0.2
    assert ((got < 1e30) == hit).mean() >= 0.995
    # the occlusion test of the NEE tail: some rays blocked, some not
    occluded = hit & (ref < dist * (1.0 - 1e-3))
    assert 0.0 < occluded.mean() < 1.0
    assert ((got < dist * (1.0 - 1e-3)) == occluded).mean() >= 0.995
    assert_lanes_close(got, ref, rtol=1e-3, atol=0.0, what="shadow t")


def test_light_table_skips_emissive_boxes():
    """Like the reference's, the light table holds spheres and rects only:
    an emissive box is not sampled."""
    tables = []
    for mod, lt in ((jbuild, jlights), (build, lights)):
        b = mod.SceneBuilder()
        b.rect_xz(0.0, 1.0, 0.0, 1.0, 3.0, False,
                  b.diffuse_light_color((4.0, 4.0, 4.0)))
        b.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
              b.diffuse_light_color((2.0, 2.0, 2.0)))
        b.medium_box((2.0, 0.0, 0.0), (3.0, 1.0, 1.0), 0.5,
                     b.constant_texture((0.5, 0.5, 0.5)))
        tables.append(lt.build_light_table(b.finish()))
    ref, got = tables
    assert got.count == ref.count == 1 and int(got.kind[0]) == 1
    for field in ("kind", "axis", "a0", "a1", "b0", "b1", "k", "tex_id",
                  "color"):
        assert _bits_equal(np.asarray(getattr(ref, field)),
                           getattr(got, field)), field


# ---------------------------------------------------------------------------
# the trace against the committed fixture
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    """4096 camera rays of ``cornell_smoke`` (numpy uniforms) and JAX's
    fused ``trace_fast`` with NEE and roulette from depth 3, and under
    ``plain.*`` without them."""
    jscene, jcam = jpresets.cornell_smoke(ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
    out = {"rays.ro": ro, "rays.rd": rd, "rays.time": tm,
           "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH),
           "rr_start": np.int64(RR_START)}
    for prefix, kw in (("", {
            "nee_lights": jlights.build_light_table(jscene),
            "rr_start": RR_START}), ("plain.", {})):
        rad, count = jfp.trace_fast(
            jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), SEED,
            MAX_DEPTH, JFeatures.from_scene(jscene), min_size=128, **kw)
        out[prefix + "radiance"] = np.asarray(rad)
        out[prefix + "ray_count"] = np.int64(int(count))
    return out


@functools.lru_cache(maxsize=None)
def _nee_trace(compaction=True, nee=True):
    ref = np.load(FIXTURE)
    scene, _ = presets.cornell_smoke(ASPECT)
    kw = ({"nee_lights": lights.build_light_table(scene),
           "rr_start": int(ref["rr_start"])} if nee else {})
    res = tfp.trace_fast(
        scene, *(_t(ref[k]) for k in ("rays.ro", "rays.rd", "rays.time")),
        int(ref["seed"]), int(ref["max_depth"]),
        SceneFeatures.from_scene(scene), min_size=128, compaction=compaction,
        **kw)
    return res.radiance.numpy(), int(res.ray_count)


def test_fixture_rays_are_the_numpy_uniforms():
    ref = np.load(FIXTURE)
    rays = jax_camera_rays(jpresets.cornell_smoke(ASPECT)[1], N_RAYS,
                           seed=UNIFORM_SEED)
    for key, val in zip(("rays.ro", "rays.rd", "rays.time"), rays):
        np.testing.assert_array_equal(ref[key], val)
    assert (int(ref["seed"]), int(ref["max_depth"]),
            int(ref["rr_start"])) == (SEED, MAX_DEPTH, RR_START)


@pytest.mark.parametrize("compaction", [True, False])
@pytest.mark.parametrize("prefix", ["", "plain."])
def test_port_cpu_nee_trace_holds_fixture(prefix, compaction):
    ref = np.load(FIXTURE)
    rad, count = _nee_trace(compaction, nee=not prefix)
    assert np.isfinite(rad).all() and rad.shape == (N_RAYS, 3)
    frac = check_slice_contract(rad, count, ref[prefix + "radiance"],
                                ref[prefix + "ray_count"], MAX_DEPTH,
                                budget=DEPTH10_BUDGET)
    if frac == 0.0:
        assert count == int(ref[prefix + "ray_count"])
    assert rad.mean() > 0.01


def test_nee_compaction_only_regroups_the_sums():
    a, ca = _nee_trace(True)
    b, cb = _nee_trace(False)
    assert ca == cb
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (a != b).any(axis=1).mean() < 0.5


def test_nee_and_roulette_are_unbiased_in_media():
    """16384 camera rays over a ``cornell_smoke`` film, traced with the
    plain estimator, NEE, and NEE with roulette from depth 3 on the same
    seed: for every pair, the per-channel mean of the per-ray differences
    within 4 of its standard errors (paired, as in
    ``test_torch_nee.test_nee_and_roulette_are_unbiased``). Isotropic
    lanes take NEE with the phase function's density 1 / (4 pi)."""
    scene, _ = presets.cornell_smoke(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    table = lights.build_light_table(scene)
    n = 16384
    rays = [_t(x) for x in jax_camera_rays(
        jpresets.cornell_smoke(ASPECT)[1], n, seed=12)]
    est = {name: tfp.trace_fast(scene, *rays, 100, 10, feats, **kw)
           .radiance.double().numpy() for name, kw in (
               ("plain", {}), ("nee", {"nee_lights": table}),
               ("nee_rr", {"nee_lights": table, "rr_start": 3}))}
    for a, b in (("plain", "nee"), ("plain", "nee_rr"), ("nee", "nee_rr")):
        d = est[b] - est[a]
        se = d.std(axis=0, ddof=1) / np.sqrt(n)
        assert np.all(np.abs(d.mean(axis=0)) <= 4.0 * se), (a, b, d.mean(0), se)
    assert np.all(est["nee"].std(axis=0) < est["plain"].std(axis=0))


def test_cli_renders_cornell_smoke_with_nee(tmp_path, capsys):
    out = tmp_path / "smoke.npy"
    argv = ["--device", "cpu", "-P", "cornell_smoke", "-W", "32", "-H", "18",
            "-S", "2", "-O", "--nee", "--rr", "3", "--out", str(out)]
    assert cli.main(argv) == 0
    img = np.load(out)
    assert img.shape == (18, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    assert "wrote" in capsys.readouterr().out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
