"""Next-event estimation (NEE) with MIS and Russian roulette on the port's
fast path, against the JAX package (CPU).

* The light table (``build_light_table``) equal to JAX's field for field,
  the lightless scene (None) and a light whose texture is not a constant
  (colour None, which the fast path refuses as not ported yet).
* The light sampler and its density (``sample_light_dirs_planes``,
  ``light_dir_pdf_planes``) against JAX's on seeded points, uniforms and
  directions: discrete results (light index, valid, whether a direction
  meets a light) equal, floats within ``LIGHT_RTOL`` (see there).
* The shadow rays' closest hit (``nearest_t_only``) against JAX's under
  K1's lane contract.
* The plain K2 with ``FLAG_EMIT_SCALE`` (and ``FLAG_RECT``) on
  ``simple_light``'s winners with a non-trivial MIS plane, against
  ``shade_bounce_planes(emit_scale=...)`` (Pallas in interpret mode) under
  the lane contract; its extra rows: the MIS plane copied through, the
  normal and the albedo against JAX's ``_normal_planes`` and
  ``_albedo_planes``.
* The depth-10 ``trace_fast`` of ``simple_light`` with ``nee_lights`` and
  ``rr_start=3`` against the committed fixture
  ``tests/goldens/torch_port_simple_light_nee.npz`` (JAX's fused
  ``trace_fast`` on the 4096 camera rays of ``torch_port_simple_light.npz``):
  radiance within 1e-3 with at most ``DEPTH10_BUDGET`` of the rays outside;
  segment counts, shadow rays included, equal where no ray is outside.
  Measured on the CPU: 2 rays of 4096 outside (0.05%), segments equal
  (8628, against 6370 without NEE and roulette). Regenerate the
  fixture with ``PYTHONPATH=. python tests/test_torch_nee.py``.
* Compaction moves the MIS plane with the rest (bit for bit equal to the
  uncompacted trace); a lightless scene renders the plain estimator.
* Unbiasedness: the port's plain, NEE and NEE + roulette estimates of the
  mean of a ``simple_light`` film agree within 4 standard errors per
  channel (paired on the same rays and seed), and NEE lowers the
  standard error.
* The CLI renders ``-P simple_light -O --nee --rr 3`` on the CPU.
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
from pathtrace_tpu.ops import lights as jlights  # noqa: E402
from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.config import Params  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import lights, shade_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, LIGHT_FIXTURE as PLAIN_FIXTURE, PLANE_NAMES,
    assert_lanes_close, boards_scene, check_slice_contract, jax_camera_rays,
    jax_rect_scene_winners, jax_shade_planes, lit_scene,
    port_light_fixture_trace, scene_pair,
)

ASPECT = 16 / 9
FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_simple_light_nee.npz")
RR_START = 3
# Floats of the light sampler and density against JAX's: both evaluate
# the same float32 formulas, but square roots and transcendentals round
# differently in the last bit, and two of the formulas cancel: a sphere
# light's cone density 1 / (2 pi (1 - cos_max)) for a small cone and the
# distance to its cap cos_ray - sqrt(disc). Measured over 16384 points on
# three light sets: directions equal or within 1e-6, distances and
# densities within 3.0e-5 relative; the bound is about three times that.
LIGHT_RTOL = 1e-4
LIGHT_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_lights(name):
    if name == "lit":
        return jlights.build_light_table(lit_scene(jbuild.SceneBuilder()))
    if name == "boards":
        b = jbuild.SceneBuilder()
        b.sphere((1.0, 4.0, 1.0), 0.5, b.diffuse_light_color((2.0, 3.0, 4.0)))
        return jlights.build_light_table(boards_scene(b))
    return jlights.build_light_table(jpresets.from_name(name, ASPECT)[0])


def _port_lights(name):
    if name == "lit":
        return lights.build_light_table(lit_scene(SceneBuilder()))
    if name == "boards":
        b = SceneBuilder()
        b.sphere((1.0, 4.0, 1.0), 0.5, b.diffuse_light_color((2.0, 3.0, 4.0)))
        return lights.build_light_table(boards_scene(b))
    return lights.build_light_table(presets.from_name(name, ASPECT)[0])


LIGHT_SCENES = ["simple_light", "lit", "boards"]


# ---------------------------------------------------------------------------
# the light table and the light sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_light_table_equals_jax(name):
    ref, got = _jax_lights(name), _port_lights(name)
    assert got.count == ref.count >= 1
    for field in ("kind", "center", "radius", "axis", "a0", "a1", "b0", "b1",
                  "k", "tex_id", "color"):
        a, b = getattr(got, field), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_lightless_and_textured_lights():
    assert lights.build_light_table(presets.small(ASPECT)[0]) is None
    b = SceneBuilder()
    b.sphere((0.0, -100.0, 0.0), 100.0, b.lambertian_color((0.5, 0.5, 0.5)))
    b.sphere((0.0, 2.0, 0.0), 1.0, b.diffuse_light(b.noise_texture(4.0)))
    scene = b.finish()
    table = lights.build_light_table(scene)
    assert table.count == 1 and table.color is None
    ro = torch.zeros(128, 3)
    rd = torch.tensor([[0.0, 1.0, 0.0]] * 128)
    with pytest.raises(ValueError, match="not ported yet"):
        tfp.trace_fast(scene, ro, rd, torch.zeros(128), 1, 4,
                       SceneFeatures.from_scene(scene), nee_lights=table)


def _points_and_uniforms(n=4096, seed=3):
    """Shading points around the scenes (some inside the sphere lights)
    and the three uniforms of a light sample."""
    g = np.random.default_rng(seed)
    p = g.uniform((-6.0, -1.0, -6.0), (6.0, 9.0, 6.0), (n, 3)).astype(np.float32)
    u = g.random((3, n), dtype=np.float32)
    return p, u


def _sample_both(name, p, u):
    ref = jlights.sample_light_dirs_planes(
        _jax_lights(name), *(jnp.asarray(c) for c in (*p.T, *u)))
    got = lights.sample_light_dirs_planes(
        _port_lights(name), *(_t(c) for c in (*p.T, *u)))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_sample_light_dirs_matches_jax(name):
    p, u = _points_and_uniforms()
    ref, got = _sample_both(name, p, u)
    wix, wiy, wiz, dist, pdf, idx, valid = got
    assert idx.dtype == np.int32 and valid.dtype == bool
    np.testing.assert_array_equal(idx, ref[5])
    np.testing.assert_array_equal(valid, ref[6])
    assert valid.mean() > 0.5 and (~valid).any()  # inside a sphere light
    for k, what in enumerate(("wix", "wiy", "wiz", "dist", "pdf")):
        np.testing.assert_allclose(got[k], ref[k], rtol=LIGHT_RTOL,
                                   atol=LIGHT_ATOL, err_msg=what)
    norm = np.sqrt(wix ** 2 + wiy ** 2 + wiz ** 2)[valid]
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)


@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_light_dir_pdf_matches_jax(name):
    """At the sampled directions (each meets its light) and at random
    ones (most meet none)."""
    p, u = _points_and_uniforms(seed=5)
    _, got = _sample_both(name, p, u)
    g = np.random.default_rng(6).normal(size=(p.shape[0], 3))
    rand = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    for dirs in (np.stack(got[:3], axis=1), rand):
        ref = np.asarray(jlights.light_dir_pdf_planes(
            _jax_lights(name), *(jnp.asarray(c) for c in (*p.T, *dirs.T))))
        pdf = lights.light_dir_pdf_planes(
            _port_lights(name), *(_t(c) for c in (*p.T, *dirs.T))).numpy()
        np.testing.assert_array_equal(pdf > 0.0, ref > 0.0)
        np.testing.assert_allclose(pdf, ref, rtol=LIGHT_RTOL, atol=0.0)
    # the sampled directions meet the light they were drawn from
    hit = got[6] & (np.asarray(got[4]) > 0)
    assert (pdf_at := lights.light_dir_pdf_planes(
        _port_lights(name), *(_t(c) for c in (*p.T, *got[:3]))).numpy()
    )[hit].min() > 0.0 and pdf_at.shape == hit.shape


def test_nearest_t_only_matches_jax():
    """Shadow rays of sampled light directions from points on the
    ``simple_light`` ground and sphere: t under K1's lane contract."""
    jscene, _, scene = scene_pair("simple_light", ASPECT)
    feats = SceneFeatures.from_scene(scene)
    g = np.random.default_rng(8)
    n = 1024
    p = np.stack([g.uniform(-4, 4, n), g.uniform(0.0, 4.0, n),
                  g.uniform(-4, 4, n)], axis=1).astype(np.float32)
    u = g.random((3, n), dtype=np.float32)
    wi = np.stack(lights.sample_light_dirs_planes(
        _port_lights("simple_light"), *(_t(c) for c in (*p.T, *u)))[:3],
        axis=1).astype(np.float32)
    time = np.zeros(n, np.float32)
    ref = np.asarray(jfp.nearest_t_only(
        jscene, jnp.asarray(p), jnp.asarray(wi), jnp.asarray(time),
        JFeatures.from_scene(jscene)))
    tables = tfp.prep_tables(scene, feats)
    got = tfp.nearest_t_only(tables, _t(np.concatenate([p.T, wi.T])),
                             _t(time), feats).numpy()
    hit = ref < 1e30  # the lights themselves are hit too
    assert hit.mean() > 0.2
    assert ((got < 1e30) == hit).mean() >= 0.995
    assert_lanes_close(got, ref, rtol=1e-3, atol=0.0, what="shadow t")


# ---------------------------------------------------------------------------
# K2's emit_scale entry and its extra outputs
# ---------------------------------------------------------------------------

def test_k2_emit_scale_and_extra_rows_match_jax():
    jscene, jcam, scene = scene_pair("simple_light", ASPECT)
    feats = SceneFeatures.from_scene(scene)
    jfeat = JFeatures.from_scene(jscene)
    tables = tfp.prep_tables(scene, feats)
    flags = tfp.feature_flags(feats) | shade_kernel.FLAG_EMIT_SCALE
    table = tables.table.numpy()
    n = 1024
    ro, rd, tm = jax_camera_rays(jcam, n, seed=1)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm), nee=True)
    g = np.random.default_rng(2)
    lit = 0
    for depth in range(2):
        st.planes[shade_kernel.ESC] = _t(g.random(n, dtype=np.float32))
        planes = st.planes.numpy()
        t, idx = jax_rect_scene_winners(jscene, planes[0:3].T, planes[3:6].T)
        esc = planes[shade_kernel.ESC]
        ref = jax_shade_planes(jscene, table, t, idx, st, 11, depth, 8,
                               emit_scale=esc)
        out, alive = shade_kernel.shade_from_winners(
            tables.table, _t(idx), _t(t), st.planes, st.time, st.alive,
            st.lane, 11, depth, 8, tables.sky4, flags)
        assert out.shape == (19, n)
        for k, name in enumerate(PLANE_NAMES):
            assert_lanes_close(out[k].numpy(), ref[k],
                               what=f"depth {depth} {name}")
        assert (alive.numpy() == (ref[12] > 0.5)).mean() >= 0.995
        np.testing.assert_array_equal(out[shade_kernel.ESC].numpy(), esc)
        # the normal and albedo rows against the reference's NEE-tail twins
        attrs3 = jnp.asarray(np.ascontiguousarray(
            table[idx].reshape(n // 128, 128, -1).transpose(0, 2, 1)))
        js = jfp.FastStateP(*(jnp.asarray(p) for p in planes[:6]),
                            jnp.asarray(tm),
                            *(jnp.asarray(p) for p in planes[6:12]),
                            jnp.asarray(st.alive.numpy()),
                            jnp.asarray(st.lane.numpy().astype(np.uint32)))
        nx, ny, nz, point = jfp._normal_planes(jnp.asarray(t), attrs3, js,
                                               jfeat)
        alb = jfp._albedo_planes(jnp.asarray(t), attrs3, point, jfeat)
        hit = t < 1e30
        for k, ref_k in enumerate((nx, ny, nz, *alb)):
            assert_lanes_close(out[13 + k].numpy()[hit], np.asarray(ref_k)[hit],
                               what=f"depth {depth} extra row {13 + k}")
        # the lights are hit, and their emission is scaled
        is_light = table[idx, 0] == 3.0
        lit += int((is_light & hit & st.alive.numpy()).sum())
        st = tfp.FastStateP(out[:13], st.time, alive, st.lane)
    assert lit > 0


# ---------------------------------------------------------------------------
# the trace against the committed fixture
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    """JAX's fused ``trace_fast`` with NEE and roulette from depth 3 on
    the rays of the plain ``simple_light`` fixture."""
    ref = np.load(PLAIN_FIXTURE)
    jscene, _ = jpresets.simple_light(ASPECT)
    rad, count = jfp.trace_fast(
        jscene, *(jnp.asarray(ref[k]) for k in ("rays.ro", "rays.rd",
                                                  "rays.time")),
        int(ref["seed"]), int(ref["max_depth"]), JFeatures.from_scene(jscene),
        min_size=128, nee_lights=jlights.build_light_table(jscene),
        rr_start=RR_START)
    return {"radiance": np.asarray(rad), "ray_count": np.int64(int(count)),
            "rr_start": np.int64(RR_START)}


@functools.lru_cache(maxsize=None)
def _nee_trace(compaction=True):
    ref = np.load(PLAIN_FIXTURE)
    res = port_light_fixture_trace(
        ref, min_size=128, compaction=compaction,
        nee_lights=_port_lights("simple_light"), rr_start=RR_START)
    return res.radiance.numpy(), int(res.ray_count)


def test_port_cpu_nee_trace_holds_fixture():
    ref = np.load(FIXTURE)
    rad, count = _nee_trace()
    assert int(ref["rr_start"]) == RR_START
    assert np.isfinite(rad).all()
    frac = check_slice_contract(rad, count, ref["radiance"], ref["ray_count"],
                                10, budget=DEPTH10_BUDGET)
    if frac == 0.0:
        assert count == int(ref["ray_count"])
    # shadow rays count as segments: more than the plain trace's
    assert count > int(np.load(PLAIN_FIXTURE)["ray_count"])


def test_nee_compaction_moves_the_mis_plane():
    """The MIS plane rides every compaction (lanes and rows): the
    compacted trace equals the uncompacted one bit for bit."""
    a, ca = _nee_trace(True)
    b, cb = _nee_trace(False)
    np.testing.assert_array_equal(a, b)
    assert ca == cb


def test_lightless_scene_renders_the_plain_estimator():
    from pathtrace_tpu_torch.render.progressive import render_progressive

    scene, cam = presets.small(16 / 12)
    params = Params(width=16, height=12, samples=2, max_depth=4)
    imgs = [render_progressive(scene, cam, params, 1, "cpu",
                               log=lambda _: None, nee=nee, rr_start=0).image
            for nee in (False, True)]
    np.testing.assert_array_equal(*imgs)


def test_nee_and_roulette_are_unbiased():
    """16384 camera rays over a ``simple_light`` film, traced with the
    plain estimator, NEE, and NEE with roulette from depth 3 on the same
    seed: for every pair, the per-channel mean of the per-ray differences
    within 4 of its standard errors. The pairing cancels the variance the
    estimators share (the camera rays that see a light), so the test sees
    a bias of ~1% of the image mean: NEE without K2's MIS weight reads 18
    standard errors. NEE's standard error is below the plain one's."""
    scene, _ = presets.simple_light(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    table = lights.build_light_table(scene)
    n = 16384
    rays = [_t(x) for x in jax_camera_rays(jpresets.simple_light(ASPECT)[1],
                                            n, seed=12)]
    est = {name: tfp.trace_fast(scene, *rays, 100, 10, feats, **kw)
           .radiance.double().numpy() for name, kw in (
               ("plain", {}), ("nee", {"nee_lights": table}),
               ("nee_rr", {"nee_lights": table, "rr_start": 3}))}
    for a, b in (("plain", "nee"), ("plain", "nee_rr"), ("nee", "nee_rr")):
        d = est[b] - est[a]
        se = d.std(axis=0, ddof=1) / np.sqrt(n)
        assert np.all(np.abs(d.mean(axis=0)) <= 4.0 * se), (a, b, d.mean(0), se)
    assert np.all(est["nee"].std(axis=0) < est["plain"].std(axis=0))


def test_cli_renders_nee_and_roulette(tmp_path, capsys):
    out = tmp_path / "nee.npy"
    argv = ["--device", "cpu", "-P", "simple_light", "-W", "32", "-H", "18",
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
