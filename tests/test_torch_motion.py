"""Moving spheres in the port against the JAX package: the motion-blurred
``random`` preset (391 of its 488 spheres move over the shutter).

* K3, the moving-sphere closest hit. Its plain version is the exact IEEE
  float32 evaluation of the reference's expanded form (checked bit for
  bit against numpy, on ``random`` and on a scene whose spheres move along
  every axis with their own shutters), equals K1's plain version bit for
  bit on static spheres (delta = 0, inv_dt = 0), and agrees with
  ``sphere_nearest_pallas(..., has_motion=True)`` (Pallas in interpret
  mode) to 1e-3 in t with at least 99.5% of the indices equal: XLA rounds
  the expanded terms differently, as for K1 (tests/test_torch_kernels.py).
  Measured on 1000 camera rays of ``random``: all hits and indices agree,
  t to 5.7e-5 relative.
* K2 with the motion flag over three chained bounces against JAX's
  ``_fused_shade_from_winners``, under the lane contract.
* K6 for moving spheres: its plain version against JAX's
  ``_vjp_bwd(has_motion=True)`` leaf by leaf (centre, delta, time0,
  inv_dt, radius, ro, rd, time), each to 1e-5 of the magnitude of the
  terms it sums.
* ``trace_fast`` against the committed fixture
  ``tests/goldens/torch_port_random.npz`` (4096 primary rays made from
  numpy uniforms, time included, depth 10, seed 7), regenerated here with
  JAX: the slice contract with ``DEPTH10_BUDGET`` (1%). Measured on the
  CPU: 0.05% of rays outside after 1 bounce, 0.20% after 2, 0.29% after 3,
  0.44% after 5, 0.49% after 10.
* ``trace_fast_diff`` at depth 4 against JAX per leaf
  (``MOTION_GRAD_TOL``), and the committed gradient fixture
  ``tests/goldens/torch_port_grad_random.npz`` (``MOTION_FIXTURE_GRAD_TOL``).

Regenerate both fixtures with ``PYTHONPATH=. python tests/test_torch_motion.py``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.config import MAX_T, MIN_T  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu.ops import intersect_pallas as jip  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel as tik  # noqa: E402
from pathtrace_tpu_torch.ops import shade_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, MOTION_FIXTURE_GRAD_TOL, MOTION_GRAD_TOL, PLANE_NAMES,
    assert_grads_close, assert_lanes_close, check_slice_contract,
    jax_camera_rays, jax_trace_vjp, lane_close, numpy_uniforms, port_grads,
    port_trace_diff, scene_pair,
)

ASPECT = 16 / 9
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FIXTURE = os.path.join(GOLDENS, "torch_port_random.npz")
GRAD_FIXTURE = os.path.join(GOLDENS, "torch_port_grad_random.npz")
N_RAYS, MAX_DEPTH, SEED, UNIFORM_SEED = 4096, 10, 7, 2024
GRAD_RAYS, GRAD_DEPTH = 2048, 4
FIXTURE_TIGHT = 1e-5  # the gradient fixture keeps rays that agree to this


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays6(ro, rd):
    return _t(np.concatenate([ro.T, rd.T]))


def _jax_nearest(spheres, ro, rd, tm):
    t, idx = jip.sphere_nearest_pallas(spheres, jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.asarray(tm),
                                       MIN_T, MAX_T, has_motion=True)
    return np.asarray(t), np.asarray(idx)


@pytest.fixture(scope="module")
def cover():
    """The ``random`` pair, 1000 camera rays (ragged for both packages)
    and, from each camera hit, a Lambertian-scattered ray at the same
    time, with JAX's winners of both sets."""
    jscene, jcam, scene = scene_pair("random", ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, 1000, seed=5)
    t, idx = _jax_nearest(jscene.spheres, ro, rd, tm)
    hit = t < 1e30
    sp = scene.spheres
    u = (tm - sp.time0.numpy()[idx]) * sp.inv_time_delta.numpy()[idx]
    c = sp.center.numpy()[idx] + u[:, None] * sp.center_delta.numpy()[idx]
    p = (ro + np.where(hit, t, 0.0)[:, None] * rd).astype(np.float32)
    g = np.random.default_rng(6).normal(size=(1000, 3))
    d = np.where(hit[:, None], (p - c) / sp.radius.numpy()[idx][:, None]
                 + g / np.linalg.norm(g, axis=1, keepdims=True), g)
    rd2 = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = {"camera": (ro, rd, tm, t, idx),
            "scattered": (p, rd2, tm, *_jax_nearest(jscene.spheres, p, rd2, tm))}
    return jscene, scene, rays


def _general_motion_scene():
    """Spheres moving along every axis with their own shutters, and a few
    static ones: c.delta and |delta|^2 are sums of three non-zero terms."""
    rng = np.random.default_rng(8)
    b = SceneBuilder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5, 0.5, 0.5)))
    mat = b.lambertian_color((0.2, 0.4, 0.6))
    for k in range(200):
        c0 = rng.uniform(-8.0, 8.0, 3) * (1.0, 0.1, 1.0) + (0.0, 0.4, 0.0)
        if k % 5 == 0:
            b.sphere(c0, 0.3, mat)
        else:
            t0 = float(rng.uniform(-0.5, 0.3))
            b.moving_sphere(c0, c0 + rng.normal(size=3) * 0.4, t0,
                            t0 + float(rng.uniform(0.5, 2.0)), 0.3, mat)
    return b.finish(pad_multiple=128, spatial_sort=True)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rays", ["camera", "scattered"])
def test_k3_plain_matches_pallas(rays, cover):
    _, scene, sets = cover
    ro, rd, tm, t_ref, i_ref = sets[rays]
    soa = tfp.build_sphere_soa(scene, motion=True)
    t, idx = tik.sphere_nearest_moving(soa, _rays6(ro, rd), _t(tm))
    t, idx = t.numpy(), idx.numpy()
    assert (t_ref < 1e30).mean() > 0.3
    assert ((t < 1e30) == (t_ref < 1e30)).mean() >= 0.995
    assert_lanes_close(t, t_ref, rtol=1e-3, atol=0.0, what=f"{rays} t")
    assert (idx == i_ref).mean() >= 0.995


def _f32_moving_nearest(soa, ro, rd, tm):
    """K3's arithmetic in numpy float32, every operation IEEE-rounded on
    its own: (t [R], first index of the minimum [R])."""
    f = np.float32
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in (*ro.T, *rd.T))
    cx, cy, cz, cc, mask, mx, my, mz, t0, inv, cdd, d2 = (r[None, :] for r in soa)
    s = (tm[:, None] - t0) * inv
    b = ((ox * dx + oy * dy + oz * dz) - (cx * dx + cy * dy + cz * dz)
         - s * (mx * dx + my * dy + mz * dz))
    c = ((ox * ox + oy * oy + oz * oz) - f(2) * (cx * ox + cy * oy + cz * oz)
         + cc - f(2) * s * (mx * ox + my * oy + mz * oz) + f(2) * s * cdd
         + s * s * d2)
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, f(0)))
    t0_, t1_ = -b - sq, -b + sq
    ok = (disc > 0) & (mask > 0)
    inf = f(MAX_T)
    t = np.where(ok & (t0_ > f(MIN_T)) & (t0_ < inf), t0_,
                 np.where(ok & (t1_ > f(MIN_T)) & (t1_ < inf), t1_, inf))
    return t.min(axis=1), t.argmin(axis=1)


@pytest.mark.parametrize("rays", ["camera", "scattered", "general"])
def test_k3_plain_is_exact_float32_evaluation(rays, cover):
    _, scene, sets = cover
    ro, rd, tm = sets["scattered" if rays == "scattered" else "camera"][:3]
    if rays == "general":
        scene = _general_motion_scene()
        tm = (np.random.default_rng(3).random(tm.shape[0]) * 2.0
              - 0.5).astype(np.float32)
    soa = tfp.build_sphere_soa(scene, motion=True)
    if rays == "general":
        assert np.count_nonzero(soa[10].numpy()) > 150  # c.delta
    t, idx = tik.sphere_nearest_plain(soa, _rays6(ro, rd), time=_t(tm))
    t_ref, i_ref = _f32_moving_nearest(soa.numpy(), ro, rd, tm)
    np.testing.assert_array_equal(t.numpy(), t_ref)
    np.testing.assert_array_equal(idx.numpy(), i_ref)


def test_k3_equals_k1_on_static_spheres(cover):
    """``random_spheres`` with its (zero) motion operand, and ``random``
    against K1 on the rows of its static spheres alone."""
    _, _, sets = cover
    ro, rd, tm = sets["camera"][:3]
    scene, _ = presets.random_spheres(ASPECT)
    rays = _rays6(ro, rd)
    soa12 = tfp.build_sphere_soa(scene, motion=True)
    assert not soa12[5:].any()
    t3, i3 = tik.sphere_nearest_moving(soa12, rays, _t(tm))
    t1, i1 = tik.sphere_nearest(tfp.build_sphere_soa(scene), rays)
    assert torch.equal(t3, t1) and torch.equal(i3, i1)
    moving, _ = presets.random(ASPECT)
    soa12 = tfp.build_sphere_soa(moving, motion=True)
    static = (moving.spheres.inv_time_delta == 0).float()
    soa12[4] *= static  # mask the moving spheres off
    t3, i3 = tik.sphere_nearest_moving(soa12, rays, _t(tm))
    t1, i1 = tik.sphere_nearest(soa12[:5].contiguous(), rays)
    assert torch.equal(t3, t1) and torch.equal(i3, i1)


def test_k3_wrapper_counts_and_checks(cover):
    _, scene, sets = cover
    ro, rd, tm = sets["camera"][:3]
    soa = tfp.build_sphere_soa(scene, motion=True)
    calls = tik.MOVING_PLAIN_CALLS
    tik.sphere_nearest_moving(soa, _rays6(ro, rd), _t(tm))
    assert tik.MOVING_PLAIN_CALLS == calls + 1
    with pytest.raises(ValueError):
        tik.sphere_nearest_moving(soa[:5], _rays6(ro, rd), _t(tm))
    with pytest.raises(ValueError):
        tik.sphere_nearest_moving(soa, _rays6(ro, rd), _t(tm[:-1]))


# ---------------------------------------------------------------------------
# K2 with the motion flag
# ---------------------------------------------------------------------------

def test_shade_chain_with_motion_matches_jax():
    jscene, jcam, scene = scene_pair("random", 1.0)
    jfeat = JFeatures.from_scene(jscene)
    (j_sph, j_rect, _, _), jsky, jgrad = jfp.prep_tables(jscene, jfeat)
    j_table = jnp.concatenate([j_sph, j_rect])
    jax_shade = jax.jit(jfp._fused_shade_from_winners,
                        static_argnames=("max_depth", "features"))
    feats = SceneFeatures.from_scene(scene)
    flags = tfp.feature_flags(feats)
    assert flags & shade_kernel.FLAG_MOTION
    tables = tfp.prep_tables(scene, feats)
    ro, rd, tm = jax_camera_rays(jcam, 1024, seed=0)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm))
    for depth in range(3):
        planes = st.planes.numpy()
        t, idx = _jax_nearest(jscene.spheres, planes[0:3].T, planes[3:6].T, tm)
        js = jfp.FastStateP(
            *(jnp.asarray(p) for p in planes[:6]), jnp.asarray(tm),
            *(jnp.asarray(p) for p in planes[6:12]),
            jnp.asarray(st.alive.numpy()),
            jnp.asarray(st.lane.numpy().astype(np.uint32)),
        )
        ref = jax_shade(j_table, jnp.asarray(idx), jnp.asarray(t), js,
                        jnp.int32(11), jnp.int32(depth), 8, jfeat, jsky, jgrad)
        out, alive = shade_kernel.shade_from_winners(
            tables.table, _t(idx), _t(t), st.planes, st.time, st.alive,
            st.lane, 11, depth, 8, tables.sky4, flags)
        for k, name in enumerate(PLANE_NAMES):
            assert_lanes_close(out[k].numpy(), np.asarray(getattr(ref, name)),
                               what=f"depth {depth} {name}")
        agree = (alive.numpy() == np.asarray(ref.alive)).mean()
        assert agree >= 0.995, (depth, agree)
        st = tfp.FastStateP(out, st.time, alive, st.lane)


# ---------------------------------------------------------------------------
# K6 for moving spheres
# ---------------------------------------------------------------------------

def _moving_term_scales(sp, ro, rd, tm, idx, g):
    """Magnitudes of the terms each K6 gradient sums (float64), per ray
    and summed per sphere: of dt/db ``|g| (1 + |b|/s)``, of dt/dcq
    ``|g| / (2 s)``, carried through the lerp ``c = c0 + u delta``."""
    f64 = np.float64
    d = sp["center_delta"][idx].astype(f64)
    inv = sp["inv_time_delta"][idx].astype(f64)
    dt = tm.astype(f64) - sp["time0"][idx]
    u = dt * inv
    c = sp["center"][idx] + u[:, None] * d
    r = sp["radius"][idx].astype(f64)
    oc = ro.astype(f64) - c
    b = (oc * rd).sum(1)
    disc = b * b - ((oc * oc).sum(1) - r * r)
    inv_s = np.where(disc > 0, 1.0 / np.sqrt(np.maximum(disc, 1e-300)), 0.0)
    m_b = np.abs(g) * (1.0 + np.abs(b) * inv_s)
    m_q = np.abs(g) * inv_s
    s_ro = m_b[:, None] * np.abs(rd) + m_q[:, None] * np.abs(oc)
    s_u = (s_ro * np.abs(d)).sum(1)
    per_ray = {"ro": s_ro, "rd": m_b[:, None] * np.abs(oc),
               "time": s_u * np.abs(inv)}
    per_sphere = {"center": s_ro, "center_delta": s_ro * np.abs(u)[:, None],
                  "time0": s_u * np.abs(inv), "inv_time_delta": s_u * np.abs(dt),
                  "radius": m_q * np.abs(r)}
    n = sp["center"].shape[0]
    for name, v in per_sphere.items():
        acc = np.zeros((n,) + v.shape[1:])
        np.add.at(acc, idx, v)
        per_ray[name] = acc
    return per_ray


def test_k6_moving_plain_matches_jax_vjp_bwd(cover):
    jscene, scene, sets = cover
    ro, rd, tm, t, idx = sets["scattered"]
    sp = jscene.spheres
    g_t = np.random.default_rng(5).standard_normal(t.shape[0]).astype(np.float32)
    g_sp, g_ro, g_rd, g_time = jip._vjp_bwd(
        MIN_T, MAX_T, True,
        (sp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), t, idx),
        (jnp.asarray(g_t), None))
    tsp = scene.spheres
    motion = (tsp.center_delta, tsp.time0, tsp.inv_time_delta, _t(tm))
    got = tik.sphere_nearest_bwd(tsp.center, tsp.radius, _t(ro), _t(rd),
                                 _t(t), _t(idx), _t(g_t), motion=motion)
    hit = t < MAX_T
    leaves = {k: np.asarray(getattr(sp, k)) for k in
              ("center", "center_delta", "time0", "inv_time_delta", "radius")}
    scales = _moving_term_scales(leaves, ro, rd, tm, idx,
                                 np.where(hit, g_t, 0.0))
    refs = {"center": g_sp.center, "radius": g_sp.radius, "ro": g_ro,
            "rd": g_rd, "center_delta": g_sp.center_delta,
            "time0": g_sp.time0, "inv_time_delta": g_sp.inv_time_delta,
            "time": g_time}
    for name, a in zip(("center", "radius", "ro", "rd", "center_delta",
                        "time0", "inv_time_delta", "time"), got):
        a, b = a.numpy().astype(np.float64), np.asarray(refs[name], np.float64)
        assert np.abs(b).max() > 0, name
        bound = 1e-5 * (np.abs(b) + scales[name]) + 1e-7
        worst = float(np.max(np.abs(a - b) - bound))
        assert worst <= 0.0, f"g_{name}: {worst}"
    assert np.all(got[7].numpy()[~hit] == 0)  # misses get exactly nothing


def test_sphere_nearest_function_with_motion_is_k3_and_k6(cover):
    """SphereNearest with the motion leaves: forward = K3, backward = K6
    with motion (one call, counted), gradients to every float leaf."""
    _, scene, sets = cover
    ro, rd, tm = (_t(x) for x in sets["camera"][:3])
    sp = scene.spheres
    leaves = [x.clone().requires_grad_(True) for x in
              (sp.center, sp.radius, sp.center_delta, sp.time0,
               sp.inv_time_delta)]
    ro = ro.clone().requires_grad_(True)
    tm = tm.clone().requires_grad_(True)
    soa = tfp.build_sphere_soa(scene, motion=True)
    center, radius, delta, time0, inv_dt = leaves
    t, idx = tik.SphereNearest.apply(soa, center, radius, ro, rd, delta,
                                     time0, inv_dt, tm)
    t_ref, idx_ref = tik.sphere_nearest_moving(soa, _rays6(ro.detach().numpy(),
                                                            rd.numpy()), tm.detach())
    assert torch.equal(t, t_ref) and torch.equal(idx, idx_ref)
    calls = tik.BWD_PLAIN_CALLS
    g = _t(np.random.default_rng(1).standard_normal(t.shape[0]).astype(np.float32))
    grads = torch.autograd.grad((g * torch.where(t < MAX_T, t, 0.0)).sum(),
                                (*leaves, ro, tm))
    assert tik.BWD_PLAIN_CALLS == calls + 1
    ref = tik.sphere_nearest_bwd_plain(
        center, radius, ro, rd, t, idx, g,
        motion=(delta, time0, inv_dt, tm))
    for got_g, ref_g in zip(grads, (ref[0], ref[1], ref[4], ref[5], ref[6],
                                    ref[2], ref[7])):
        assert torch.equal(got_g, ref_g)
        assert got_g.abs().max() > 0


# ---------------------------------------------------------------------------
# the trace and its committed fixture
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    """4096 primary rays of ``random`` (numpy uniforms, time included)
    and the JAX fused path's radiance and segment count at depth 10."""
    from pathtrace_tpu.camera import get_rays
    from pathtrace_tpu.models import presets as jpresets

    scene, cam = jpresets.random(ASPECT)
    s, t, u = numpy_uniforms(N_RAYS, seed=UNIFORM_SEED)
    ro, rd, tm = get_rays(cam, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u))
    rad, count = jfp.trace_fast(scene, ro, rd, tm, SEED, MAX_DEPTH,
                                JFeatures.from_scene(scene), min_size=128)
    return {"rays.ro": np.asarray(ro), "rays.rd": np.asarray(rd),
            "rays.time": np.asarray(tm), "radiance": np.asarray(rad),
            "ray_count": np.int64(int(count)), "seed": np.int64(SEED),
            "max_depth": np.int64(MAX_DEPTH)}


def _port_trace(ref, **kw):
    scene, _ = presets.random(ASPECT)
    return tfp.trace_fast(scene, *(_t(ref[k]) for k in
                                   ("rays.ro", "rays.rd", "rays.time")),
                          int(ref["seed"]), int(ref["max_depth"]),
                          SceneFeatures.from_scene(scene), **kw)


def test_fixture_matches_jax_regeneration():
    ref = np.load(FIXTURE)
    new = make_fixture()
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    for key in new:
        if key not in ("radiance", "ray_count"):
            assert np.array_equal(ref[key], new[key]), key
    assert (new["rays.time"].min() >= 0.0 and new["rays.time"].max() < 1.0
            and new["rays.time"].std() > 0.2)
    check_slice_contract(new["radiance"], new["ray_count"], ref["radiance"],
                         ref["ray_count"], MAX_DEPTH, budget=DEPTH10_BUDGET)


def test_port_cpu_trace_holds_fixture():
    """The port's plain trace (K3 and K2 plain at every bounce, no cull)
    of the fixture's rays, with the port's own ``random`` preset (equal
    to the JAX scene leaf for leaf)."""
    ref = np.load(FIXTURE)
    counts = (tik.MOVING_PLAIN_CALLS, tik.PLAIN_CALLS, tik.FLAT_PLAIN_CALLS,
              tik.HIER_PLAIN_CALLS)
    res = _port_trace(ref, min_size=128)
    assert tik.MOVING_PLAIN_CALLS == counts[0] + MAX_DEPTH + 1
    assert (tik.PLAIN_CALLS, tik.FLAT_PLAIN_CALLS,
            tik.HIER_PLAIN_CALLS) == counts[1:]
    check_slice_contract(res.radiance.numpy(), res.ray_count, ref["radiance"],
                         ref["ray_count"], MAX_DEPTH, budget=DEPTH10_BUDGET)


def test_compaction_bit_identical_on_random():
    ref = np.load(FIXTURE)
    a = _port_trace(ref, min_size=128)
    b = _port_trace(ref, compaction=False)
    assert a.readbacks > 0
    assert torch.equal(a.radiance, b.radiance)
    assert int(a.ray_count) == int(b.ray_count)


def test_frame_path_takes_k3_without_tiles():
    """Moving scenes take neither the culls nor tile order (the
    reference's rule): the frame chain is K3 in raster order."""
    scene, cam = presets.random(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    assert feats.has_motion and not tfp.cull_scene(scene, feats)
    assert not tfp.tile_layout(scene, feats, 720, 1280)
    tables = tfp.prep_tables(scene, feats)
    assert tables.cull is None and tuple(tables.soa.shape) == (12, 512)


# ---------------------------------------------------------------------------
# the differentiable trace, the trainer and the gradient fixture
# ---------------------------------------------------------------------------

def test_trace_fast_diff_matches_jax():
    jscene, jcam, scene = scene_pair("random", ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, GRAD_RAYS, seed=1)
    rad, params, names = port_trace_diff(scene, ro, rd, tm, SEED, GRAD_DEPTH)
    assert "spheres.center_delta" in names
    got = rad.detach().numpy()
    ref_rad, jgrads, jnames = jax_trace_vjp(jscene, ro, rd, tm, SEED,
                                             GRAD_DEPTH)
    assert names == jnames
    assert_lanes_close(got, ref_rad, what="radiance")
    w0 = np.random.default_rng(9).standard_normal((GRAD_RAYS, 3)).astype(np.float32)
    for tight, tol in ((1e-3, MOTION_GRAD_TOL), (1e-6, None)):
        w = w0 * lane_close(got, ref_rad, tight, tight).all(axis=1)[:, None]
        got_g = port_grads(rad, params, w)
        assert np.abs(got_g[names.index("spheres.center_delta")]).max() > 0
        assert_grads_close(got_g, jgrads(w), names,
                            tol or {n: 1e-3 for n in names},
                            f"rays within {tight}")


def test_example_trains_random_on_cpu(tmp_path, capsys):
    from pathtrace_tpu_torch.examples import inverse_render

    rc = inverse_render.main([
        "--device", "cpu", "--preset", "random", "--trainable", "default",
        "--steps", "1", "--size", "16", "--samples", "2", "--depth", "2",
        "--out", str(tmp_path / "inv.npy")])
    log = capsys.readouterr().out
    assert rc == 0, log
    loss = re.search(r"step 1/1: loss ([\d.]+),", log)
    assert loss and np.isfinite(float(loss.group(1)))
    moved = dict(re.findall(r"(\S+) ([\d.]+)(?:,|$)",
                            log.split("largest parameter change:")[1]
                            .splitlines()[0]))
    assert "spheres.center_delta" in moved, moved
    assert all(float(m) > 0 for m in moved.values()), moved


def make_grad_fixture() -> dict:
    """2048 camera rays of ``random``, the seed, weights zero on rays
    where the port's CPU trace and JAX's differ by more than
    ``FIXTURE_TIGHT``, and JAX's radiance and per-leaf gradients of
    ``trace_fast_diff`` at depth 4."""
    jscene, jcam, scene = scene_pair("random", ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, GRAD_RAYS, seed=11)
    rad, _, _ = port_trace_diff(scene, ro, rd, tm, SEED, GRAD_DEPTH)
    ref_rad, jgrads, names = jax_trace_vjp(jscene, ro, rd, tm, SEED,
                                            GRAD_DEPTH)
    w = np.random.default_rng(13).standard_normal((GRAD_RAYS, 3)).astype(np.float32)
    w = w * lane_close(rad.detach().numpy(), ref_rad, FIXTURE_TIGHT,
                       FIXTURE_TIGHT).all(axis=1)[:, None]
    out = {"rays.ro": ro, "rays.rd": rd, "rays.time": tm, "w": w,
           "radiance": ref_rad, "seed": np.int64(SEED),
           "max_depth": np.int64(GRAD_DEPTH), "names": np.array(names)}
    out.update({f"grad.{n}": g for n, g in zip(names, jgrads(w))})
    return out


def test_grad_fixture_matches_jax_regeneration():
    ref = np.load(GRAD_FIXTURE)
    new = make_grad_fixture()
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    for key in ("rays.ro", "rays.rd", "rays.time", "seed", "max_depth",
                "names"):
        assert np.array_equal(ref[key], new[key]), key
    assert_lanes_close(new["radiance"], ref["radiance"], what="radiance")
    assert (new["w"] != 0).mean() >= 0.9
    names = list(ref["names"])
    assert_grads_close([new[f"grad.{n}"] for n in names],
                        [ref[f"grad.{n}"] for n in names], names,
                        MOTION_GRAD_TOL, "regenerated fixture")


def test_port_cpu_grads_hold_fixture():
    ref = np.load(GRAD_FIXTURE)
    scene, _ = presets.random(ASPECT)
    rad, params, names = port_trace_diff(
        scene, ref["rays.ro"], ref["rays.rd"], ref["rays.time"],
        int(ref["seed"]), int(ref["max_depth"]))
    assert names == list(ref["names"])
    assert_lanes_close(rad.detach().numpy(), ref["radiance"], what="radiance")
    assert_grads_close(port_grads(rad, params, ref["w"]),
                        [ref[f"grad.{n}"] for n in names], names,
                        MOTION_FIXTURE_GRAD_TOL, "fixture")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
    np.savez_compressed(GRAD_FIXTURE, **make_grad_fixture())
    print(f"wrote {GRAD_FIXTURE} ({os.path.getsize(GRAD_FIXTURE)} bytes)")
