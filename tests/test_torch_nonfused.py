"""The fast path's non-fused bounce and its sweeps against the JAX package
(CPU).

* The [R, N] box and media sweeps (``intersect_box.box_nearest_rn``,
  ``media_nearest_rn``) equal the plane loops bit for bit (t and idx) on
  ``final_full``'s 400 boxes, on its camera rays and on scattered rays
  from their hit points, and on a scene of 24 media (slab and sphere
  boundaries, with dead entries), in one chunk and in many; both forms
  hold the reference's [R, N] ``box_nearest`` and ``media_nearest``
  (winners equal except at ties, t within the lane contract). Every
  sweep of the port takes the [R, N] form, so it is also held at 1 and
  2 primitives.
* ``final_full --nee --rr 3`` and the textured-light scene
  (``presets.image_light_scene(textured_light=True)``: noise on both
  lights; ``box=True`` adds a box, which sends it to the non-fused
  bounce) through ``trace_fast`` at depth 10 against the committed
  fixture ``tests/goldens/torch_port_nonfused.npz``: JAX's ``trace_fast``
  on the same 2048 camera rays (its XLA bounce for ``final_full`` and the
  boxed scene, its fused one with the plane-form NEE tail for the other),
  at most ``DEPTH10_BUDGET`` of the rays outside 1e-3 (measured: 0.10%,
  0%, 0%). JAX runs at XLA's backend optimisation level 0 (see the
  ``__main__`` block: its optimised build parts from the port on 2.78% /
  1.03% of the first two cases' rays). Regenerate it with
  ``PYTHONPATH=. python tests/test_torch_nonfused.py`` (JAX, CPU, ~10 min).
* The witness of that level, independent of XLA: the first bounce of
  ``final_full --nee`` in float64 numpy
  (:func:`test_first_bounce_against_float64`) shows the rays where the optimised reference and the port part as
  self-shadowed far-sphere hits in both, placed on other rays by XLA's
  FMA contraction.
* The non-fused ladder: compaction and the bounce group change no bit
  (lane ids ride along); the lanes' radiance without NEE equals the
  differentiable trace's, which runs the same bounce on every lane.
* Routing: ``auto`` takes every preset to the fast path, as the
  reference does (``tests/test_fastpath.py``), ``-B`` with ``final_full``
  too; ``trace_fast_device`` and ``--mode sharded``'s fast shards still
  refuse an image texture in a box scene (the reference runs them fused
  only).
"""

import dataclasses
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
from pathtrace_tpu_torch.config import Params  # noqa: E402
from pathtrace_tpu_torch.models import build, convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import (  # noqa: E402
    MAT_ISOTROPIC, MAT_LAMBERTIAN, MEDIUM_SPHERE, SceneFeatures,
)
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_box as ib  # noqa: E402
from pathtrace_tpu_torch.ops import lights  # noqa: E402
from pathtrace_tpu_torch.render import progressive  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, check_slice_contract, jax_camera_rays, jax_scene_leaves,
    lane_close,
)

ASPECT = 16 / 9
FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_nonfused.npz")
N_RAYS, SEED, MAX_DEPTH, UNIFORM_SEED, RR_START = 2048, 11, 10, 2027, 3
# the fixture's cases: (scene, NEE and roulette)
CASES = ("final_full_nee", "textured_light", "textured_light_box")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@functools.lru_cache(maxsize=None)
def _scenes(case):
    """(JAX scene, JAX camera, port scene) of a fixture case."""
    if case == "final_full_nee":
        jscene, jcam = jpresets.final_full(ASPECT, seed=0)
        return jscene, jcam, presets.final_full(ASPECT, seed=0)[0]
    box = case == "textured_light_box"
    return (presets.image_light_scene(
                jbuild, jpresets._procedural_earth_image(),
                textured_light=True, box=box),
            jpresets.simple_light(ASPECT)[1],
            presets.image_light_scene(build,
                                      presets._procedural_earth_image(),
                                      textured_light=True, box=box))


# ---------------------------------------------------------------------------
# the [R, N] sweeps
# ---------------------------------------------------------------------------

def _planes(ro, rd):
    return (*_t(ro).unbind(1), *_t(rd).unbind(1))


@functools.lru_cache(maxsize=None)
def _final_full_rays(kind):
    """``final_full``'s camera rays (1024), or rays scattered from their
    box hits in uniform directions."""
    jscene, jcam, scene = _scenes("final_full_nee")
    ro, rd, _ = jax_camera_rays(jcam, 1024, seed=4)
    if kind == "camera":
        return ro, rd
    t, _ = ib.box_nearest(scene.boxes, *_planes(ro, rd))
    hit = (t < 1e30).numpy()
    p = ro + np.where(hit, t.numpy(), 10.0)[:, None] * rd
    g = np.random.default_rng(8)
    d = g.normal(size=p.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8, 0] = 0.0  # components the 1e-12 guard replaces
    return p.astype(np.float32), d


def _media_scene():
    """24 media: slab and sphere boundaries, the 5th and
    17th dead (masked), in both packages."""
    scenes = []
    for mod in (jbuild, build):
        b = mod.SceneBuilder()
        iso = b.constant_texture((0.7, 0.7, 0.7))
        b.sphere((0.0, -100.0, 0.0), 100.0, b.lambertian_color((0.5,) * 3))
        g = np.random.default_rng(12)
        for i in range(24):
            c = g.uniform(-4.0, 4.0, 3)
            if i % 3 == 0:
                b.medium_sphere(tuple(c), float(g.uniform(0.3, 1.5)),
                                float(g.uniform(0.05, 2.0)), iso)
            else:
                b.medium_box(tuple(c - 0.6), tuple(c + g.uniform(0.2, 1.0, 3)),
                             float(g.uniform(0.05, 2.0)), iso)
        scenes.append(b.finish())
    jscene, scene = scenes
    dead = np.ones(24, bool)
    dead[[4, 16]] = False
    jscene = dataclasses.replace(jscene, media=dataclasses.replace(
        jscene.media, mask=jnp.asarray(np.asarray(jscene.media.mask) & dead)))
    scene = dataclasses.replace(scene, media=dataclasses.replace(
        scene.media, mask=scene.media.mask & torch.from_numpy(dead)))
    return jscene, scene


def _media_rays(n=2048):
    g = np.random.default_rng(13)
    ro = g.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:8, 1] = 0.0
    u = g.random((n, 24), dtype=np.float32)
    return ro, rd, u


@pytest.mark.parametrize("pairs", [ib.RN_PAIRS, 50_000])
@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_box_rn_equals_plane_loop_on_final_full(kind, pairs, monkeypatch):
    """400 boxes: the [R, N] form equals the loop bit for bit, in one
    chunk and in ~8 (``RN_PAIRS`` lowered); so do their first 1 and 2."""
    monkeypatch.setattr(ib, "RN_PAIRS", pairs)
    boxes = _scenes("final_full_nee")[2].boxes
    assert boxes.count == 400
    planes = _planes(*_final_full_rays(kind))
    t, idx = ib.box_nearest(boxes, *planes)
    t_rn, idx_rn = ib.box_nearest_rn(boxes, *planes)
    assert idx_rn.dtype == idx.dtype == torch.int32
    assert torch.equal(t_rn, t) and torch.equal(idx_rn, idx)
    hits = float((t < 1e30).float().mean())
    assert hits > 0.3, hits
    for n in (1, 2):
        few = dataclasses.replace(boxes, **{
            f.name: getattr(boxes, f.name)[:n]
            for f in dataclasses.fields(boxes)})
        a, b = ib.box_nearest(few, *planes), ib.box_nearest_rn(few, *planes)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("pairs", [ib.RN_PAIRS, 10_000])
def test_media_rn_equals_plane_loop(pairs, monkeypatch):
    monkeypatch.setattr(ib, "RN_PAIRS", pairs)
    _, scene = _media_scene()
    md = scene.media
    assert md.count == 24 and not bool(md.mask[4])
    ro, rd, u = _media_rays()
    planes = _planes(ro, rd)
    uniforms = list(_t(u.T))
    t, idx = ib.media_nearest(md, *planes, uniforms)
    t_rn, idx_rn = ib.media_nearest_rn(md, *planes, uniforms)
    assert torch.equal(t_rn, t) and torch.equal(idx_rn, idx)
    hit = (t < 1e30).numpy()
    assert 0.05 < hit.mean() < 0.98
    assert not np.isin(idx.numpy()[hit], [4, 16]).any()
    # the [N, R] tensor form of the uniforms too
    t_sw, idx_sw = ib.media_nearest_rn(md, *planes, _t(u.T))
    assert torch.equal(t_sw, t) and torch.equal(idx_sw, idx)


def _winners_hold(t, idx, t_ref, i_ref):
    """Winners equal except at ties (the reference's t of both winners
    within 1e-5), t within the lane contract."""
    t, idx = t.numpy(), idx.numpy()
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    close = lane_close(t, t_ref)
    assert (~close).mean() <= 0.005, (~close).mean()
    differ = idx != i_ref
    assert np.all(np.abs(t[differ] - t_ref[differ])
                  <= 1e-5 * np.maximum(np.abs(t_ref[differ]), 1.0))
    return int(differ.sum())


@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_box_forms_hold_reference(kind):
    jscene = _scenes("final_full_nee")[0]
    boxes = _scenes("final_full_nee")[2].boxes
    ro, rd = _final_full_rays(kind)
    t_ref, i_ref = jisect.box_nearest(jscene.boxes, jnp.asarray(ro),
                                      jnp.asarray(rd))
    for fn in (ib.box_nearest, ib.box_nearest_rn):
        _winners_hold(*fn(boxes, *_planes(ro, rd)), t_ref, i_ref)


def test_media_forms_hold_reference():
    jscene, scene = _media_scene()
    ro, rd, u = _media_rays()
    t_ref, i_ref = jisect.media_nearest(jscene.media, jnp.asarray(ro),
                                        jnp.asarray(rd), jnp.asarray(u))
    uniforms = list(_t(u.T))
    for fn in (ib.media_nearest, ib.media_nearest_rn):
        _winners_hold(*fn(scene.media, *_planes(ro, rd), uniforms), t_ref,
                      i_ref)


def test_rn_form_carries_gradients_as_the_loop():
    """Autograd through the [R, N] form (the gather at the argmin) gives
    the rays the loop's gradients bit for bit, and the box leaves the
    loop's sums over their rays, taken in another order (rel 1e-6)."""
    scene = _scenes("final_full_nee")[2]
    ro, rd = _final_full_rays("camera")
    out = []
    for fn in (ib.box_nearest, ib.box_nearest_rn):
        boxes = dataclasses.replace(
            scene.boxes, p1=scene.boxes.p1.clone().requires_grad_(True))
        o = _t(ro).requires_grad_(True)
        t, _ = fn(boxes, *o.unbind(1), *_t(rd).unbind(1))
        torch.where(t < 1e30, t, 0.0).sum().backward()
        out.append((boxes.p1.grad, o.grad))
    (g_box, g_ro), (g_box_rn, g_ro_rn) = out
    assert torch.equal(g_ro_rn, g_ro) and float(g_ro.abs().sum()) > 0
    assert float(g_box.abs().sum()) > 0
    torch.testing.assert_close(g_box_rn, g_box, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the traces against the committed fixture
# ---------------------------------------------------------------------------

def _kw(case, scene_or_jscene, mod_lights):
    return {"nee_lights": mod_lights.build_light_table(scene_or_jscene),
            "rr_start": RR_START}


def make_fixture() -> dict:
    """2048 camera rays (numpy uniforms) a case and JAX's ``trace_fast``
    at depth 10 with NEE and roulette from depth 3."""
    out = {}
    for case in CASES:
        jscene, jcam, _ = _scenes(case)
        ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
        rad, count = jfp.trace_fast(
            jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), SEED,
            MAX_DEPTH, JFeatures.from_scene(jscene), min_size=128,
            **_kw(case, jscene, jlights))
        out.update({f"{case}.ro": ro, f"{case}.rd": rd, f"{case}.time": tm,
                    f"{case}.radiance": np.asarray(rad),
                    f"{case}.ray_count": np.int64(int(count))})
    out.update(seed=np.int64(SEED), max_depth=np.int64(MAX_DEPTH),
               rr_start=np.int64(RR_START))
    return out


@pytest.mark.parametrize("case", CASES)
def test_port_trace_holds_fixture(case):
    ref = np.load(FIXTURE)
    jscene, jcam, scene = _scenes(case)
    # the fixture's rays are JAX's at XLA's level 0 (its __main__), whose
    # camera rounds some directions otherwise than the optimised build
    # (by up to 3e-6); the trace takes the fixture's own rays
    rays = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
    for key, val in zip(("ro", "rd", "time"), rays):
        np.testing.assert_allclose(ref[f"{case}.{key}"], val, rtol=0,
                                   atol=1e-5)
    feats = SceneFeatures.from_scene(scene)
    assert (tfp.fused_shade_supported(feats)
            == (case == "textured_light"))
    if case != "final_full_nee":
        assert lights.build_light_table(scene).color is None
    res = tfp.trace_fast(scene, *(_t(ref[f"{case}.{k}"])
                                  for k in ("ro", "rd", "time")),
                         int(ref["seed"]), int(ref["max_depth"]), feats,
                         min_size=128, **_kw(case, scene, lights))
    rad, count = res.radiance.numpy(), int(res.ray_count)
    assert np.isfinite(rad).all() and rad.shape == (N_RAYS, 3)
    frac = check_slice_contract(rad, count, ref[f"{case}.radiance"],
                                ref[f"{case}.ray_count"], MAX_DEPTH,
                                budget=DEPTH10_BUDGET)
    print(f"{case}: {frac:.4%} of rays outside 1e-3, segments {count} vs "
          f"{int(ref[f'{case}.ray_count'])}")
    assert rad.mean() > 0.005


# ---------------------------------------------------------------------------
# the witness of the fixture's XLA level: the first bounce in float64
# ---------------------------------------------------------------------------

_TMIN = 1e-3
_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _f64(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      np.float64)


def _f64_nearest(scene, o, d, tm, med_u):
    """Closest hit over every sphere (moving), rect, box and sphere
    medium of ``scene`` in float64 numpy, written from the primitives'
    definitions (the exact quadratic's near root, the plane, the slab in
    object space, the free flight ``-ln(u) / density`` inside the
    boundary): (t [R], kind [R]: 0 sphere, 1 rect, 2 box, 3 medium,
    index [R])."""
    sp, rc, bx, md = scene.spheres, scene.rects, scene.boxes, scene.media
    assert sp.obj_from_world is None and rc.obj_from_world is None
    assert (md.kind.numpy() == MEDIUM_SPHERE).all()
    inf = np.inf

    def quadratic(c, r):
        oc = o[:, None] - c
        b = (oc * d[:, None]).sum(2)
        a = (d * d).sum(1)[:, None]
        disc = b * b - a * ((oc * oc).sum(2) - r * r)
        sq = np.sqrt(np.maximum(disc, 0.0))
        return disc, (-b - sq) / a, (-b + sq) / a

    c = _f64(sp.center)[None] + ((tm[:, None] - _f64(sp.time0)[None])
                                 * _f64(sp.inv_time_delta)[None])[..., None] \
        * _f64(sp.center_delta)[None]
    disc, t1, t2 = quadratic(c, _f64(sp.radius)[None])
    t_s = np.where(t1 > _TMIN, t1, np.where(t2 > _TMIN, t2, inf))
    t_s = np.where((disc > 0) & sp.mask.numpy()[None], t_s, inf)
    t_r = []
    for j in range(rc.count):
        ax = int(rc.axis[j])
        a, b = _AXES[ax]
        t = (float(rc.k[j]) - o[:, ax]) / d[:, ax]
        pa, pb = o[:, a] + t * d[:, a], o[:, b] + t * d[:, b]
        ok = ((pa >= float(rc.a0[j])) & (pa <= float(rc.a1[j]))
              & (pb >= float(rc.b0[j])) & (pb <= float(rc.b1[j]))
              & (t > _TMIN) & bool(rc.mask[j]))
        t_r.append(np.where(ok, t, inf))
    ofw = _f64(bx.obj_from_world)
    oo = np.einsum("nij,rj->rni", ofw[:, :, :3], o) + ofw[None, :, :, 3]
    dd = np.einsum("nij,rj->rni", ofw[:, :, :3], d)
    dd = np.where(np.abs(dd) < 1e-12, 1e-12, dd)
    s0 = (_f64(bx.p0)[None] - oo) / dd
    s1 = (_f64(bx.p1)[None] - oo) / dd
    tn = np.minimum(s0, s1).max(2)
    tf = np.maximum(s0, s1).min(2)
    cross = (tf > tn) & bx.mask.numpy()[None]
    t_b = np.where(cross & (tn > _TMIN), tn,
                   np.where(cross & (tn <= _TMIN) & (tf > _TMIN), tf, inf))
    disc, t1, t2 = quadratic(_f64(md.p0)[None], _f64(md.radius)[None])
    t1 = np.maximum(t1, _TMIN)
    ok = (disc > 0) & (t1 < t2) & md.mask.numpy()[None]
    t1 = np.maximum(t1, 0.0)
    flight = -np.log(med_u) / _f64(md.density)[None]
    t_m = np.where(ok & (flight < t2 - t1), t1 + flight, inf)
    per_kind = [t_s, np.stack(t_r, 1), t_b, t_m]
    best = np.stack([x.min(1) for x in per_kind], 1)
    kind = best.argmin(1)
    index = np.stack([x.argmin(1) for x in per_kind], 1)
    return best.min(1), kind, index[np.arange(o.shape[0]), kind]


def test_first_bounce_against_float64():
    """Why the fixture's JAX runs at XLA's level 0, with a witness that
    does not depend on XLA. Depth 0 of ``final_full --nee`` on the
    fixture's 2048 rays: the port's bounce and the reference's
    ``fast_bounce`` at this process's default (optimised) XLA build,
    against the first hit and the NEE shadow test in float64 numpy.

    Where the two part (18 rays at depth 0; 2.78% of the rays at depth
    10), float64 lights every one: the first hit is a sphere ~800-1170
    away, whose float32 t is off by 1e-4 to 5e-2 in either build, more
    than t_min = 1e-3, so on the rays whose rounded point lands inside
    the sphere the shadow ray meets the sphere itself. Both builds do
    this, on as many rays (measured: the port misjudges the NEE test on
    29 of 1,251 diffuse first hits, the optimised reference on 28, 24 of
    each with the point inside its sphere; neither lights a ray that
    float64 leaves dark); which rays it hits depends on whether XLA
    contracts the quadratic's products into FMAs. The port's kernels
    round each operation, as XLA does at level 0, so there the two
    agree ray for ray."""
    ref = np.load(FIXTURE)
    jscene, _, scene = _scenes("final_full_nee")
    ro, rd, tm = (ref[f"final_full_nee.{k}"] for k in ("ro", "rd", "time"))
    seed, max_depth = int(ref["seed"]), int(ref["max_depth"])
    n = ro.shape[0]
    feats = SceneFeatures.from_scene(scene)
    lt = lights.build_light_table(scene)
    tables = tfp.prep_tables(scene, feats, lights=lt)
    lane, alive = tfp.lane_ids(n, "cpu")
    state = tfp.FastState(
        ro=_t(ro), rd=_t(rd), time=_t(tm), radiance=torch.zeros(n, 3),
        throughput=torch.ones(n, 3), alive=alive, lane=lane,
        emit_scale=torch.ones(n))
    with torch.no_grad():
        port, _ = tfp.fast_bounce(tables.table, tables.soa, scene, state,
                                  seed, 0, max_depth, feats, tables=tables,
                                  rr_start=RR_START)
    jf = JFeatures.from_scene(jscene)
    jtables, sky, grad_sky = jfp.prep_tables(jscene, jf)
    jstate = jfp.FastState(
        ro=jnp.asarray(ro), rd=jnp.asarray(rd), time=jnp.asarray(tm),
        radiance=jnp.zeros((n, 3)), throughput=jnp.ones((n, 3)),
        alive=jnp.ones(n, bool), lane=jnp.arange(n, dtype=jnp.uint32),
        emit_scale=jnp.ones(n))
    jout, _ = jfp._bounce_group_jit(
        jtables, sky, grad_sky, jstate, jnp.asarray(seed, jnp.int32),
        jnp.int32(0), max_depth, jf, jscene, group=1,
        nee_lights=jlights.build_light_table(jscene), rr_start=RR_START)

    # float64: the first hit, then the light sample (the lanes' draws 5
    # and 6 on the one rect light) and its shadow ray
    def draw(k):
        return _f64(tfp.counter_uniform(lane, seed, 0, k))

    nm = scene.media.count
    o, d, t64 = _f64(ro), _f64(rd), _f64(tm)
    t_hit, kind, index = _f64_nearest(
        scene, o, d, t64, np.stack([draw(8 + j) for j in range(nm)], 1))
    mat_ids = (scene.spheres.mat_id, scene.rects.mat_id, scene.boxes.mat_id,
               scene.media.mat_id)
    mat = np.array([int(scene.materials.kind[mat_ids[k][i]])
                    for k, i in zip(kind, index)])
    diffuse = (t_hit < np.inf) & ((mat == MAT_LAMBERTIAN)
                                  | (mat == MAT_ISOTROPIC))
    assert lt.count == 1 and int(lt.kind[0]) == 1
    ax = int(lt.axis[0])
    a, b = _AXES[ax]
    p = o + np.where(diffuse, t_hit, 0.0)[:, None] * d
    lp = np.zeros_like(p)
    lp[:, ax] = float(lt.k[0])
    lp[:, a] = lt.a0[0] + draw(5) * (float(lt.a1[0]) - float(lt.a0[0]))
    lp[:, b] = lt.b0[0] + draw(6) * (float(lt.b1[0]) - float(lt.b0[0]))
    ldist = np.linalg.norm(lp - p, axis=1)
    wi = (lp - p) / ldist[:, None]
    s_t, _, _ = _f64_nearest(
        scene, p, wi, t64,
        np.stack([draw(8 + nm + j) for j in range(nm)], 1))
    sp = scene.spheres
    i = index
    centre = _f64(sp.center)[i] + ((t64 - _f64(sp.time0)[i])
                                   * _f64(sp.inv_time_delta)[i])[:, None] \
        * _f64(sp.center_delta)[i]
    facing = np.where(kind == 0, ((p - centre) * wi).sum(1) > 0.0, True)
    lit = (diffuse & (np.abs(wi[:, ax]) > 1e-6) & facing
           & ~(s_t < ldist * (1.0 - 1e-3)))

    # a lane's NEE lit it when its radiance after the bounce is not 0
    # (no camera ray here starts on a light: rects are lights, so skip
    # them)
    judged = diffuse & (kind != 1)
    rad_p, rad_j = port.radiance.numpy(), np.asarray(jout.radiance)
    lit_p, lit_j = rad_p.sum(1) > 0.0, rad_j.sum(1) > 0.0
    part = ~lane_close(rad_p, rad_j).all(axis=1)
    print(f"parted on {int(part.sum())} rays: {np.nonzero(part)[0]}")
    assert lit[part].all() and (kind[part] == 0).all()
    wrong_p = judged & (lit_p != lit)
    wrong_j = judged & (lit_j != lit)
    assert not (wrong_p & lit_p).any() and not (wrong_j & lit_j).any()
    print(f"NEE test misjudged on {int(wrong_p.sum())} (port) and "
          f"{int(wrong_j.sum())} (reference) of {int(judged.sum())} rays")
    assert wrong_p.sum() <= 1.1 * wrong_j.sum() + 1


def test_textured_light_scenes_equal_jax_leaves():
    """The boxed textured-light scene builds JAX's leaves in both
    packages (the fixture's scene is the port's)."""
    jscene, _, scene = _scenes("textured_light_box")
    ref = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    got = convert.scene_to_numpy(scene)
    for key, val in convert.scene_to_numpy(ref).items():
        assert np.array_equal(got[key], val), key


# ---------------------------------------------------------------------------
# the non-fused ladder
# ---------------------------------------------------------------------------

def _small_rays(case, n=1024):
    jcam = _scenes(case)[1]
    return tuple(_t(x) for x in jax_camera_rays(jcam, n, seed=3))


def test_nonfused_ladder_changes_no_bit(monkeypatch):
    """Compaction (rows and lanes: ``LANE_COMPACT_MAX`` lowered) and the
    bounce group leave the non-fused trace's radiance bit for bit."""
    monkeypatch.setattr(tfp, "LANE_COMPACT_MAX", 256)
    scene = _scenes("textured_light_box")[2]
    feats = SceneFeatures.from_scene(scene)
    ro, rd, tm = _small_rays("textured_light_box")
    runs = [tfp.trace_fast(scene, ro, rd, tm, 5, 8, feats, min_size=128,
                           compaction=c, group=g)
            for c, g in ((False, 1), (True, 1), (True, 3))]
    assert runs[1].readbacks > 0
    for r in runs[1:]:
        assert torch.equal(r.radiance, runs[0].radiance)
        assert int(r.ray_count) == int(runs[0].ray_count)
    # the differentiable trace runs the same bounce on every lane
    rad, segs = tfp.trace_fast_diff(scene, ro, rd, tm, 5, 8, feats)
    assert torch.equal(rad, runs[0].radiance)
    assert int(segs) == int(runs[0].ray_count)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", presets.names())
def test_every_preset_routes_auto_to_fast(name):
    """As ``tests/test_fastpath.py`` holds the reference's fast path to
    all 13 presets; the fast path's tables take their NEE lights too."""
    scene, _ = presets.from_name(name, ASPECT, seed=0)
    feats = SceneFeatures.from_scene(scene)
    assert tfp.fastpath_supported(feats, scene)
    assert progressive.route(scene, feats, "auto") == "fast"
    assert progressive.route(scene, feats, "auto", use_bvh=True) == "fast"
    nee = lights.build_light_table(scene)
    if nee is not None:
        assert tfp.prep_tables(scene, feats, lights=nee).lights is nee


def test_fused_only_paths_refuse_image_on_box():
    """``trace_fast`` takes an image on a box; the device-only trace and
    the sharded driver's fast shards do not (general shards instead)."""
    scene = _scenes("textured_light_box")[2]
    feats = SceneFeatures.from_scene(scene)
    assert tfp.fastpath_refusal(feats, scene) is None
    assert "fused_shade_supported" in tfp.fused_refusal(feats, scene)
    ro, rd, tm = _small_rays("textured_light_box", 64)
    with pytest.raises(ValueError, match="fused_shade_supported"):
        tfp.trace_fast_device(scene, ro, rd, tm, 1, 3, feats)
    lines = []
    cam = presets.simple_light(ASPECT)[1]
    res = progressive.render_progressive(
        scene, cam, Params(width=16, height=8, samples=1, max_depth=3,
                           seed=1), 1, "cpu", log=lines.append,
        mode="sharded")
    assert res.path == "sharded" and np.isfinite(res.image).all()
    assert any("general shards" in line for line in lines), lines


if __name__ == "__main__":
    # the reference at XLA's backend optimisation level 0 (read when the
    # backend starts, so set before anything runs). Its optimised CPU
    # build parts from the port on 2.78% of final_full_nee's rays and
    # 1.03% of textured_light's, by 0.4-100x: NEE shadow rays that meet
    # their own far sphere, whose rounded hit point lies inside it, on
    # other rays than the port's, as XLA contracts the quadratic's
    # products into FMAs (test_first_bounce_against_float64); at level 0
    # on 0.10% and 0%, the rays of the plain fixtures' contract
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
