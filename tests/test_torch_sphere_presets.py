"""The last sphere-only presets, ``smallpt``, ``aras`` and ``final``, on the
port's wavefront path (K1, K2) and megakernel (K7) against the JAX
package. Their scenes equal the reference's leaf for leaf
(tests/test_torch_hash_tables.py runs every ported preset).

``tests/goldens/torch_port_smallpt.npz`` and ``torch_port_aras.npz`` carry
4096 camera rays of each preset made from numpy uniforms, and JAX's
results at depth 10, seed 7: the fused ``trace_fast`` radiance and
segments, the megakernel's, the megakernel's under a constant white sky
(``white.*``: a path that leaves the scene returns its throughput), and
the path state and each ray's segments after ``max_depth + 1`` rounds of
JAX's closest hit (Pallas in interpret mode) and fused shade on every
lane (``chain.*``). The card check (chip_smoke.py) holds the CUDA path to
the same file without JAX.

Measured on the CPU (rays outside 1e-3 of 4096): ``aras`` 1 on the
wavefront path, 2 through K7, 23 path states (0.56%); ``smallpt`` 0 and 0
(its radiance is black but for 1 ray: a radius-1.5 light, a black sky),
56 path states (1.37%), which ``SMALLPT_DEPTH10_BUDGET`` (3%) holds;
JAX's own path states move by 1.07% when its camera directions are one
ULP longer (:func:`test_one_ulp_nudge_moves_smallpt_paths`). So K7 is
also held per ray where ``smallpt`` shows its paths: its radiance under
the white sky and each ray's segments, to the same budget.

``final`` is the reference's empty world: the builder pads it to one dead
sphere, no kernel sweeps it, and every ray takes the gradient sky on the
wavefront path and in K7, as the reference's golden shows.

Regenerate the fixtures with
``PYTHONPATH=. python tests/test_torch_sphere_presets.py``.
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

from pathtrace_tpu.config import MAX_T, MIN_T  # noqa: E402
from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu.ops import megakernel as jmk  # noqa: E402
from pathtrace_tpu.ops.intersect_pallas import sphere_nearest_pallas_cols  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel, shade_kernel  # noqa: E402
from pathtrace_tpu_torch.ops import megakernel as tmk  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, PLANE_NAMES, SMALLPT_DEPTH10_BUDGET, check_slice_contract,
    check_smallpt_contract, jax_camera_rays, lane_close, port_bounce_chain,
    states_outside, white_sky,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FIXTURES = ("smallpt", "aras")
N_RAYS, MAX_DEPTH, SEED, UNIFORM_SEED, ASPECT = 4096, 10, 7, 2026, 16 / 9
# the path-state budget of each fixture preset (see the module docstring)
CHAIN_BUDGET = {"smallpt": SMALLPT_DEPTH10_BUDGET, "aras": DEPTH10_BUDGET}
# each preset's slice contract on radiance and segments
CONTRACT = {"aras": functools.partial(check_slice_contract,
                                      budget=DEPTH10_BUDGET),
            "smallpt": check_smallpt_contract}


def fixture_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"torch_port_{name}.npz")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_shade():
    return jax.jit(jfp._fused_shade_from_winners,
                   static_argnames=("max_depth", "features"))


def jax_bounce_chain(jscene, ro, rd, tm, seed, max_depth):
    """JAX's twin of ``port_bounce_chain``: (planes [12, R], alive [R],
    each ray's segments [R]: the rounds it entered alive)."""
    n = ro.shape[0]
    jfeat = JFeatures.from_scene(jscene)
    (j_sph, _, _, _), jsky, jgrad = jfp.prep_tables(jscene, jfeat)
    st = jfp.FastStateP(
        *(jnp.asarray(c) for c in (*ro.T, *rd.T)), jnp.asarray(tm),
        *([jnp.zeros(n, jnp.float32)] * 3), *([jnp.ones(n, jnp.float32)] * 3),
        jnp.ones(n, bool), jnp.arange(n, dtype=jnp.uint32))
    segments = np.zeros(n, np.int32)
    for depth in range(max_depth + 1):
        segments += np.asarray(st.alive)
        t, idx = sphere_nearest_pallas_cols(
            jscene.spheres, *(getattr(st, k) for k in PLANE_NAMES[:6]),
            jnp.zeros(n, jnp.float32), MIN_T, MAX_T, has_motion=False,
            cull=False)
        st = _jax_shade()(j_sph, idx, t, st, jnp.int32(seed),
                          jnp.int32(depth), max_depth, jfeat, jsky, jgrad)
    return (np.stack([np.asarray(getattr(st, k)) for k in PLANE_NAMES]),
            np.asarray(st.alive), segments)


def jax_white_sky(jscene):
    """JAX's twin of ``torch_port_util.white_sky``."""
    return dataclasses.replace(
        jscene, sky=jnp.ones_like(jscene.sky),
        use_gradient_sky=jnp.zeros_like(jscene.use_gradient_sky))


def make_fixture(name: str) -> dict:
    """Rays, JAX's fused trace, megakernel (under the preset's sky and a
    white one) and bounce chain of a preset."""
    jscene, jcam = jpresets.from_name(name, ASPECT)
    feats = JFeatures.from_scene(jscene)
    ro, rd, tm = rays = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
    jrays = tuple(jnp.asarray(x) for x in rays)
    rad, count = jfp.trace_fast(jscene, *jrays, SEED, MAX_DEPTH, feats,
                                min_size=128)
    mrad, mcount = jmk.trace_megakernel(jscene, *jrays, SEED, MAX_DEPTH, feats)
    wrad, wcount = jmk.trace_megakernel(jax_white_sky(jscene), *jrays, SEED,
                                        MAX_DEPTH, feats)
    planes, alive, segments = jax_bounce_chain(jscene, ro, rd, tm, SEED,
                                               MAX_DEPTH)
    return {"rays.ro": ro, "rays.rd": rd, "rays.time": tm,
            "radiance": np.asarray(rad), "ray_count": np.int64(int(count)),
            "mega.radiance": np.asarray(mrad),
            "mega.ray_count": np.int64(int(mcount)),
            "white.radiance": np.asarray(wrad),
            "white.ray_count": np.int64(int(wcount)),
            "chain.planes": planes, "chain.alive": alive,
            "chain.segments": segments,
            "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH)}


def _rays(ref):
    return tuple(_t(ref[k]) for k in ("rays.ro", "rays.rd", "rays.time"))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_jax_regeneration(name):
    ref = np.load(fixture_path(name))
    new = make_fixture(name)
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    for key in ("rays.ro", "rays.rd", "rays.time", "seed", "max_depth"):
        assert np.array_equal(ref[key], new[key]), key
    # XLA's CPU code may round differently on another host: the results
    # are held to the contracts, not to bits
    for prefix in ("", "mega."):
        CONTRACT[name](new[prefix + "radiance"], new[prefix + "ray_count"],
                       ref[prefix + "radiance"], ref[prefix + "ray_count"],
                       MAX_DEPTH)
    check_slice_contract(new["white.radiance"], new["white.ray_count"],
                         ref["white.radiance"], ref["white.ray_count"],
                         MAX_DEPTH, budget=CHAIN_BUDGET[name])
    out = states_outside(new["chain.planes"], new["chain.alive"],
                         ref["chain.planes"], ref["chain.alive"])
    assert out.mean() <= CHAIN_BUDGET[name]
    assert (new["chain.segments"] != ref["chain.segments"]).mean() <= (
        CHAIN_BUDGET[name])


@pytest.mark.parametrize("name", FIXTURES)
def test_port_cpu_trace_holds_fixture(name):
    """The wavefront path (plain K1 and K2 at every bounce, the ladder
    and compaction) against JAX's fused trace."""
    ref = np.load(fixture_path(name))
    scene, _ = presets.from_name(name, ASPECT)
    calls = intersect_kernel.PLAIN_CALLS
    res = tfp.trace_fast(scene, *_rays(ref), int(ref["seed"]), MAX_DEPTH,
                         SceneFeatures.from_scene(scene), min_size=128)
    assert intersect_kernel.PLAIN_CALLS == calls + MAX_DEPTH + 1
    rad = res.radiance.numpy()
    assert np.isfinite(rad).all() and rad.shape == (N_RAYS, 3)
    frac = CONTRACT[name](rad, res.ray_count, ref["radiance"],
                          ref["ray_count"], MAX_DEPTH)
    print(f"\n{name}: {frac:.4%} of rays outside 1e-3 (wavefront)")


@pytest.mark.parametrize("name", FIXTURES)
def test_port_cpu_megakernel_holds_fixture(name):
    """The plain K7 against JAX's megakernel: the preset's contract, the
    segments within 1%, and each ray's segments equal to JAX's bounce
    chain's on all but the preset's path budget of the rays."""
    ref = np.load(fixture_path(name))
    scene, _ = presets.from_name(name, ASPECT)
    work = {}
    rad, count = tmk.trace_megakernel(tmk.prep_tables(scene), *_rays(ref),
                                      int(ref["seed"]), MAX_DEPTH,
                                      SceneFeatures.from_scene(scene),
                                      work=work)
    frac = CONTRACT[name](rad.numpy(), count, ref["mega.radiance"],
                          ref["mega.ray_count"], MAX_DEPTH)
    assert abs(int(count) - int(ref["mega.ray_count"])) <= (
        0.01 * int(ref["mega.ray_count"]))
    seg_frac = (work["ray_segments"].numpy() != ref["chain.segments"]).mean()
    print(f"\n{name}: {frac:.4%} of rays outside 1e-3, {seg_frac:.4%} with "
          f"other segments (K7)")
    assert seg_frac <= CHAIN_BUDGET[name], seg_frac


@pytest.mark.parametrize("name", FIXTURES)
def test_port_cpu_megakernel_holds_white_sky_fixture(name):
    """The plain K7 under a white sky against JAX's megakernel there, ray
    by ray: an escaping path returns its throughput, so the radiance shows
    each bounce (on ``smallpt`` most rays leave through its open front)
    and is held to the preset's path budget."""
    ref = np.load(fixture_path(name))
    scene, _ = presets.from_name(name, ASPECT)
    lit = ~lane_close(ref["white.radiance"], 0.0).all(axis=1)
    assert lit.mean() > 0.5, lit.mean()
    scene = white_sky(scene)
    rad, count = tmk.trace_megakernel(tmk.prep_tables(scene), *_rays(ref),
                                      int(ref["seed"]), MAX_DEPTH,
                                      SceneFeatures.from_scene(scene))
    frac = check_slice_contract(rad.numpy(), count, ref["white.radiance"],
                                ref["white.ray_count"], MAX_DEPTH,
                                budget=CHAIN_BUDGET[name])
    print(f"\n{name}: {lit.mean():.2%} of rays lit under the white sky, "
          f"{frac:.4%} outside 1e-3 (K7)")


@pytest.mark.parametrize("name", FIXTURES)
def test_port_cpu_paths_hold_fixture(name):
    """Each bounce's state, not only the radiance: the port's plain K1 and
    K2 chained over every lane against JAX's chain, at most the preset's
    budget of path states outside 1e-3 after ten bounces."""
    ref = np.load(fixture_path(name))
    scene, _ = presets.from_name(name, ASPECT)
    planes, alive = port_bounce_chain(scene, *_rays(ref), int(ref["seed"]),
                                      MAX_DEPTH)
    out = states_outside(planes.numpy(), alive.numpy(), ref["chain.planes"],
                         ref["chain.alive"])
    print(f"\n{name}: {int(out.sum())} path states ({out.mean():.4%}) "
          f"outside 1e-3 after {MAX_DEPTH} bounces")
    assert out.mean() <= CHAIN_BUDGET[name], out.mean()


def test_one_ulp_nudge_moves_smallpt_paths():
    """The room ``SMALLPT_DEPTH10_BUDGET`` gives is the estimator's own:
    JAX's bounce chain with the fixture's camera directions moved by one
    ULP leaves 1e-3 on about as many path states as the port does."""
    ref = np.load(fixture_path("smallpt"))
    jscene, _ = jpresets.smallpt(ASPECT)
    ro, rd, tm = (ref[k] for k in ("rays.ro", "rays.rd", "rays.time"))
    nudged = np.nextafter(rd, np.float32(np.inf)).astype(np.float32)
    planes, alive, _ = jax_bounce_chain(jscene, ro, nudged, tm, SEED,
                                        MAX_DEPTH)
    out = states_outside(planes, alive, ref["chain.planes"],
                         ref["chain.alive"])
    print(f"\nsmallpt: a 1-ULP nudge moves {out.mean():.4%} of JAX's paths")
    assert DEPTH10_BUDGET / 2 < out.mean() <= SMALLPT_DEPTH10_BUDGET


def test_final_every_ray_takes_the_sky():
    """``final``: one dead sphere and no other primitive. K1 (plain) on its
    operand misses everywhere; the wavefront path (which skips the sweep
    in a scene without spheres) and the plain K7 give every ray the
    gradient sky and one segment, as JAX's fused trace does."""
    scene, cam = presets.final(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    assert scene.spheres.center.shape[0] == 1 and not scene.spheres.mask.any()
    assert not feats.has_spheres and tfp.fastpath_supported(feats, scene)
    jscene, jcam = jpresets.final(ASPECT)
    ro, rd, tm = rays = jax_camera_rays(jcam, 1024, seed=1)
    tables = tfp.prep_tables(scene, feats)
    t, idx = intersect_kernel.sphere_nearest(tables.soa, torch.from_numpy(
        np.ascontiguousarray(np.concatenate([ro.T, rd.T]))))
    assert (t.numpy() == np.float32(MAX_T)).all() and (idx.numpy() == 0).all()
    sky_t = 0.5 * (rd[:, 1] + np.float32(1.0))
    sky = np.stack([(1.0 - sky_t) + sky_t * np.float32(g)
                    for g in (0.15, 0.21, 0.30)], axis=1)
    res = tfp.trace_fast(scene, *(_t(x) for x in rays), SEED, 8, feats)
    rad, count = tmk.trace_megakernel(tmk.prep_tables(scene),
                                      *(_t(x) for x in rays), SEED, 8, feats)
    jrad, jcount = jfp.trace_fast(jscene, *(jnp.asarray(x) for x in rays),
                                  SEED, 8, JFeatures.from_scene(jscene))
    np.testing.assert_allclose(np.asarray(jrad), sky, rtol=1e-6, atol=1e-6)
    for got, n in ((res.radiance.numpy(), res.ray_count), (rad.numpy(), count)):
        np.testing.assert_allclose(got, sky, rtol=1e-6, atol=1e-6)
        assert int(n) == int(jcount) == 1024
    # K2 on an all-miss wavefront: the winner is the dead row 0
    st = tfp.make_state(*(_t(x) for x in rays))
    planes, alive = shade_kernel.shade_from_winners(
        tables.table, idx, t, st.planes, st.time, st.alive, st.lane, SEED, 0,
        8, tables.sky4, tfp.feature_flags(feats))
    np.testing.assert_allclose(planes[6:9].T.numpy(), sky, rtol=1e-6,
                               atol=1e-6)
    assert not alive.any()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name in FIXTURES:
        path = fixture_path(name)
        np.savez_compressed(path, **make_fixture(name))
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
