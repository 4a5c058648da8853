"""The port's two kernels against the JAX package (plain versions, CPU).
The CUDA kernels against their plain versions: tests/test_torch_cuda.py.

K1, the closest hit. Its plain version is the exact IEEE float32
evaluation of the reference's formula (checked bit for bit against numpy),
and the CUDA kernel rounds the same way. Against ``sphere_nearest_pallas_cols``
(Pallas in interpret mode) it agrees only under the lane contract: the
expanded quadratic cancels (|c|^2 - r^2 of a 0.2-radius sphere ten units
away keeps few bits of r^2), and XLA rounds its terms differently (it
contracts and reorders them), which moves t by up to ~1e-4 relative in a
few percent of lanes and by more where a grazing hit flips. Measured over
20k rays: 0.01% (camera) and 0.08% (Lambertian-scattered) of lanes
outside 1e-3.

K2, the fused shade, gets the same winners (JAX's t, idx) and the same
state as ``fastpath._fused_shade_from_winners`` over three chained
bounces, under the lane contract of tests/test_shade_pallas.py: lanes
agree to 1e-3, at most 0.5% of them outside (a discrete decision flipped
on a ULP boundary: sin/cos/exp/log/rsqrt round differently in PyTorch and
XLA), alive agreement >= 99.5%.
"""

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
from pathtrace_tpu.ops.intersect_pallas import sphere_nearest_pallas_cols  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel, shade_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    PLANE_NAMES, assert_lanes_close, jax_camera_rays, scene_pair,
)


def _jax_nearest(jscene, ro, rd):
    t, idx = sphere_nearest_pallas_cols(
        jscene.spheres, *(jnp.asarray(c) for c in (*ro.T, *rd.T)),
        jnp.zeros(ro.shape[0], jnp.float32), MIN_T, MAX_T,
        has_motion=False, cull=False,
    )
    return np.asarray(t), np.asarray(idx)


def _cover_rays(kind, n=1000):
    """Camera rays of the cover scene, or once-scattered rays: from each
    camera hit, a Lambertian direction (normal + random unit vector)."""
    jscene, jcam = jpresets.random_spheres(16 / 9)
    ro, rd, _ = jax_camera_rays(jcam, n, seed=5)
    if kind == "scattered":
        t, idx = _jax_nearest(jscene, ro, rd)
        hit = t < 1e30
        ro = (ro + np.where(hit, t, 0.0)[:, None] * rd).astype(np.float32)
        c = np.asarray(jscene.spheres.center)[idx]
        r = np.asarray(jscene.spheres.radius)[idx]
        g = np.random.default_rng(6).normal(size=(n, 3))
        u = g / np.linalg.norm(g, axis=1, keepdims=True)
        d = np.where(hit[:, None], (ro - c) / r[:, None] + u, u)
        rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return jscene, ro, rd


def _port_nearest(ro, rd):
    scene, _ = presets.random_spheres(16 / 9)
    soa = tfp.build_sphere_soa(scene)
    rays6 = torch.from_numpy(np.ascontiguousarray(np.concatenate([ro.T, rd.T])))
    t, idx = intersect_kernel.sphere_nearest(soa, rays6)
    return soa.numpy(), t.numpy(), idx.numpy()


class TestClosestHit:
    @pytest.mark.parametrize("rays", ["camera", "scattered"])
    def test_plain_is_exact_float32_evaluation(self, rays):
        _, ro, rd = _cover_rays(rays)
        soa, t_got, i_got = _port_nearest(ro, rd)
        # numpy float32: every operation IEEE-rounded on its own
        f = np.float32
        ox, oy, oz, dx, dy, dz = (c[:, None] for c in (*ro.T, *rd.T))
        cx, cy, cz, cc, mask = (row[None, :] for row in soa)
        b = (ox * dx + oy * dy + oz * dz) - (cx * dx + cy * dy + cz * dz)
        c = (ox * ox + oy * oy + oz * oz) - f(2) * (cx * ox + cy * oy + cz * oz) + cc
        disc = b * b - c
        sq = np.sqrt(np.maximum(disc, f(0)))
        t0, t1 = -b - sq, -b + sq
        ok = (disc > 0) & (mask > 0)
        inf = f(MAX_T)
        t = np.where(ok & (t0 > f(MIN_T)) & (t0 < inf), t0,
                     np.where(ok & (t1 > f(MIN_T)) & (t1 < inf), t1, inf))
        np.testing.assert_array_equal(t_got, t.min(axis=1))
        np.testing.assert_array_equal(i_got, t.argmin(axis=1))

    @pytest.mark.parametrize("rays", ["camera", "scattered"])
    def test_plain_matches_pallas_cover_scene(self, rays):
        jscene, ro, rd = _cover_rays(rays)  # R = 1000: ragged for both
        t_ref, i_ref = _jax_nearest(jscene, ro, rd)
        _, t_got, i_got = _port_nearest(ro, rd)
        assert (t_ref < 1e30).mean() > 0.3
        assert ((t_got < 1e30) == (t_ref < 1e30)).mean() >= 0.995
        assert_lanes_close(t_got, t_ref, rtol=1e-3, atol=0.0, what="t")
        assert (i_got == i_ref).mean() >= 0.995

    def test_plain_ties_go_to_lowest_index(self):
        # two identical spheres (centre (0, 0, -5), r = 1): every hit ties
        soa = torch.tensor([[0.0, 0.0], [0.0, 0.0], [-5.0, -5.0],
                            [24.0, 24.0], [1.0, 1.0]])
        rays = torch.tensor([[0.0, 0.0], [0.0, 3.0], [0.0, 0.0],
                             [0.0, 0.0], [0.0, 0.0], [-1.0, 1.0]])
        t, idx = intersect_kernel.sphere_nearest(soa, rays)
        assert idx.tolist() == [0, 0]
        assert t[0].item() == 4.0 and t[1].item() == float(np.float32(MAX_T))


# "lit" adds the emission and constant-sky branches (see torch_port_util)
FUSED_PRESETS = ["small", "random_spheres", "two_perlin_spheres", "lit"]


@pytest.fixture(scope="module")
def jax_shade():
    return jax.jit(jfp._fused_shade_from_winners,
                   static_argnames=("max_depth", "features"))


class TestFusedShade:
    @pytest.mark.parametrize("preset", FUSED_PRESETS)
    def test_bounce_chain_matches_jax(self, preset, jax_shade):
        jscene, jcam, scene = scene_pair(preset, 1.0)
        jfeat = JFeatures.from_scene(jscene)
        (j_sph, j_rect, _, _), jsky, jgrad = jfp.prep_tables(jscene, jfeat)
        j_table = jnp.concatenate([j_sph, j_rect])
        feats = SceneFeatures.from_scene(scene)
        tables = tfp.prep_tables(scene, feats)
        flags = tfp.feature_flags(feats)
        n = 1024
        ro, rd, tm = jax_camera_rays(jcam, n, seed=0)
        st = tfp.make_state(torch.from_numpy(ro), torch.from_numpy(rd),
                            torch.from_numpy(tm))
        for depth in range(3):
            planes = st.planes.numpy()
            t, idx = _jax_nearest(jscene, planes[0:3].T, planes[3:6].T)
            js = jfp.FastStateP(
                *(jnp.asarray(p) for p in planes[:6]), jnp.asarray(tm),
                *(jnp.asarray(p) for p in planes[6:12]),
                jnp.asarray(st.alive.numpy()),
                jnp.asarray(st.lane.numpy().astype(np.uint32)),
            )
            ref = jax_shade(j_table, jnp.asarray(idx), jnp.asarray(t), js,
                            jnp.int32(11), jnp.int32(depth), 8, jfeat,
                            jsky, jgrad)
            out, alive = shade_kernel.shade_from_winners(
                tables.table, torch.from_numpy(idx), torch.from_numpy(t),
                st.planes, st.time, st.alive, st.lane, 11, depth, 8,
                tables.sky4, flags)
            for k, name in enumerate(PLANE_NAMES):
                assert_lanes_close(out[k].numpy(), np.asarray(getattr(ref, name)),
                                   what=f"{preset} depth {depth} {name}")
            agree = (alive.numpy() == np.asarray(ref.alive)).mean()
            assert agree >= 0.995, (preset, depth, agree)
            st = tfp.FastStateP(out, st.time, alive, st.lane)

    def test_wrapper_checks_inputs(self):
        scene, _ = presets.small(1.0)
        tables = tfp.prep_tables(scene, SceneFeatures.from_scene(scene))
        st = tfp.make_state(torch.zeros(8, 3), torch.ones(8, 3), torch.zeros(8))
        t, idx = intersect_kernel.sphere_nearest(tables.soa, st.planes[:6])
        with pytest.raises(TypeError):
            shade_kernel.shade_from_winners(
                tables.table, idx.long(), t, st.planes, st.time, st.alive,
                st.lane, 1, 0, 8, tables.sky4, 0)
        with pytest.raises(ValueError):
            intersect_kernel.sphere_nearest(tables.soa[:4], st.planes[:6])
