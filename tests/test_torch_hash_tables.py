"""PyTorch port vs the JAX package: bounce RNG, hash noise, attribute
tables, presets, the scene boundary and the camera.

Everything here is exact: the hash is integer arithmetic, the noise and
tables are + - * on identical inputs, and eager JAX on the CPU rounds every
operation on its own as PyTorch does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu_torch.camera import get_rays  # noqa: E402
from pathtrace_tpu_torch.models import convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from torch_port_util import (  # noqa: E402
    jax_camera_leaves, jax_scene_leaves, numpy_uniforms, scene_pair,
)

PORTED = ["random_spheres", "small", "two_perlin_spheres"]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


class TestHash:
    @pytest.mark.parametrize("seed", [7, -123456789, 2**31 - 1])
    def test_counter_uniform_bitwise(self, seed):
        lanes = np.arange(1 << 16, dtype=np.uint32) * np.uint32(2654435761)
        j_lane = jnp.asarray(lanes)
        t_lane = torch.from_numpy(lanes.astype(np.int64)).to(torch.int32)
        for depth in (0, 3, 9):
            for draw in range(9):
                ref = jfp.counter_uniform(j_lane, jnp.int32(seed), depth, draw)
                got = tfp.counter_uniform(t_lane, seed, depth, draw)
                assert _bits_equal(ref, got.numpy()), (depth, draw)

    def test_hash3_negative_lattice_bitwise(self):
        rng = np.random.default_rng(1)
        ijk = rng.integers(-(1 << 20), 1 << 20, size=(3, 1 << 16),
                           dtype=np.int32)
        ref = jfp._hash3(*(jnp.asarray(c) for c in ijk))
        got = tfp._hash3(*(torch.from_numpy(c) for c in ijk))
        assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())
        ref_u = jfp._hash_unit(ref)
        got_u = tfp._hash_unit(got)
        assert _bits_equal(ref_u, got_u.numpy())

    def test_noise_turbulence_bitwise(self):
        # negative coordinates included: the lattice hash wraps them
        rng = np.random.default_rng(2)
        p = (rng.random((3, 1 << 14), dtype=np.float32) - 0.5) * 40.0
        jp = [jnp.asarray(c) for c in p]
        tp = [torch.from_numpy(c) for c in p]
        assert _bits_equal(jfp.fast_noise_c(*jp), tfp.fast_noise_c(*tp).numpy())
        assert _bits_equal(jfp.fast_turb_c(*jp), tfp.fast_turb_c(*tp).numpy())

    def test_cbrt_pos_within_ulps(self):
        # exp and log are library functions: XLA's and PyTorch's may round
        # differently in the last place, so cbrt_pos agrees to ULPs, not bits
        x = np.random.default_rng(3).random(1 << 14, dtype=np.float32)
        ref = np.asarray(jfp.cbrt_pos(jnp.asarray(x)))
        got = tfp.cbrt_pos(torch.from_numpy(x)).numpy()
        np.testing.assert_array_max_ulp(got, ref, maxulp=4)


class TestSceneState:
    @pytest.mark.parametrize("name", PORTED)
    def test_presets_equal_reference_leaf_for_leaf(self, name):
        for aspect in (16 / 9, 1.0):
            jscene, jcam = jpresets.from_name(name, aspect)
            scene, cam = presets.from_name(name, aspect)
            ref = jax_scene_leaves(jscene)
            got = convert.scene_to_numpy(scene)
            for key, val in got.items():
                assert _bits_equal(ref[key], val), (name, key)
            ref_cam = jax_camera_leaves(jcam)
            for key, val in convert.camera_to_numpy(cam).items():
                assert _bits_equal(ref_cam[key], val), (name, key)

    @pytest.mark.parametrize("name", PORTED + ["lit"])
    def test_prep_tables_bitwise(self, name):
        jscene, _, scene = scene_pair(name, 1.0)
        jfeat = JFeatures.from_scene(jscene)
        (j_sph, _, _, _), j_sky, j_grad = jfp.prep_tables(jscene, jfeat)
        feats = SceneFeatures.from_scene(scene)
        assert feats._key() == jfeat._key()
        tables = tfp.prep_tables(scene, feats)
        assert _bits_equal(j_sph, tables.table.numpy())
        assert _bits_equal(np.asarray(j_sky).reshape(3), tables.sky4[:3].numpy())
        assert float(j_grad) == float(tables.sky4[3])
        # the closest-hit operand: centres, |c|^2 - r^2, mask, padded to 128
        sp = jscene.spheres
        n = sp.center.shape[0]
        c = np.asarray(sp.center)
        cc = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
              - np.asarray(sp.radius) * np.asarray(sp.radius))
        soa = tables.soa.numpy()
        assert soa.shape[1] % 128 == 0
        np.testing.assert_array_equal(soa[:3, :n], c.T)
        np.testing.assert_array_equal(soa[3, :n], cc)
        np.testing.assert_array_equal(soa[4, :n], np.asarray(sp.mask))
        assert np.all(soa[:3, n:] == 1e18) and np.all(soa[3, n:] == 1e30)
        assert np.all(soa[4, n:] == 0.0)

    def test_scene_from_numpy_round_trip(self):
        jscene, jcam = jpresets.random_spheres(16 / 9)
        leaves = jax_scene_leaves(jscene)
        scene = convert.scene_from_numpy(leaves)
        for key, val in convert.scene_to_numpy(scene).items():
            assert _bits_equal(leaves[key], val), key
        cam_leaves = jax_camera_leaves(jcam)
        cam = convert.camera_from_numpy(cam_leaves)
        for key, val in convert.camera_to_numpy(cam).items():
            assert _bits_equal(cam_leaves[key], val), key

    def test_scene_from_numpy_refuses_unported_kinds(self):
        jscene, _ = jpresets.cornell(1.0)
        with pytest.raises(ValueError, match="rects"):
            convert.scene_from_numpy(jax_scene_leaves(jscene))

    def test_fastpath_refuses_moving_spheres(self):
        jscene, _ = jpresets.random(1.0)
        leaves = jax_scene_leaves(jscene)
        scene = convert.scene_from_numpy(leaves)
        with pytest.raises(ValueError, match="moving spheres"):
            tfp.fastpath_supported(SceneFeatures.from_scene(scene))

    def test_unported_preset_raises(self):
        with pytest.raises(ValueError, match="not ported yet"):
            presets.from_name("cornell", 1.0)


class TestCamera:
    @pytest.mark.parametrize("name", PORTED)
    def test_get_rays_on_shared_uniforms(self, name):
        from pathtrace_tpu.camera import get_rays as jget_rays

        _, jcam = jpresets.from_name(name, 16 / 9)
        _, cam = presets.from_name(name, 16 / 9)
        s, t, u = numpy_uniforms(4096, seed=3)
        ref = jget_rays(jcam, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u))
        got = get_rays(cam, torch.from_numpy(s), torch.from_numpy(t),
                       torch.from_numpy(u))
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-6)
