"""PyTorch port vs the JAX package: bounce RNG, hash noise, attribute
tables, presets, the scene boundary and the camera.

Everything here is exact but ``cbrt_pos``: the hash is integer
arithmetic, the noise and tables are + - * on identical inputs, and eager
JAX on the CPU rounds every operation on its own as PyTorch does.
``cbrt_pos`` calls the libraries' ``exp`` and ``log`` and is held to a
bound derived from their rounding (``cbrt_bound``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import build as jbuild  # noqa: E402
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

PORTED = presets.names()
# the cover scene at half_extent 20: 1604 spheres, 13 tiles (the flat cull)
COVER_20 = "half_extent=20"


def _preset_pair(name, aspect):
    """((JAX scene, camera), (port scene, camera)) of a ported preset or
    of ``COVER_20``."""
    if name == COVER_20:
        return (jpresets._random_impl(aspect, True, 0, half_extent=20),
                presets._random_impl(aspect, True, 0, half_extent=20))
    return jpresets.from_name(name, aspect), presets.from_name(name, aspect)


# ``fastpath.cbrt_pos`` over the whole domain its callers reach: the
# counter uniforms ``k * 2^-24``, k = 1 .. 2^24 - 1 (k = 0 is its own case),
# in chunks of 2^22 so that a test worker's memory stays small
CBRT_DOMAIN, CBRT_CHUNK = 1 << 24, 1 << 22


def cbrt_domain(start: int) -> np.ndarray:
    """The chunk ``k * 2^-24``, k in [max(start, 1), start + CBRT_CHUNK),
    as float32 (exact: k has at most 24 bits)."""
    k = np.arange(max(start, 1), min(start + CBRT_CHUNK, CBRT_DOMAIN))
    return k.astype(np.float32) * np.float32(2.0 ** -24)


def cbrt_bound(x: np.ndarray) -> np.ndarray:
    """The largest relative gap between two implementations of
    ``cbrt_pos(x) = exp(fl(log(x) * c))``, c = fl32(1/3), whose ``log`` and
    ``exp`` are each within 1 float32 ULP of the exact value:

    - the two logs differ by at most 2u, u = ulp32(|ln x|) (one ULP on
      each side, in opposite directions);
    - multiplied by the same c the products differ by at most 2u c, and
      each side's rounding of its product adds at most half an ULP of it:
      an exponent gap d <= 2u c + ulp32(|ln x| / 3);
    - exact exponentials of exponents d apart differ by e^d - 1 relative,
      and each side's ``exp`` adds at most 1 ULP, at most 2^-23 relative:
      |a / b - 1| <= e^d (1 + 2^-23) / (1 - 2^-23) - 1, about
      2u/3 + ulp32(|ln x| / 3) + 4 * 2^-24.

    A ULP of ``ln x`` is worth ~u/3 of the result, 2.7-5.3 result ULPs
    once |ln x| >= 8, so no fixed ULP count bounds the gap."""
    ln = np.abs(np.log(x.astype(np.float64)))
    u = np.spacing(ln.astype(np.float32)).astype(np.float64)
    u3 = np.spacing((ln / 3.0).astype(np.float32)).astype(np.float64)
    d = 2.0 * u * float(np.float32(1.0 / 3.0)) + u3
    eps = 2.0 ** -23
    return np.exp(d) * (1.0 + eps) / (1.0 - eps) - 1.0


def cbrt_gap(x: np.ndarray, got: np.ndarray, ref: np.ndarray):
    """(largest gap in float32 ULPs, largest |got / ref - 1| over
    :func:`cbrt_bound`) of two float32 ``cbrt_pos`` results on ``x``
    (positive, so the bit patterns order as the values)."""
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    rel = np.abs(got.astype(np.float64) / ref.astype(np.float64) - 1.0)
    return int(ulps.max()), float((rel / cbrt_bound(x)).max())


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
        # differently in the last place, and a ULP of log x is up to ~5
        # ULPs of the result, so cbrt_pos agrees to the bound derived in
        # cbrt_bound, element by element, over every k * 2^-24
        # (k = 1 .. 2^24 - 1) that the counter uniforms take
        worst_ulp, worst_ratio = 0, 0.0
        for start in range(0, CBRT_DOMAIN, CBRT_CHUNK):
            x = cbrt_domain(start)
            ref = np.asarray(jfp.cbrt_pos(jnp.asarray(x)))
            got = tfp.cbrt_pos(torch.from_numpy(x)).numpy()
            ulp, ratio = cbrt_gap(x, got, ref)
            worst_ulp, worst_ratio = max(worst_ulp, ulp), max(worst_ratio,
                                                              ratio)
        print(f"cbrt_pos over {CBRT_DOMAIN - 1} points: largest gap "
              f"{worst_ulp} ULPs, {worst_ratio:.4f} of the bound")
        assert worst_ratio <= 1.0, (worst_ulp, worst_ratio)

    def test_cbrt_pos_at_zero(self):
        # both clamp x to 1e-38 first, a float32 subnormal: XLA's CPU
        # flushes it to 0, so JAX returns exp(log(0) / 3) = 0; PyTorch
        # keeps it, so the port returns exp(log(1e-38) / 3) ~ 2.15e-13.
        # Against the 1e-3 lane contract both are 0.
        ref = np.asarray(jfp.cbrt_pos(jnp.zeros(4, jnp.float32)))
        got = tfp.cbrt_pos(torch.zeros(4)).numpy()
        assert (ref == 0.0).all()
        clamp = np.array([1e-38], np.float32)
        exact = np.exp(np.log(clamp.astype(np.float64)) / 3.0)
        assert 2.15e-13 < exact[0] < 2.16e-13
        assert (np.abs(got / exact - 1.0) <= cbrt_bound(clamp)).all(), got


class TestSceneState:
    @pytest.mark.parametrize("name", PORTED + [COVER_20])
    def test_presets_equal_reference_leaf_for_leaf(self, name):
        for aspect in (16 / 9, 1.0):
            (jscene, jcam), (scene, cam) = _preset_pair(name, aspect)
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
        (j_sph, j_rect, j_box, j_media), j_sky, j_grad = jfp.prep_tables(
            jscene, jfeat)
        feats = SceneFeatures.from_scene(scene)
        assert feats._key() == jfeat._key()
        tables = tfp.prep_tables(scene, feats)
        # the rect block follows the sphere rows in rect scenes, then the
        # box and medium rows in box and media scenes
        ref = np.concatenate([np.asarray(b) for b, on in (
            (j_sph, True), (j_rect, feats.has_rects),
            (j_box, feats.has_boxes), (j_media, feats.has_media)) if on])
        assert _bits_equal(ref, tables.table.numpy())
        assert _bits_equal(np.asarray(j_sky).reshape(3), tables.sky4[:3].numpy())
        assert float(j_grad) == float(tables.sky4[3])
        # the closest-hit operand: centres, |c|^2 - r^2, mask, padded to 128;
        # a moving scene's (K3) adds delta, time0, inv_dt, c.delta and
        # |delta|^2, the dot products summed x, y, z in that order
        sp = jscene.spheres
        n = sp.center.shape[0]
        c = np.asarray(sp.center)
        cc = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
              - np.asarray(sp.radius) * np.asarray(sp.radius))
        soa = tables.soa.numpy()
        assert soa.shape == (12 if feats.has_motion else 5, soa.shape[1])
        assert soa.shape[1] % 128 == 0
        np.testing.assert_array_equal(soa[:3, :n], c.T)
        np.testing.assert_array_equal(soa[3, :n], cc)
        np.testing.assert_array_equal(soa[4, :n], np.asarray(sp.mask))
        assert np.all(soa[:3, n:] == 1e18) and np.all(soa[3, n:] == 1e30)
        assert np.all(soa[4, n:] == 0.0)
        if feats.has_motion:
            d = np.asarray(sp.center_delta)
            np.testing.assert_array_equal(soa[5:8, :n], d.T)
            np.testing.assert_array_equal(soa[8, :n], np.asarray(sp.time0))
            np.testing.assert_array_equal(soa[9, :n],
                                          np.asarray(sp.inv_time_delta))
            np.testing.assert_array_equal(
                soa[10, :n], c[:, 0] * d[:, 0] + c[:, 1] * d[:, 1] + c[:, 2] * d[:, 2])
            np.testing.assert_array_equal(
                soa[11, :n], d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
            assert np.all(soa[5:, n:] == 0.0)

    def test_scene_from_numpy_round_trip(self):
        jscene, jcam = jpresets.random_spheres(16 / 9)
        leaves = jax_scene_leaves(jscene)
        scene = convert.scene_from_numpy(leaves, device="cpu")
        for key, val in convert.scene_to_numpy(scene).items():
            assert _bits_equal(leaves[key], val), key
        cam_leaves = jax_camera_leaves(jcam)
        cam = convert.camera_from_numpy(cam_leaves, device="cpu")
        for key, val in convert.camera_to_numpy(cam).items():
            assert _bits_equal(cam_leaves[key], val), key

    def test_scene_from_numpy_refuses_unported_kinds(self):
        # instanced spheres convert now, affines included (the general
        # integrator renders them), as do earth's image texture and
        # cornell's boxes; an instance without both affines and image
        # textures without atlas leaves are refused
        b = jbuild.SceneBuilder()
        b.sphere((0.0, 0.0, 0.0), 1.0, b.lambertian_color((0.5, 0.5, 0.5)),
                 transform=np.eye(3, 4, dtype=np.float32))
        leaves = jax_scene_leaves(b.finish())
        inst = convert.scene_from_numpy(leaves, device="cpu")
        assert inst.spheres.instanced and not inst.rects.instanced
        del leaves["spheres.obj_from_world"]
        with pytest.raises(ValueError, match="both affines"):
            convert.scene_from_numpy(leaves, device="cpu")
        jscene, _ = jpresets.earth(1.0)
        leaves = jax_scene_leaves(jscene)
        scene = convert.scene_from_numpy(leaves, device="cpu")
        assert tuple(scene.atlas.data.shape) == (256, 512, 3)
        with pytest.raises(ValueError, match="no atlas leaves"):
            convert.scene_from_numpy(
                {k: v for k, v in leaves.items()
                 if not k.startswith("atlas.")}, device="cpu")

    def test_fastpath_refuses_moving_spheres(self):
        """Moving spheres are ported (K3): the converted JAX ``random``
        scene is accepted, and its tables carry the [12, N] motion
        operand. The gate still refuses the kinds that are not ported."""
        jscene, _ = jpresets.random(1.0)
        leaves = jax_scene_leaves(jscene)
        scene = convert.scene_from_numpy(leaves, device="cpu")
        feats = SceneFeatures.from_scene(scene)
        assert feats.has_motion and tfp.fastpath_supported(feats, scene)
        tables = tfp.prep_tables(scene, feats)
        assert tuple(tables.soa.shape) == (12, 512)
        assert np.count_nonzero(tables.soa[9].numpy()) == 391  # inv_dt
        # image textures are ported, in a scene with boxes too (the
        # non-fused bounce); the fused bounce refuses that pair
        feats.has_image = True
        assert tfp.fastpath_supported(feats, scene)
        feats.has_boxes = True
        assert tfp.fastpath_supported(feats, scene)
        assert "image textures" in tfp.fused_refusal(feats, scene)

    def test_unported_preset_raises(self):
        # every preset is ported (final_full through the fast path's
        # non-fused bounce); an unknown name is refused
        assert presets.NOT_PORTED == () and "final_full" in PORTED
        with pytest.raises(ValueError, match="unrecognised preset"):
            presets.from_name("final_fuller", 1.0)


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
