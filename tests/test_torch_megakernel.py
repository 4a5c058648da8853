"""The megakernel path of the port (K7) against the JAX package.

* The rect host layer: ``simple_light`` (3 spheres, one rect, two diffuse
  lights, the noise texture, a black sky) equal to JAX's leaf for leaf,
  rect padding included; ``SceneFeatures`` equal slot by slot; rects
  across ``scene_from_numpy`` and back; instanced rects cross too, and the
  fast path and the megakernel refuse them.
* The megakernel's tables (``build_sphere_table``, ``build_rect_table``)
  bit for bit JAX's, dead and padding rows included.
* The plain K7 (``trace_megakernel`` on CPU tensors) against JAX's
  ``trace_megakernel`` (Pallas in interpret mode, as
  ``tests/test_fastpath.py`` runs it) ray by ray: radiance to 1e-3, at most
  0.5% of rays outside (``DEPTH10_BUDGET``, 1%, at depth 10); the segment
  counts equal where no ray is outside, else within 1%. Measured on the
  CPU: 0 rays outside on ``small`` (4096 rays, depth 8) and
  ``two_perlin_spheres`` (1024, depth 8), 0.05% on ``simple_light`` (2048,
  depth 8), 0.39% on ``random_spheres`` and 0.24% on ``random`` (2048,
  depth 10). The transcendentals (sin, cos, exp, log, rsqrt) of XLA and
  PyTorch differ by ULPs, and the sphere quadratic cancels for the
  0.2-radius spheres, as in K1 (ROADMAP section 3).
* Edges: a ragged wavefront, ``max_depth = 0``, a scene with no live
  sphere, another seed.
* The plain K7 against the port's own fast path (``trace_fast``, plain K1
  and K2) ray by ray: both draw the same counter hash on the same lanes.
* The committed fixture ``tests/goldens/torch_port_megakernel.npz``: JAX's
  radiance and segment counts for 4096 rays of ``simple_light`` (depth 8)
  and ``random`` (depth 10). Regenerate it with
  ``PYTHONPATH=. python tests/test_torch_megakernel.py``.
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
from pathtrace_tpu.ops import megakernel as jmk  # noqa: E402
from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.models import convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import megakernel as tmk  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, check_slice_contract, jax_camera_rays, jax_scene_leaves,
    lane_close, numpy_uniforms, scene_pair,
)

ASPECT = 16 / 9
FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_megakernel.npz")
SEED = 7
# (preset, rays, depth) of the fixture, the rays made from numpy uniforms
FIXTURE_CASES = (("simple_light", 4096, 8), ("random", 4096, 10))
UNIFORM_SEED = 2025
# (preset, rays, depth, uniform seed) held against a fresh JAX run
JAX_CASES = (("small", 4096, 8, 3), ("two_perlin_spheres", 1024, 8, 3),
             ("random_spheres", 2048, 10, 3))


def _t(x):
    return torch.from_numpy(np.array(x))


def check_contract(rad, count, ref_rad, ref_count, depth):
    """``check_slice_contract`` (0.5% of rays outside 1e-3,
    ``DEPTH10_BUDGET`` at depth 10), and the segment counts within 1%."""
    check_slice_contract(rad, count, ref_rad, ref_count, depth,
                         DEPTH10_BUDGET if depth >= 10 else 0.005)
    assert abs(int(count) - int(ref_count)) <= 0.01 * int(ref_count), (
        int(count), int(ref_count))


@functools.lru_cache(maxsize=None)
def _jax_trace(name, n, depth, uniform_seed):
    """JAX's ``trace_megakernel`` of ``n`` camera rays of a preset:
    (rays (ro, rd, time), radiance, segments), all numpy."""
    jscene, jcam = jpresets.from_name(name, ASPECT)
    rays = jax_camera_rays(jcam, n, seed=uniform_seed)
    rad, count = jmk.trace_megakernel(
        jscene, *(jnp.asarray(x) for x in rays), SEED, depth,
        JFeatures.from_scene(jscene))
    return rays, np.asarray(rad), int(count)


def _port_trace(name, rays, depth, seed=SEED):
    scene, _ = presets.from_name(name, ASPECT)
    rad, count = tmk.trace_megakernel(tmk.prep_tables(scene),
                                      *(_t(x) for x in rays), seed, depth,
                                      SceneFeatures.from_scene(scene))
    return rad.numpy(), int(count)


# ---------------------------------------------------------------------------
# the rect host layer and the tables
# ---------------------------------------------------------------------------

def test_simple_light_equals_jax_leaf_for_leaf():
    jscene, _, scene = scene_pair("simple_light", ASPECT)
    ref = jax_scene_leaves(jscene)
    got = convert.scene_to_numpy(scene)
    assert {k for k in got if k.startswith("rects.")} == {
        k for k in ref if k.startswith("rects.")}
    for key, val in got.items():
        assert val.dtype == ref[key].dtype and val.shape == ref[key].shape, key
        assert val.tobytes() == ref[key].tobytes(), key
    rc = scene.rects
    assert rc.count == 1 and bool(rc.mask[0]) and int(rc.axis[0]) == 2
    feats, jfeats = (SceneFeatures.from_scene(scene),
                     JFeatures.from_scene(jscene))
    for slot in SceneFeatures.__slots__:
        assert getattr(feats, slot) == getattr(jfeats, slot), slot
    assert feats.has_rects and feats.has_light and feats.has_noise


def test_rect_padding_and_flip_equal_jax():
    """Rects of every axis, flipped and not, past the builder's padding."""
    boards = []
    for builder in (jbuild.SceneBuilder(), SceneBuilder()):
        b = builder
        mat = b.lambertian_color((0.5, 0.5, 0.5))
        b.rect_xy(0.0, 1.0, 0.0, 2.0, -1.5, True, mat)
        b.rect_xz(-1.0, 1.0, -2.0, 2.0, 0.25, False, mat)
        b.rect_yz(0.5, 1.5, -1.0, 0.0, 3.0, True, mat)
        boards.append(b.finish())
    ref = jax_scene_leaves(boards[0])
    for key, val in convert.scene_to_numpy(boards[1]).items():
        assert val.tobytes() == ref[key].tobytes(), key
    assert boards[1].rects.flip.tolist() == [-1.0, 1.0, -1.0]
    empty = SceneBuilder().finish().rects  # one dead row on the far plane
    assert empty.count == 1 and not bool(empty.mask[0])
    assert float(empty.k[0]) == np.float32(1e18) and float(empty.flip[0]) == 1.0


def test_scene_from_numpy_round_trips_rects_and_refuses_instances():
    """Rects cross ``scene_from_numpy`` bit for bit. Instanced rects cross
    too now (the general integrator renders them), but the fast path and
    the megakernel refuse them."""
    jscene, _ = jpresets.simple_light(ASPECT)
    leaves = jax_scene_leaves(jscene)
    scene = convert.scene_from_numpy(leaves, device="cpu")
    assert SceneFeatures.from_scene(scene).has_rects
    for key, val in convert.scene_to_numpy(scene).items():
        assert val.tobytes() == np.asarray(leaves[key]).tobytes(), key
    inst = jbuild.SceneBuilder()
    inst.rect_xy(0.0, 1.0, 0.0, 1.0, 0.0, False,
                 inst.lambertian_color((0.5, 0.5, 0.5)),
                 transform=np.eye(3, 4, dtype=np.float32))
    conv = convert.scene_from_numpy(jax_scene_leaves(inst.finish()),
                                    device="cpu")
    assert conv.rects.instanced
    with pytest.raises(ValueError, match="instanced rects"):
        tfp.fastpath_supported(SceneFeatures.from_scene(conv), conv)
    with pytest.raises(ValueError, match="instanced spheres or rects"):
        tmk.prep_tables(conv)
    b = SceneBuilder()
    b.rect_xy(0.0, 1.0, 0.0, 1.0, 0.0, False, b.lambertian_color((1, 1, 1)),
              transform=np.eye(3, 4, dtype=np.float32))
    built = b.finish()
    with pytest.raises(ValueError, match="instanced rects"):
        tfp.fastpath_supported(SceneFeatures.from_scene(built), built)


def test_fast_path_and_cli_still_refuse_rects(capsys, tmp_path):
    """The megakernel refuses image textures (``earth``), which the fast
    path takes now; the CLI refuses a mode not ported (``--mode
    sharded``; ``--mode compacted`` renders since the compaction ladder
    was ported) and renders ``simple_light``, whose rect both paths take
    now."""
    scene, _ = presets.simple_light(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    assert tmk.megakernel_supported(feats)
    assert tfp.fastpath_supported(feats, scene)
    out = tmp_path / "simple_light.npy"
    assert cli.main(["-P", "simple_light", "-O", "--device", "cpu", "-W", "16",
                     "-H", "9", "-S", "1", "--out", str(out)]) == 0
    assert np.isfinite(np.load(out)).all()
    feats.has_image = True
    assert tfp.fastpath_supported(feats, scene)
    assert not tmk.megakernel_supported(feats)
    with pytest.raises(ValueError, match="image textures"):
        tmk.trace_megakernel(tmk.prep_tables(scene), torch.zeros(8, 3),
                             torch.tensor([[0.0, 0.0, 1.0]] * 8),
                             torch.zeros(8), 0, 2, feats)
    capsys.readouterr()
    assert cli.main(["-P", "simple_light", "-O", "--device", "cpu", "-W", "16",
                     "-H", "9", "-S", "1", "--mode", "sharded", "--out",
                     str(out)]) == 0
    assert "render path: sharded" in capsys.readouterr().out
    assert np.isfinite(np.load(out)).all()
    assert cli.main(["-P", "simple_light", "-O", "--device", "cpu", "-W", "16",
                     "-H", "9", "-S", "1", "--mode", "compacted", "--out",
                     str(out)]) == 0
    assert np.isfinite(np.load(out)).all()


def test_megakernel_refuses_checker_with_noise_child():
    """A checker whose child is a noise texture: the tables hold only the
    children's colours, so the megakernel and its plain version refuse
    the scene rather than render that half black."""
    b = SceneBuilder()
    chk = b.checker_texture(b.noise_texture(4.0),
                            b.constant_texture((0.9, 0.9, 0.9)))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(chk))
    scene = b.finish()
    feats = SceneFeatures.from_scene(scene)
    assert feats.has_checker and not feats.checker_children_const
    assert not tmk.megakernel_supported(feats)
    tables = tmk.prep_tables(scene)
    rays = (torch.zeros(8, 3), torch.tensor([[0.0, -1.0, 0.0]] * 8),
            torch.zeros(8))
    with pytest.raises(ValueError, match="checker"):
        tmk.trace_megakernel(tables, *rays, 0, 4, feats)
    with pytest.raises(ValueError, match="checker"):
        tmk.trace_megakernel_plain(tables, *rays, 0, 4, feats)


@pytest.mark.parametrize("name", ["random_spheres", "random", "simple_light",
                                  "small", "two_perlin_spheres"])
def test_tables_bitwise(name):
    jscene, _, scene = scene_pair(name, ASPECT)
    tables = tmk.prep_tables(scene)
    for ref, got in ((jmk.build_sphere_table(jscene), tables.spheres),
                     (jmk.build_rect_table(jscene), tables.rects)):
        ref = np.asarray(ref)
        assert ref.dtype == np.float32 and ref.shape == tuple(got.shape)
        assert ref.tobytes() == got.numpy().tobytes()
    rects = tables.rects.numpy()
    n_rc = scene.rects.count
    dead = ~scene.rects.mask.numpy()
    assert np.all(rects[:n_rc][dead][:, [1, 2, 5]] == np.float32([1, -1, 1e18]))
    assert np.all(rects[n_rc:, 5] == np.float32(1e18))
    assert not rects[n_rc:, [0, 1, 2, 3, 4, 6]].any()


# ---------------------------------------------------------------------------
# the plain K7 against JAX's megakernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", JAX_CASES + tuple(
    c + (UNIFORM_SEED,) for c in FIXTURE_CASES), ids=lambda c: c[0])
def test_plain_matches_jax_megakernel(case):
    name, n, depth, useed = case
    rays, ref, ref_count = _jax_trace(name, n, depth, useed)
    calls = tmk.PLAIN_CALLS
    rad, count = _port_trace(name, rays, depth)
    assert tmk.PLAIN_CALLS == calls + 1 and tmk.LAUNCHES == 0
    assert np.isfinite(rad).all() and rad.shape == (n, 3)
    check_contract(rad, count, ref, ref_count, depth)


def test_ragged_wavefront():
    """1000 rays, no whole number of blocks: each ray within 1e-3 of its
    lane in JAX's 4096-ray run (a lane's stream is keyed on its index, so
    rays are independent), and 24 more rays that go straight up into the
    sky add one segment each and change no other ray."""
    rays, ref, _ = _jax_trace("small", 4096, 8, 3)
    head = tuple(x[:1000] for x in rays)
    rad, count = _port_trace("small", head, 8)
    assert lane_close(rad, ref[:1000]).all(axis=1).mean() >= 0.995
    up = (np.tile(np.float32([0.0, 1e4, 0.0]), (24, 1)),
          np.tile(np.float32([0.0, 1.0, 0.0]), (24, 1)), head[2][:24])
    more = tuple(np.concatenate([x, y]) for x, y in zip(head, up))
    rad2, count2 = _port_trace("small", more, 8)
    assert np.array_equal(rad2[:1000], rad) and count2 == count + 24


def test_depth_zero_is_one_segment_per_ray():
    rays, _, _ = _jax_trace("small", 4096, 8, 3)
    rad, count = _port_trace("small", rays, 0)
    assert count == 4096
    scene, _ = presets.small(ASPECT)
    fast = tfp.trace_fast(scene, *(_t(x) for x in rays), SEED, 0,
                          SceneFeatures.from_scene(scene))
    assert int(fast.ray_count) == 4096
    assert lane_close(rad, fast.radiance.numpy()).all()


def test_no_live_sphere_takes_the_sky():
    """Only padding rows: every ray misses and takes the gradient sky."""
    scene = SceneBuilder().finish()
    feats = SceneFeatures.from_scene(scene)
    assert not feats.has_spheres and not feats.has_rects
    ro, rd, tm = rays = jax_camera_rays(jpresets.small(ASPECT)[1], 512, seed=1)
    tables = tmk.prep_tables(scene)
    rad, count = tmk.trace_megakernel(tables, *(_t(x) for x in rays), SEED, 8,
                                      feats)
    sky_t = 0.5 * (rd[:, 1] + np.float32(1.0))
    ref = np.stack([(1.0 - sky_t) + sky_t * np.float32(g)
                    for g in (0.15, 0.21, 0.30)], axis=1)
    assert int(count) == 512
    np.testing.assert_array_equal(rad.numpy(), ref)
    work = {}
    tmk.trace_megakernel_plain(tables, *(_t(x) for x in rays), SEED, 8, feats,
                               work=work)
    assert int(work["shaded"]) == 0 and int(work["noise"]) == 0


@pytest.mark.parametrize("name", ["small", "two_perlin_spheres"])
def test_work_counts_at_depth_zero(name):
    """At depth 0 a ray that hits a non-emitter adds nothing and one that
    misses adds the gradient sky, so the shaded segments are the rays left
    black; on ``two_perlin_spheres`` every one of them meets the noise
    texture, on ``small`` none. 24 rays go straight up into the sky."""
    scene, _ = presets.from_name(name, ASPECT)
    feats = SceneFeatures.from_scene(scene)
    cam = jax_camera_rays(jpresets.from_name(name, ASPECT)[1], 1000, seed=5)
    up = (np.tile(np.float32([0.0, 1e4, 0.0]), (24, 1)),
          np.tile(np.float32([0.0, 1.0, 0.0]), (24, 1)), cam[2][:24])
    work = {}
    rad, count = tmk.trace_megakernel_plain(
        tmk.prep_tables(scene), *(_t(np.concatenate([x, y]))
                                  for x, y in zip(cam, up)),
        SEED, 0, feats, work=work)
    black = int((rad == 0.0).all(dim=1).sum())
    assert int(count) == 1024 and 0 < black <= 1000
    assert int(work["shaded"]) == black
    assert int(work["noise"]) == (black if feats.has_noise else 0)


def test_seed_changes_the_image():
    rays, _, _ = _jax_trace("small", 4096, 8, 3)
    a, _ = _port_trace("small", rays, 8, seed=SEED)
    b, _ = _port_trace("small", rays, 8, seed=SEED + 1)
    assert (~lane_close(a, b).all(axis=1)).mean() > 0.2
    assert abs(a.mean() - b.mean()) < 0.05


def test_plain_matches_port_fast_path():
    """Same lanes, same counter hash: K7's loop and the fast path's
    wavefront bounces agree ray for ray on ``random_spheres``."""
    rays, _, _ = _jax_trace("random_spheres", 2048, 10, 3)
    rad, count = _port_trace("random_spheres", rays, 10)
    scene, _ = presets.random_spheres(ASPECT)
    fast = tfp.trace_fast(scene, *(_t(x) for x in rays), SEED, 10,
                          SceneFeatures.from_scene(scene))
    close = lane_close(rad, fast.radiance.numpy()).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(count - int(fast.ray_count)) <= 0.01 * count


def test_wrapper_checks_inputs():
    scene, _ = presets.small(ASPECT)
    feats = SceneFeatures.from_scene(scene)
    ro = torch.zeros((8, 3))
    rd = torch.ones((8, 3))
    tables = tmk.prep_tables(scene)
    with pytest.raises(ValueError):
        tmk.trace_megakernel(tables, ro, rd[:7], torch.zeros(8), 0, 4, feats)
    feats.has_boxes = True
    with pytest.raises(ValueError, match="boxes"):
        tmk.trace_megakernel(tables, ro, rd, torch.zeros(8), 0, 4, feats)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    """JAX's megakernel on 4096 camera rays (numpy uniforms) of each
    fixture preset: rays, radiance, segments, seed and depth."""
    out = {"seed": np.int64(SEED)}
    for name, n, depth in FIXTURE_CASES:
        (ro, rd, tm), rad, count = _jax_trace(name, n, depth, UNIFORM_SEED)
        out.update({f"{name}.rays.ro": ro, f"{name}.rays.rd": rd,
                    f"{name}.rays.time": tm, f"{name}.radiance": rad,
                    f"{name}.ray_count": np.int64(count),
                    f"{name}.max_depth": np.int64(depth)})
    return out


def test_fixture_matches_jax_regeneration():
    ref = np.load(FIXTURE)
    new = make_fixture()
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    s, t, _ = numpy_uniforms(4096, seed=UNIFORM_SEED)
    assert s.std() > 0.2 and t.std() > 0.2
    for name, _, depth in FIXTURE_CASES:
        for key in ("rays.ro", "rays.rd", "rays.time", "max_depth"):
            assert np.array_equal(ref[f"{name}.{key}"], new[f"{name}.{key}"])
        check_contract(new[f"{name}.radiance"], new[f"{name}.ray_count"],
                       ref[f"{name}.radiance"], ref[f"{name}.ray_count"], depth)


@pytest.mark.parametrize("name", [c[0] for c in FIXTURE_CASES])
def test_port_cpu_megakernel_holds_fixture(name):
    ref = np.load(FIXTURE)
    depth = int(ref[f"{name}.max_depth"])
    rays = tuple(ref[f"{name}.rays.{k}"] for k in ("ro", "rd", "time"))
    rad, count = _port_trace(name, rays, depth, seed=int(ref["seed"]))
    check_contract(rad, count, ref[f"{name}.radiance"],
                   ref[f"{name}.ray_count"], depth)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
