"""The committed JAX reference fixture for the PyTorch port.

``tests/goldens/torch_port_random_spheres.npz`` carries 4096 primary rays
of ``random_spheres`` made from numpy uniforms, the scene and camera
leaves, and the JAX fused path's radiance and segment count at depth 10,
seed 7. The port's card check (chip_smoke.py) traces the same rays on
CUDA and holds the result to the slice contract, without JAX on that
machine.

``tests/goldens/torch_port_random_spheres_xl.npz`` does the same for the
culled path: the rays of a 128x72, 1 spp film of ``random_spheres_xl``
(4100 spheres, 33 tiles: the two-level cull) made from numpy uniforms and
permuted into 64x64 tile order as the JAX frame path permutes them, and
JAX's radiance and segment count at depth 10, seed 7. It carries no scene
leaves: the port's ``random_spheres_xl`` equals the JAX preset's leaf for
leaf (tests/test_torch_hash_tables.py). Its depth-10 budget is
``XL_DEPTH10_BUDGET`` (tests/torch_port_util.py).

Here each fixture is regenerated with JAX and compared with the file, so
it cannot go stale, and the port's CPU trace is held to it.

Regenerate the files with ``PYTHONPATH=. python tests/test_torch_fixture.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, XL_DEPTH10_BUDGET, check_slice_contract, jax_camera_leaves,
    jax_scene_leaves, numpy_uniforms,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_random_spheres.npz")
N_RAYS = 4096
MAX_DEPTH = 10
SEED = 7
UNIFORM_SEED = 2024
ASPECT = 16 / 9


def make_fixture() -> dict:
    """Rays, scene and camera leaves, and the JAX fused-path trace."""
    import jax.numpy as jnp

    from pathtrace_tpu.camera import get_rays
    from pathtrace_tpu.models import presets
    from pathtrace_tpu.models.types import SceneFeatures
    from pathtrace_tpu.ops.fastpath import trace_fast

    scene, cam = presets.random_spheres(ASPECT)
    s, t, u = numpy_uniforms(N_RAYS, seed=UNIFORM_SEED)
    ro, rd, tm = get_rays(cam, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u))
    rad, count = trace_fast(scene, ro, rd, tm, SEED, MAX_DEPTH,
                            SceneFeatures.from_scene(scene), min_size=128)
    out = {"rays.ro": np.asarray(ro), "rays.rd": np.asarray(rd),
           "rays.time": np.asarray(tm),
           "radiance": np.asarray(rad), "ray_count": np.int64(int(count)),
           "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH)}
    # the committed fixture's leaves predate the atlas (random_spheres has
    # no image: it converts with the placeholder atlas)
    out.update(jax_scene_leaves(scene, atlas=False))
    out.update(jax_camera_leaves(cam))
    return out


XL_FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                          "torch_port_random_spheres_xl.npz")
XL_FILM = (128, 72, 1)  # width, height, samples


def make_xl_fixture() -> dict:
    """Tile-ordered film rays of random_spheres_xl and the JAX trace."""
    import jax.numpy as jnp

    from pathtrace_tpu.camera import get_rays
    from pathtrace_tpu.models import presets
    from pathtrace_tpu.models.types import SceneFeatures
    from pathtrace_tpu.ops import fastpath

    W, H, S = XL_FILM
    scene, cam = presets.random_spheres_xl(W / H)
    ro, rd, tm = get_rays(cam, *(jnp.asarray(a) for a in film_uniforms(W, H, S)))
    R = W * H * S
    order, _ = fastpath._tile_perm_np(H, W)
    ro, rd, tm = fastpath._permute_rays_jit(
        ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R),
        jnp.asarray(order), S)
    rad, count = fastpath.trace_fast(scene, ro, rd, tm, SEED, MAX_DEPTH,
                                     SceneFeatures.from_scene(scene),
                                     min_size=128)
    return {"rays.ro": np.asarray(ro), "rays.rd": np.asarray(rd),
            "rays.time": np.asarray(tm),
            "radiance": np.asarray(rad), "ray_count": np.int64(int(count)),
            "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH),
            "film": np.asarray(XL_FILM, np.int64)}


def film_uniforms(width, height, samples, seed=UNIFORM_SEED):
    """Film coordinates s, t [H, W, S] (pixel plus numpy jitter over the
    film) and lens/time uniforms [H, W, S, 3]."""
    rng = np.random.default_rng(seed)
    shape = (height, width, samples)
    x = np.arange(width, dtype=np.float32)[None, :, None]
    y = np.arange(height, dtype=np.float32)[:, None, None]
    s = (x + rng.random(shape, dtype=np.float32)) / np.float32(width)
    t = (y + rng.random(shape, dtype=np.float32)) / np.float32(height)
    return s, t, rng.random(shape + (3,), dtype=np.float32)


def _hold_xl(ref, radiance, ray_count):
    check_slice_contract(radiance, ray_count, ref["radiance"],
                         ref["ray_count"], MAX_DEPTH, budget=XL_DEPTH10_BUDGET)


def test_fixture_matches_jax_regeneration():
    ref = np.load(FIXTURE)
    new = make_fixture()
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    for key in new:
        if key in ("radiance", "ray_count"):
            continue
        assert np.array_equal(ref[key], new[key]), key
    # XLA's CPU code may round differently on another host: the radiance
    # is held to the slice contract, not to bits
    check_slice_contract(new["radiance"], new["ray_count"],
                         ref["radiance"], ref["ray_count"], MAX_DEPTH,
                         budget=DEPTH10_BUDGET)


def test_port_cpu_trace_holds_fixture():
    from pathtrace_tpu_torch.models.convert import scene_from_numpy
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops.fastpath import trace_fast

    ref = np.load(FIXTURE)
    scene = scene_from_numpy(ref, device="cpu")
    res = trace_fast(scene, torch.from_numpy(ref["rays.ro"]),
                     torch.from_numpy(ref["rays.rd"]),
                     torch.from_numpy(ref["rays.time"]), int(ref["seed"]),
                     int(ref["max_depth"]), SceneFeatures.from_scene(scene),
                     min_size=128)
    check_slice_contract(res.radiance.numpy(), res.ray_count,
                         ref["radiance"], ref["ray_count"], MAX_DEPTH,
                         budget=DEPTH10_BUDGET)


def test_xl_fixture_matches_jax_regeneration():
    ref = np.load(XL_FIXTURE)
    new = make_xl_fixture()
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    for key in new:
        if key not in ("radiance", "ray_count"):
            assert np.array_equal(ref[key], new[key]), key
    _hold_xl(ref, new["radiance"], new["ray_count"])


def test_port_cpu_trace_holds_xl_fixture():
    """The port's plain trace of the tile-ordered rays, through the
    two-level cull (K5's plain version) at every bounce."""
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import intersect_kernel
    from pathtrace_tpu_torch.ops.fastpath import trace_fast

    ref = np.load(XL_FIXTURE)
    W, H, _ = ref["film"]
    scene, _ = presets.random_spheres_xl(W / H)
    calls = intersect_kernel.HIER_PLAIN_CALLS, intersect_kernel.PLAIN_CALLS
    res = trace_fast(scene, *(torch.from_numpy(ref[k]) for k in
                              ("rays.ro", "rays.rd", "rays.time")),
                     int(ref["seed"]), int(ref["max_depth"]),
                     SceneFeatures.from_scene(scene), min_size=128)
    assert intersect_kernel.HIER_PLAIN_CALLS == calls[0] + MAX_DEPTH + 1
    assert intersect_kernel.PLAIN_CALLS == calls[1]
    _hold_xl(ref, res.radiance.numpy(), res.ray_count)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE}")
    np.savez_compressed(XL_FIXTURE, **make_xl_fixture())
    print(f"wrote {XL_FIXTURE}")
