"""The committed JAX reference fixture for the PyTorch port.

``tests/goldens/torch_port_random_spheres.npz`` carries 4096 primary rays
of ``random_spheres`` made from numpy uniforms, the scene and camera
leaves, and the JAX fused path's radiance and segment count at depth 10,
seed 7. The port's card check (chip_smoke.py) traces the same rays on
CUDA and holds the result to the slice contract, without JAX on that
machine.

Here the fixture is regenerated with JAX and compared with the file, so
it cannot go stale, and the port's CPU trace is held to it.

Regenerate the file with ``PYTHONPATH=. python tests/test_torch_fixture.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, check_slice_contract, jax_camera_leaves, jax_scene_leaves,
    numpy_uniforms,
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
    out.update(jax_scene_leaves(scene))
    out.update(jax_camera_leaves(cam))
    return out


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
    scene = scene_from_numpy(ref)
    res = trace_fast(scene, torch.from_numpy(ref["rays.ro"]),
                     torch.from_numpy(ref["rays.rd"]),
                     torch.from_numpy(ref["rays.time"]), int(ref["seed"]),
                     int(ref["max_depth"]), SceneFeatures.from_scene(scene),
                     min_size=128)
    check_slice_contract(res.radiance.numpy(), res.ray_count,
                         ref["radiance"], ref["ray_count"], MAX_DEPTH,
                         budget=DEPTH10_BUDGET)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE}")
