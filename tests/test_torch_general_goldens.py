"""The port's general-integrator frames against the JAX package's
committed per-pixel goldens.

``tests/goldens/pixels_<preset>_general.npz`` hold the reference's
general-path image (``render_frame``) of every preset at 64x48, 8 spp,
depth 8, frame key ``PRNGKey(0)`` (tests/test_golden_pixels.py writes
them; they are only read here). The port's ``render_frame`` on the CPU
(K1 and K3 as their plain versions, the plain object-space, rect, box
and media sweeps, table Perlin noise, the recursive checker, the image
fetch) draws the same primary rays and the same bounce uniforms through
the Threefry twin, so its image is the reference's up to the closest
hit's rounding.

Contract, as for the fast-path goldens (tests/test_torch_golden_pixels.py):
every pixel within 1e-3 (relative and absolute, each channel), except a
share no larger than ``1 - (1 - b)^8``, b the per-ray budget at depth 10
(``DEPTH10_BUDGET``, ``XL_DEPTH10_BUDGET`` for ``random_spheres_xl``).
Measured on the CPU (pixels outside of 3072): aras 1, cornell 0,
cornell_smoke 0, earth 0, final 0, final_full 117, random 72,
random_spheres 55, random_spheres_xl 162, simple_light 0, small 0,
smallpt 0, two_perlin_spheres 0. ``final_full``'s 3.81% comes from its
1000 radius-10 spheres and 400 boxes at ~600 units (K3's expanded
quadratic and the box sweep's affine products round unlike XLA's), inside
the shared budget (7.73%), so it needs none of its own.

The same frames of ``small``, ``two_perlin_spheres``, ``cornell`` and
``simple_light`` also hold the reference's statistical goldens
(``tests/goldens/<preset>.json``, ``tests/test_golden.py``'s
determinism goldens, whose render is this one): the per-channel image
mean within 2e-3 and the ray count within 0.2%, ``test_golden.py:41``'s
tolerances. Each frame is rendered once per worker and shared by the
two checks.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.render.frame import render_frame  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, XL_DEPTH10_BUDGET, lane_close,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
W, H, SPP, DEPTH, SEED = 64, 48, 8, 8, 0


def pixel_budget(preset: str) -> float:
    """The share of pixels allowed outside 1e-3: one minus the chance
    that all 8 of a pixel's rays stay inside the per-ray budget."""
    b = XL_DEPTH10_BUDGET if preset == "random_spheres_xl" else DEPTH10_BUDGET
    return 1.0 - (1.0 - b) ** SPP


def test_every_preset_is_ported():
    assert presets.NOT_PORTED == ()
    assert "final_full" in presets.names() and len(presets.names()) == 13


@functools.lru_cache(maxsize=None)
def general_frame(preset: str):
    """The port's CPU ``render_frame`` of ``preset`` at the goldens'
    settings: (image [H, W, 3] numpy, ray count)."""
    scene, cam = presets.from_name(preset, W / H, seed=0)
    img, count = render_frame(scene, cam, W, H, SPP, DEPTH, PRNGKey(SEED),
                              features=SceneFeatures.from_scene(scene))
    return img.numpy(), int(count)


@pytest.mark.parametrize("preset", presets.names())
def test_cpu_general_frame_matches_pixel_golden(preset):
    golden = np.load(os.path.join(GOLDEN_DIR,
                                  f"pixels_{preset}_general.npz"))["img"]
    img, count = general_frame(preset)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert int(count) >= W * H * SPP  # every camera ray is a segment
    outside = ~lane_close(img, golden).all(axis=-1)
    share, budget = float(outside.mean()), pixel_budget(preset)
    assert share <= budget, (
        f"{preset}: {int(outside.sum())} pixels ({share:.4%}) outside 1e-3, "
        f"budget {budget:.4%}; largest difference "
        f"{np.abs(img - golden).max()}")


STAT_GOLDEN_PRESETS = ["small", "two_perlin_spheres", "cornell",
                       "simple_light"]


@pytest.mark.parametrize("preset", STAT_GOLDEN_PRESETS)
def test_cpu_general_frame_matches_statistical_golden(preset):
    """``tests/test_golden.py``'s determinism goldens, held by the port."""
    with open(os.path.join(GOLDEN_DIR, f"{preset}.json")) as f:
        golden = json.load(f)
    img, count = general_frame(preset)
    mean = [round(float(x), 5) for x in img.mean(axis=(0, 1))]
    np.testing.assert_allclose(mean, golden["mean"], atol=2e-3)
    assert abs(count - golden["ray_count"]) <= golden["ray_count"] * 0.002, (
        count, golden["ray_count"])
