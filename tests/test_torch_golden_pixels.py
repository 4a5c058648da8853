"""The port's frames against the JAX package's committed per-pixel goldens.

``tests/goldens/pixels_<preset>_fast.npz`` hold the reference's fast-path
image of every preset at 64x48, 8 spp, depth 8, frame key ``PRNGKey(0)``
and bounce seed 0 (tests/test_golden_pixels.py, which writes them; they
are only read here). The port's ``render_frame_fast`` on the CPU (every
kernel's plain version) draws the same primary rays through the Threefry
twin and the same bounce streams through the counter hash, so its image
is the reference's up to the closest hit's rounding (ROADMAP section 3:
K1 vs XLA rounding).

Contract: every pixel within 1e-3 (relative and absolute, each channel),
except a share no larger than ``1 - (1 - b)^8``, where b is the preset's
per-ray budget at depth 10 (``DEPTH10_BUDGET``, ``XL_DEPTH10_BUDGET`` for
``random_spheres_xl``): a pixel is outside when one of its 8 rays is.
Measured on the CPU (pixels outside of 3072): aras 3, cornell 2,
cornell_smoke 3, earth 0, final 0, random 56, random_spheres 50,
random_spheres_xl 134, simple_light 2, small 1, smallpt 0,
two_perlin_spheres 0.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops.fastpath import render_frame_fast  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, XL_DEPTH10_BUDGET, lane_close,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
W, H, SPP, DEPTH, SEED = 64, 48, 8, 8, 0
# the presets the fast path takes: final_full (an image texture in a scene
# with boxes and media) renders through the general integrator only, and
# tests/test_torch_general_goldens.py holds its general golden
FAST_PRESETS = [n for n in presets.names() if n != "final_full"]


def pixel_budget(preset: str) -> float:
    """The share of pixels allowed outside 1e-3: one minus the chance
    that all 8 of a pixel's rays stay inside the per-ray budget."""
    b = XL_DEPTH10_BUDGET if preset == "random_spheres_xl" else DEPTH10_BUDGET
    return 1.0 - (1.0 - b) ** SPP


@pytest.mark.parametrize("preset", FAST_PRESETS)
def test_cpu_frame_matches_pixel_golden(preset):
    golden = np.load(os.path.join(GOLDEN_DIR,
                                  f"pixels_{preset}_fast.npz"))["img"]
    scene, cam = presets.from_name(preset, W / H, seed=0)
    res = render_frame_fast(scene, cam, W, H, SPP, DEPTH, PRNGKey(SEED),
                            SEED, SceneFeatures.from_scene(scene))
    img = res.image.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    outside = ~lane_close(img, golden).all(axis=-1)
    share, budget = float(outside.mean()), pixel_budget(preset)
    assert share <= budget, (
        f"{preset}: {int(outside.sum())} pixels ({share:.4%}) outside 1e-3, "
        f"budget {budget:.4%}; largest difference "
        f"{np.abs(img - golden).max()}")
