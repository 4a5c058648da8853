"""The launch rules of the flat BVH traversal (``csrc/bvh_traverse.cu``)
and the turbulence (``csrc/turb.cu``), held on the CPU through their
Python mirrors, ``bvh_kernel.traverse_plan`` and
``turb_kernel.launch_plan``.

- The traversal launches one thread a ray in blocks of ``THREADS``, and
  picks its instance by the operand's flags: one for trees of inline
  static spheres alone, one for inline moving spheres alone, the general
  one for every other set of kinds; the mirror's constants are the
  source's.
- Of the six scenes ``chip_smoke.py`` times, ``random_spheres`` and
  ``random_spheres_xl`` take the static-sphere instance, ``random`` the
  moving one, the Cornell scenes and ``final_full`` the general one; so
  do the instanced-sphere scene and a scene of spheres and rects.
- The turbulence's list pass takes four lanes a thread, its octave pass
  every resident block but no more than eight threads a listed lane
  fill.

The card tests of tests/test_torch_cuda.py hold the C side's plans
(``pt_bvh_traverse_plan``, ``pt_noise_turb_plan``) to these mirrors, and
the kernels to their plain versions.
"""

import pathlib
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.models import bvh as pbvh  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import bvh_kernel, turb_kernel  # noqa: E402

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "pathtrace_tpu_torch" / "csrc")
SMS = 132


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_traverse_constants_are_the_sources():
    src = (CSRC / "bvh_traverse.cu").read_text()
    assert _constant(src, "kThreads") == bvh_kernel.THREADS
    kinds = re.search(r"enum Kinds \{ kAny = (\d), kSpheres = (\d), "
                      r"kMovingSpheres = (\d) \};", src)
    assert tuple(int(k) for k in kinds.groups()) == (
        bvh_kernel.INSTANCE_ANY, bvh_kernel.INSTANCE_SPHERES,
        bvh_kernel.INSTANCE_MOVING_SPHERES)


@pytest.mark.parametrize("n_rays,blocks", [
    (0, 0), (1, 1), (bvh_kernel.THREADS, 1), (bvh_kernel.THREADS + 1, 2),
    ((1 << 20) + 3, -(-((1 << 20) + 3) // bvh_kernel.THREADS)),
    (3_686_400, 3_686_400 // bvh_kernel.THREADS),
])
def test_traverse_plan_grid(n_rays, blocks):
    """One thread a ray: the grid is the rays over the block, rounded up."""
    plan = bvh_kernel.traverse_plan(n_rays, bvh_kernel.F_INLINE
                                    | bvh_kernel.F_SPHERES)
    assert plan["blocks"] == blocks
    assert plan["threads"] == bvh_kernel.THREADS


@pytest.mark.parametrize("flags,instance", [
    (bvh_kernel.F_INLINE | bvh_kernel.F_SPHERES, "spheres"),
    (bvh_kernel.F_INLINE | bvh_kernel.F_SPHERES | bvh_kernel.F_MOTION,
     "moving"),
    (bvh_kernel.F_SPHERES, "any"),  # instanced spheres
    (bvh_kernel.F_SPHERES | bvh_kernel.F_MOTION, "any"),
    (bvh_kernel.F_INLINE | bvh_kernel.F_SPHERES | bvh_kernel.F_RECTS, "any"),
    (bvh_kernel.F_RECTS | bvh_kernel.F_BOXES, "any"),
    (bvh_kernel.F_INLINE | bvh_kernel.F_MOTION | bvh_kernel.F_SPHERES
     | bvh_kernel.F_RECTS | bvh_kernel.F_BOXES | bvh_kernel.F_MEDIA, "any"),
])
def test_traverse_plan_instance(flags, instance):
    """Only a tree of inline spheres alone takes a sphere instance: any
    other kind, or spheres read by record, takes the general one."""
    want = {"spheres": bvh_kernel.INSTANCE_SPHERES,
            "moving": bvh_kernel.INSTANCE_MOVING_SPHERES,
            "any": bvh_kernel.INSTANCE_ANY}[instance]
    assert bvh_kernel.traverse_plan(4096, flags)["instance"] == want


def test_scenes_instance_choice():
    """The six timed scenes' operands pick the instances named above."""
    want = {"random_spheres": bvh_kernel.INSTANCE_SPHERES,
            "random_spheres_xl": bvh_kernel.INSTANCE_SPHERES,
            "random": bvh_kernel.INSTANCE_MOVING_SPHERES,
            "cornell": bvh_kernel.INSTANCE_ANY,
            "cornell_smoke": bvh_kernel.INSTANCE_ANY,
            "final_full": bvh_kernel.INSTANCE_ANY}
    for name, instance in want.items():
        scene, _ = presets.from_name(name, 16 / 9)
        feats = SceneFeatures.from_scene(scene)
        flat, _, offsets = pbvh.build_scene_bvh(scene)
        op = flat.operand(scene, feats, offsets, "cpu")
        plan = bvh_kernel.traverse_plan(3_686_400, op.flags)
        assert plan["instance"] == instance, name


def test_turb_plan():
    src = (CSRC / "turb.cu").read_text()
    assert _constant(src, "kThreads") == turb_kernel.THREADS
    assert _constant(src, "kLanes") == turb_kernel.LIST_LANES
    t = turb_kernel.THREADS
    per_list = t * turb_kernel.LIST_LANES
    assert turb_kernel.launch_plan(1, SMS, 8) == {"list_blocks": 1,
                                                  "octave_blocks": 1}
    assert turb_kernel.launch_plan(t, SMS, 8) == {"list_blocks": 1,
                                                  "octave_blocks": 8}
    assert turb_kernel.launch_plan(per_list + 1, SMS, 8) == {
        "list_blocks": 2, "octave_blocks": 33}
    full = turb_kernel.launch_plan(3_686_400, SMS, 8)
    assert full == {"list_blocks": 3_686_400 // per_list,
                    "octave_blocks": SMS * 8}
