"""The differentiable bounce on boxes, media and images, and the trainer's
routing: the port against the JAX package's ``trace_fast_diff`` and its
``make_inverse_renderer``.

``trace_fast_diff`` on ``cornell`` (boxes), ``cornell_smoke`` (media),
``earth`` (an image), and two scenes no preset covers
(``tests/torch_port_util.py``): ``sky_boxes``, boxes under the gradient
sky, where the box faces' normals carry gradients to ``world_from_obj``,
and ``image_box``, image textures on a box, a rect and a sphere (the box
UV; the fused fast path refuses it). 2048 camera rays at depth 4, the
gradient of ``sum(w * radiance)``, ``w`` from numpy, per leaf by relative
L2 against ``jax.vjp`` of the reference. The default-trainable leaves are
held at ``GRAD_TOL`` (tests/torch_port_util.py); the leaves beyond it at
``EXTRA_TOL`` below, about four times the CPU readings, or at the
default's colour bound where the reading is zero. Radiance: the lane
contract (1e-3, 0.5% of rays outside).

The JAX side is the committed fixture
``tests/goldens/torch_port_diff_scenes.npz`` (rays, radiance, gradients);
``PYTHONPATH=. python tests/test_torch_diff_scenes.py`` rewrites it on the
CPU, together with the general-path trainer's fixture
(``torch_port_general_train.npz``: JAX's first loss and gradients of a
scene the fast path refuses, on a one-device mesh; ``--general`` rewrites
that one only).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.camera import make_camera  # noqa: E402
from pathtrace_tpu_torch.models import build, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.parallel import inverse as tinv  # noqa: E402
from torch_port_util import (  # noqa: E402
    GRAD_TOL, assert_grads_close, assert_lanes_close, image_box_scene,
    lane_close, scene_camera, sky_boxes_scene,
)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FIXTURE = os.path.join(GOLDENS, "torch_port_diff_scenes.npz")
GENERAL_FIXTURE = os.path.join(GOLDENS, "torch_port_general_train.npz")
N_RAYS, DEPTH, SEED = 2048, 4, 7
ASPECT = 16 / 9

# name -> the leaves trained beside the default selector's
CASES = {
    "cornell": ("rects.k", "boxes.world_from_obj"),
    "cornell_smoke": ("media.density", "media.p0"),
    "earth": ("atlas.data",),
    "sky_boxes": ("rects.k", "boxes.p0", "boxes.p1", "boxes.world_from_obj"),
    "image_box": ("atlas.data", "boxes.world_from_obj"),
}

# Relative-L2 bounds of the leaves beyond the default selector (about four
# times the CPU readings: sky_boxes' boxes.p0 2.9e-6, boxes.p1 2.2e-6,
# world_from_obj 1.4e-5; earth's atlas 5.6e-7; image_box's atlas 4.6e-7
# and world_from_obj 1.1e-5; the geometry of cornell and cornell_smoke gets
# no gradient in either package (flat faces, constant textures, a black
# sky), so theirs is held to zero). A fault in the box normal's backward
# reads far above: world_from_obj's gradient zeroed gives 1.0.
EXTRA_TOL = {
    "rects.k": 1e-4,
    "boxes.p0": 1e-4,
    "boxes.p1": 1e-4,
    "boxes.world_from_obj": 1e-4,
    "media.density": 1e-4,
    "media.p0": 1e-4,
    "atlas.data": 1e-5,
}


def case_scene(name, package="torch"):
    """(scene, camera) of a case, from the port or (``"jax"``) the JAX
    package."""
    if package == "jax":
        from pathtrace_tpu.camera import make_camera as mk
        from pathtrace_tpu.models import build as bld
        from pathtrace_tpu.models import presets as pre
    else:
        mk, bld, pre = make_camera, build, presets
    if name == "sky_boxes":
        return sky_boxes_scene(bld), scene_camera(mk, ASPECT)
    if name == "image_box":
        return image_box_scene(bld), scene_camera(mk, ASPECT)
    return pre.from_name(name, ASPECT)[:2]


def trainable_of(name):
    extra = CASES[name]
    return lambda p: tinv.default_trainable(p) or p in extra


def port_diff(name, ro, rd, tm, w):
    """The port's radiance and per-leaf gradients of sum(w * radiance)."""
    scene, _ = case_scene(name)
    params, rebuild, names = tinv.split_scene(scene, trainable_of(name))
    rad, _ = tfp.trace_fast_diff(
        rebuild(params), *(torch.from_numpy(x) for x in (ro, rd, tm)), SEED,
        DEPTH, SceneFeatures.from_scene(scene))
    grads = torch.autograd.grad((torch.from_numpy(w) * rad).sum(), params,
                                allow_unused=True)
    return rad.detach().numpy(), names, [
        np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
        for p, g in zip(params, grads)]


@pytest.mark.parametrize("name", list(CASES))
def test_trace_fast_diff_matches_jax(name):
    ref = np.load(FIXTURE)
    ro, rd, tm, w = (ref[f"{name}.{k}"] for k in ("ro", "rd", "time", "w"))
    rad, names, grads = port_diff(name, ro, rd, tm, w)
    assert names == list(ref[f"{name}.names"])
    assert_lanes_close(rad, ref[f"{name}.radiance"], what=f"{name} radiance")
    tol = {**GRAD_TOL, **EXTRA_TOL}
    assert_grads_close(grads, [ref[f"{name}.grad.{n}"] for n in names],
                       names, tol, name)
    extra = [g for n, g in zip(names, grads) if n in CASES[name]]
    if name in ("sky_boxes", "image_box", "earth"):
        assert all(np.abs(g).max() > 0 for g in extra), name


def test_diff_supported_takes_what_fastpath_takes():
    """``diff_supported`` refuses only what the reference's
    ``fastpath_supported`` refuses: boxes, media and images pass, an image
    on a box too (the fused path's refusal; ``final_full`` and
    ``image_box``), while more than 128 rects, instances and checkers
    with non-constant children are refused."""
    for name in ("cornell", "cornell_smoke", "earth", "image_box",
                 "sky_boxes", "small", "simple_light", "final_full"):
        scene = case_scene(name)[0] if name in CASES else presets.from_name(
            name, ASPECT)[0]
        feats = SceneFeatures.from_scene(scene)
        assert tfp.diff_supported(feats, scene)
        assert tfp.diff_refusal(feats, scene) is None
        if name in ("image_box", "final_full"):
            assert "image textures" in tfp.fastpath_refusal(feats, scene)
        else:
            assert tfp.fastpath_supported(feats, scene)
    b = build.SceneBuilder()
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    b.sphere((0.0, 0.0, 0.0), 0.5, mat,
             build.affine_from_rotation_y_translation(10.0, (0.0, 0.0, -1.0)))
    instanced = b.finish()
    b = build.SceneBuilder()
    for i in range(129):
        b.rect_xy(0.0, 1.0, 0.0, 1.0, -1.0 - i, False, mat)
    many_rects = b.finish()
    for scene, why in ((instanced, "instanced"), (many_rects, "129 rects"),
                       (_nested_checker_scene(), "non-constant children")):
        feats = SceneFeatures.from_scene(scene)
        with pytest.raises(ValueError, match=why):
            tfp.diff_supported(feats, scene)


def _nested_checker_scene():
    b = build.SceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian(
        b.checker_texture(b.noise_texture(4.0),
                          b.constant_texture((0.9, 0.9, 0.9)))))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((0.1, 0.2, 0.5)))
    return b.finish()


# The general path's first-step gradients against JAX's: ``GRAD_TOL``,
# but the fuzz at three times its CPU reading (1.0e-2; centre 2.0e-3,
# radius 4.0e-4, colour 2.5e-6): it sums the few rays that reach the metal
# sphere, whose scattered directions the closest hit's rounding tilts.
GENERAL_TOL = {**GRAD_TOL, "materials.fuzz": 3e-2}


def general_train_problem(package="torch"):
    """The general path's trainer problem: a checker whose child is a
    checker (the fast path refuses it) under a Lambertian and a metal
    sphere, 32x18 x 2 spp at depth 3, the target the scene's own render
    with the colours +0.2. (A noise child is refused alike, but its
    gradient through a reflected hit point is ill-conditioned: a ~1e-4
    relative change of the ground's t, the closest hit's known rounding
    difference, moves the finest octave's phase by a quarter.)"""
    if package == "jax":
        from pathtrace_tpu.models import build as bld
        from pathtrace_tpu.models import presets as pre
    else:
        bld, pre = build, presets
    b = bld.SceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian(b.checker_texture(
        b.checker_texture(b.constant_texture((0.2, 0.3, 0.1)),
                          b.constant_texture((0.5, 0.5, 0.5))),
        b.constant_texture((0.9, 0.9, 0.9)))))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((0.1, 0.2, 0.5)))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    return b.finish(), pre.small(32 / 18)[1], 32, 18, 2, 3


def test_trainer_routes_refused_scenes_to_the_general_path():
    """``make_inverse_renderer(use_fast_path=None)`` trains a scene the
    fast path refuses through ``render_frame(..., differentiable=True)``,
    keyed as the reference's one-device ``render_frame_sharded``: its
    render at ``PRNGKey(0)`` to 1e-3 but for 2% of the pixels (a pixel's 2
    rays, 0.5% a ray), the first loss to 1e-3 relative and its gradients
    within ``GENERAL_TOL`` of JAX's (the fixture). ``use_fast_path=True``
    refuses it; a preset the fast path takes routes there."""
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    ref = np.load(GENERAL_FIXTURE)
    scene, cam, W, H, S, D = general_train_problem()
    renderer, state, names = tinv.make_inverse_renderer(
        scene, cam, W, H, samples=S, max_depth=D, device="cpu")
    assert not renderer.use_fast_path
    assert names == list(ref["names"])
    with torch.no_grad():
        target = renderer.render(state.params, PRNGKey(0))
        outside = ~lane_close(target.numpy(), ref["target"]).all(axis=-1)
        assert outside.mean() <= 0.02, outside.mean()
        for i, n in enumerate(names):
            if n == "textures.color":
                state.params[i].copy_((state.params[i] + 0.2).clamp(0, 1))
    state, loss = renderer.train_step(state, torch.from_numpy(ref["target"]),
                                      PRNGKey(0))
    assert float(loss) == pytest.approx(float(ref["loss"]), rel=1e-3)
    assert_grads_close([p.grad.numpy() for p in state.params],
                       [ref[f"grad.{n}"] for n in names], names, GENERAL_TOL,
                       "general path")
    with pytest.raises(ValueError, match="non-constant children"):
        tinv.make_inverse_renderer(scene, cam, W, H, device="cpu",
                                   use_fast_path=True)
    small, cam = presets.small(1.0)
    assert tinv.make_inverse_renderer(small, cam, 8, 8, device="cpu")[
        0].use_fast_path


@pytest.mark.parametrize("name", ["cornell", "cornell_smoke", "image_box"])
def test_trainer_takes_box_media_and_image_scenes(name):
    """One trainer step on each scene class the differentiable bounce
    gained, through the fast path: finite loss and gradients, and the
    colours move."""
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    scene, cam = case_scene(name)
    renderer, state, names = tinv.make_inverse_renderer(
        scene, cam, 32, 18, samples=2, max_depth=4, device="cpu")
    assert renderer.use_fast_path
    before = [p.detach().clone() for p in state.params]
    state, loss = renderer.train_step(state, torch.full((18, 32, 3), 0.5),
                                      PRNGKey(1))
    assert np.isfinite(float(loss)) and float(loss) > 0
    for n, p, p0 in zip(names, state.params, before):
        assert torch.isfinite(p.grad).all(), n
        if n == "textures.color":
            assert not torch.equal(p.detach(), p0)


# ---------------------------------------------------------------------------
# the fixtures (JAX on the CPU)
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    import jax
    import jax.numpy as jnp

    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops import fastpath as jfp
    from pathtrace_tpu.parallel import inverse as jinv
    from torch_port_util import jax_camera_rays

    out = {}
    for i, name in enumerate(CASES):
        jscene, jcam = case_scene(name, "jax")
        ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=30 + i)
        w = np.random.default_rng(40 + i).standard_normal(
            (N_RAYS, 3)).astype(np.float32)
        params, rebuild, names = jinv.split_scene(jscene, trainable_of(name))
        feats = JFeatures.from_scene(jscene)

        def radiance(p):
            return jfp.trace_fast_diff(rebuild(p), jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.asarray(tm),
                                       SEED, DEPTH, feats)[0]

        rad, vjp = jax.vjp(radiance, params)
        grads = vjp(jnp.asarray(w))[0]
        out.update({f"{name}.ro": ro, f"{name}.rd": rd, f"{name}.time": tm,
                    f"{name}.w": w, f"{name}.radiance": np.asarray(rad),
                    f"{name}.names": np.array(names)})
        out.update({f"{name}.grad.{n}": np.asarray(g)
                    for n, g in zip(names, grads)})
    return out


def make_general_fixture() -> dict:
    import jax

    from pathtrace_tpu.parallel import inverse as jinv
    from pathtrace_tpu.parallel import mesh as pmesh

    scene, cam, W, H, S, D = general_train_problem("jax")
    r, state, names = jinv.make_inverse_renderer(
        scene, cam, W, H, samples=S, max_depth=D,
        mesh=pmesh.make_render_mesh(jax.devices()[:1]))
    assert not r.use_fast_path
    key = jax.random.PRNGKey(0)
    target = np.asarray(r.render(state.params, key))
    params = [(p + 0.2).clip(0.0, 1.0) if n == "textures.color" else p
              for p, n in zip(state.params, names)]
    loss, grads = jax.value_and_grad(r.loss)(params, target, key)
    out = {"names": np.array(names), "target": target,
           "loss": np.float32(loss)}
    out.update({f"grad.{n}": np.asarray(g) for n, g in zip(names, grads)})
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import sys

    todo = ((FIXTURE, make_fixture), (GENERAL_FIXTURE, make_general_fixture))
    for path, fn in todo[1:] if "--general" in sys.argv else todo:
        np.savez_compressed(path, **fn())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
