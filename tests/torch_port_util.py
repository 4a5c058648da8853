"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a fixed seed and handed to both packages;
arrays cross between JAX and PyTorch as numpy.
"""

import dataclasses

import numpy as np

# state planes of both packages' fused bounce, in the port's row order
PLANE_NAMES = ("rox", "roy", "roz", "rdx", "rdy", "rdz",
               "rad_r", "rad_g", "rad_b", "thr_r", "thr_g", "thr_b")

_SCENE_GROUPS = ("spheres", "rects", "boxes", "media", "materials",
                 "textures")


def jax_scene_leaves(scene) -> dict:
    """The JAX Scene flattened to dotted-key numpy leaves (the format of
    ``pathtrace_tpu_torch.models.convert.scene_from_numpy``)."""
    out = {}
    for group in _SCENE_GROUPS:
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if val is not None:
                out[f"{group}.{f.name}"] = np.asarray(val)
    out["sky"] = np.asarray(scene.sky)
    out["use_gradient_sky"] = np.asarray(scene.use_gradient_sky)
    return out


def jax_camera_leaves(camera) -> dict:
    return {f"camera.{f.name}": np.asarray(getattr(camera, f.name))
            for f in dataclasses.fields(camera)}


def lit_scene(builder):
    """A scene for the shade branches no ported preset reaches: emissive
    spheres and a constant (non-gradient) sky. ``builder`` is either
    package's ``SceneBuilder``; both build identical leaves from it."""
    b = builder
    b.sky = (0.05, 0.1, 0.2)
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian_color((0.5, 0.5, 0.5)))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((0.1, 0.2, 0.5)))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1.0, 0.0, -1.0), 0.5, b.dielectric(1.5))
    b.sphere((0.0, 1.5, -1.0), 0.7, b.diffuse_light_color((4.0, 4.0, 4.0)))
    return b.finish()


def scene_pair(name: str, aspect: float):
    """(JAX scene, JAX camera, port scene) for a ported preset, or for
    ``"lit"``: :func:`lit_scene` seen through the ``small`` camera."""
    from pathtrace_tpu.models import build as jbuild
    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu_torch.models import build, presets

    if name == "lit":
        _, jcam = jpresets.small(aspect)
        return (lit_scene(jbuild.SceneBuilder()), jcam,
                lit_scene(build.SceneBuilder()))
    jscene, jcam = jpresets.from_name(name, aspect)
    return jscene, jcam, presets.from_name(name, aspect)[0]


def numpy_uniforms(n: int, seed: int = 0):
    """Film coordinates s, t and lens/time uniforms, made with numpy."""
    rng = np.random.default_rng(seed)
    s = rng.random(n, dtype=np.float32)
    t = rng.random(n, dtype=np.float32)
    u = rng.random((n, 3), dtype=np.float32)
    return s, t, u


def jax_camera_rays(camera, n: int, seed: int = 0):
    """Primary rays from the JAX camera on numpy-made uniforms (numpy)."""
    import jax.numpy as jnp

    from pathtrace_tpu.camera import get_rays

    s, t, u = numpy_uniforms(n, seed)
    ro, rd, tm = get_rays(camera, jnp.asarray(s), jnp.asarray(t),
                          jnp.asarray(u))
    return np.asarray(ro), np.asarray(rd), np.asarray(tm)


def lane_close(a, b, rtol=1e-3, atol=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= atol + rtol * np.abs(b)


def assert_lanes_close(a, b, outlier_budget=0.005, rtol=1e-3, atol=1e-3,
                       what=""):
    """The per-lane contract of tests/test_shade_pallas.py: lanes agree to
    rtol = atol = 1e-3, except at most ``outlier_budget`` of them (lanes
    whose discrete decision flipped on a ULP boundary)."""
    close = lane_close(a, b, rtol, atol)
    frac_bad = 1.0 - close.mean()
    assert frac_bad <= outlier_budget, (
        f"{what}: {frac_bad:.4%} lanes beyond tolerance "
        f"(max diff {np.abs(np.asarray(a, np.float64) - b).max()})"
    )
    return frac_bad


# Lane contract of the depth-10 slice: per-ray radiance to 1e-3, at most
# 1% of rays outside, twice the 0.5% of one bounce, because divergence
# compounds over ten bounces: the closest hit's expanded quadratic is
# ill-conditioned for the 0.2-radius spheres, so a ~1e-4 relative change
# in t (XLA rounds the quadratic's terms differently) tilts the normal
# and the scattered ray. Measured on the fixture's 4096 rays (CPU and
# card alike): 18 rays outside (0.44%). 12 of them hit a different sphere,
# or hit where the other missed, at some bounce: 7 right after a bounce
# off a 0.2-radius sphere, 4 after the 1000-radius ground, 1 a grazing
# camera ray. The other 6 hit the same spheres in the same order and
# still drift past 1e-3.
DEPTH10_BUDGET = 0.01


def check_slice_contract(radiance, ray_count, ref_radiance, ref_count,
                         max_depth, budget=0.005):
    """Per-ray radiance within 1e-3 except ``budget`` of the rays; the
    segment counts differ by at most max_depth per ray outside (a path
    that diverged may be up to max_depth segments longer or shorter).
    Returns the fraction of rays outside."""
    close = lane_close(radiance, ref_radiance).all(axis=1)
    n_out = int((~close).sum())
    frac = n_out / close.size
    assert frac <= budget, f"{frac:.4%} of rays beyond 1e-3"
    assert abs(int(ray_count) - int(ref_count)) <= n_out * max_depth, (
        ray_count, ref_count, n_out)
    return frac
