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

# The same contract on random_spheres_xl (the 64x64 grid of 0.2-radius
# spheres, tests/goldens/torch_port_random_spheres_xl.npz): nearly every
# bounce there meets a small sphere, so the divergence compounds further.
# Measured on the fixture's 9216 tile-ordered rays against JAX (CPU, both
# with the cull on and off, which are bit-identical in each package):
# 0.26% of rays outside after 1 bounce (inside the 0.5% of one bounce),
# 0.55% after 2, 0.72% after 3, 0.94% after 5 and 1.14% after 10.
XL_DEPTH10_BUDGET = 0.02


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


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 when both are zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_trace_vjp(jscene, ro, rd, tm, seed, depth):
    """JAX ``trace_fast_diff`` of numpy rays: (radiance, a function from
    weights w to the per-leaf gradients of sum(w * radiance), the
    default-trainable leaf names), all numpy."""
    import jax
    import jax.numpy as jnp

    from pathtrace_tpu.models.types import SceneFeatures
    from pathtrace_tpu.ops.fastpath import trace_fast_diff
    from pathtrace_tpu.parallel.inverse import split_scene

    params, rebuild, names = split_scene(jscene)
    feats = SceneFeatures.from_scene(jscene)

    def radiance(p):
        return trace_fast_diff(rebuild(p), jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(tm), seed, depth, feats)[0]

    rad, vjp = jax.vjp(radiance, params)
    return (np.asarray(rad),
            lambda w: [np.asarray(g) for g in vjp(jnp.asarray(w))[0]], names)


def port_trace_diff(scene, ro, rd, tm, seed, depth):
    """The port's differentiable trace of numpy rays on the CPU: (radiance
    tensor, trainable leaves, their names)."""
    import torch

    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops.fastpath import trace_fast_diff
    from pathtrace_tpu_torch.parallel.inverse import split_scene

    params, rebuild, names = split_scene(scene)
    rad, _ = trace_fast_diff(
        rebuild(params), *(torch.from_numpy(np.ascontiguousarray(x))
                           for x in (ro, rd, tm)),
        seed, depth, SceneFeatures.from_scene(scene))
    return rad, params, names


def port_grads(rad, params, w):
    """Per-leaf gradients (numpy) of sum(w * radiance)."""
    import torch

    grads = torch.autograd.grad((torch.from_numpy(w) * rad).sum(), params,
                                retain_graph=True)
    return [g.numpy() for g in grads]


def assert_grads_close(got, ref, names, tol, what):
    """Every leaf finite and within its relative-L2 bound (0 if absent)."""
    for name, a, b in zip(names, got, ref):
        assert np.isfinite(a).all(), f"{what} {name}: not finite"
        err = rel_l2(a, b)
        assert err <= tol.get(name, 0.0), f"{what} {name}: rel L2 {err:.3e}"


# Per-leaf relative-L2 bounds of the trace gradient (depth 4) against JAX
# on the rays inside the lane contract: about twice what 2048 rays of
# random_spheres and small measured on the CPU (centre 1.5e-2, radius
# 1.8e-2, fuzz 2.4e-3, ref_idx 2.5e-3, colour 1.8e-4). The closest hit's
# expanded quadratic rounds differently in XLA and moves t by up to ~1e-4
# relative; the normals of the 0.2-radius spheres amplify that in the
# centre and radius gradients (see tests/test_torch_grad.py). In a static
# scene the motion leaf gets no gradient on either side, hence 0.0; moving
# scenes take MOTION_GRAD_TOL.
GRAD_TOL = {
    "spheres.center": 3e-2,
    "spheres.center_delta": 0.0,
    "spheres.radius": 4e-2,
    "materials.fuzz": 5e-3,
    "materials.ref_idx": 5e-3,
    "textures.color": 1e-3,
}

# Per-leaf relative-L2 bounds of the trace gradient against the committed
# JAX fixture (tests/goldens/torch_port_grad_small.npz), whose weights keep
# only rays that agree with JAX to 1e-5: two to four times the readings of
# the port on the CPU (centre 1.41e-3, radius 2.23e-3, fuzz 1.29e-3,
# ref_idx 1.22e-3, colour 2.57e-5) and on the card (centre 1.6e-3, radius
# 2.3e-3, fuzz 1.3e-3, ref_idx 1.1e-3, colour 2.6e-5). A planted fault in
# the closest hit's backward reads far above them: g_ro and g_rd zeroed
# give centre 0.77 and radius 0.94, the sign of g_center flipped gives
# centre 1.03.
FIXTURE_GRAD_TOL = {
    "spheres.center": 5e-3,
    "spheres.center_delta": 0.0,
    "spheres.radius": 5e-3,
    "materials.fuzz": 3e-3,
    "materials.ref_idx": 3e-3,
    "textures.color": 1e-4,
}

# The same bounds for the motion-blurred ``random`` preset (391 of its 488
# spheres move), whose motion leaf ``spheres.center_delta`` now gets a
# gradient: through K6's lerped centre and through the time-lerped normal.
# Its bound is about twice the CPU reading on 2048 camera rays at depth 4
# (tests/test_torch_motion.py): 1.48e-2 (centre 1.45e-2, radius 1.40e-2,
# fuzz 1.2e-3, ref_idx 1.5e-4, colour 2.9e-4, inside GRAD_TOL).
MOTION_GRAD_TOL = {**GRAD_TOL, "spheres.center_delta": 3e-2}

# The committed gradient fixture of ``random``
# (tests/goldens/torch_port_grad_random.npz, weights kept on rays that
# agree with JAX to 1e-5): about three times the port's CPU readings on it
# (centre 1.42e-3, delta 2.77e-3, radius 1.02e-3, fuzz 5.99e-3, ref_idx
# 1.7e-4, colour 2.5e-5). The fuzz gradient comes from the few rays that
# reach the metal spheres, so its reading varies with the weights: 4e-4 to
# 6e-3 over five draws of them on the same rays.
MOTION_FIXTURE_GRAD_TOL = {
    "spheres.center": 5e-3,
    "spheres.center_delta": 1e-2,
    "spheres.radius": 5e-3,
    "materials.fuzz": 2e-2,
    "materials.ref_idx": 1e-3,
    "textures.color": 1e-4,
}
