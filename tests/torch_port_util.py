"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a fixed seed and handed to both packages;
arrays cross between JAX and PyTorch as numpy.
"""

import contextlib
import dataclasses
import functools
import os
import re

import numpy as np

# JAX's fused trace_fast of simple_light (4096 camera rays, depth 10),
# regenerated by tests/test_torch_rects.py
LIGHT_FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                             "torch_port_simple_light.npz")

# state planes of both packages' fused bounce, in the port's row order
PLANE_NAMES = ("rox", "roy", "roz", "rdx", "rdy", "rdz",
               "rad_r", "rad_g", "rad_b", "thr_r", "thr_g", "thr_b")

_SCENE_GROUPS = ("spheres", "rects", "boxes", "media", "materials",
                 "textures", "perlin", "atlas")


def jax_scene_leaves(scene, atlas: bool = True) -> dict:
    """The JAX Scene flattened to dotted-key numpy leaves (the format of
    ``pathtrace_tpu_torch.models.convert.scene_from_numpy``). The atlas's
    ``data_planes``, a transposed copy of ``data`` the port does not
    keep, is left out; ``atlas=False`` leaves out the whole atlas and the
    Perlin tables (the leaves of fixtures written before them, which
    convert with the placeholder atlas and the default tables)."""
    out = {}
    for group in _SCENE_GROUPS if atlas else _SCENE_GROUPS[:-2]:
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if val is not None and f.name != "data_planes":
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


def boards_scene(builder):
    """Rects of every axis, flipped and not, one of them a light, over two
    spheres: the cases of the rect sweep and of the sphere/rect merge.
    ``builder`` is either package's ``SceneBuilder``."""
    b = builder
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    light = b.diffuse_light_color((4.0, 4.0, 4.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    b.sphere((0.0, 1.0, 0.0), 1.0, mat)
    b.rect_xy(-2.0, 2.0, 0.0, 3.0, -1.5, True, mat)
    b.rect_xz(-1.0, 1.0, -2.0, 2.0, 2.5, False, light)
    b.rect_yz(0.0, 2.0, -1.0, 1.0, 1.0, True, mat)
    b.rect_xy(-3.0, 3.0, 0.0, 4.0, -4.0, False, mat)
    return b.finish()


def mixed_scene(build):
    """Every primitive kind in one scene, built by either package's build
    module ``build``: a ground sphere, a rect light, a box under an
    ``affine_from_axis_angle`` (scaled) composed with a rotation about y,
    an unrotated metal box, a sphere medium and a rotated box medium. Both
    packages build identical leaves from it."""
    b = build.SceneBuilder()
    b.sky = (0.1, 0.1, 0.2)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5, 0.5, 0.5)))
    b.rect_xz(-3.0, 3.0, -3.0, 3.0, 4.0, True,
              b.diffuse_light_color((4.0, 4.0, 4.0)))
    xf = build.affine_compose(
        build.affine_from_axis_angle((1.0, 2.0, 0.5), 30.0, (0.5, 0.0, 0.0),
                                     scale=1.5),
        build.affine_from_rotation_y_translation(20.0, (0.0, 0.5, -1.0)))
    b.box((-0.5, 0.0, -0.5), (0.5, 1.0, 0.5),
          b.lambertian_color((0.8, 0.3, 0.2)), xf)
    b.box((1.0, 0.0, 1.0), (2.0, 0.5, 2.0), b.metal((0.8, 0.8, 0.8), 0.1))
    b.medium_sphere((-1.5, 0.8, 0.5), 0.8, 0.5,
                    b.constant_texture((0.9, 0.9, 0.9)))
    b.medium_box((1.0, 0.0, -2.0), (2.0, 1.0, -1.0), 0.8,
                 b.constant_texture((0.3, 0.6, 0.9)),
                 build.affine_from_rotation_y_translation(10.0, (0.0, 0.0, 0.0)))
    return b.finish()


def sky_boxes_scene(build):
    """Boxes under the gradient sky, built by either package's build module
    ``build``: a metal box rotated about y and a Lambertian box under an
    axis-angle affine on a ground sphere, and a back wall rect. The sky
    makes a path's radiance depend on its scattered directions, so the
    box faces' normals (the differentiable bounce's slab test redone from
    the winner's row) carry gradients to ``world_from_obj``."""
    b = build.SceneBuilder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5, 0.5, 0.5)))
    b.box((-0.5, 0.0, -0.5), (0.5, 1.0, 0.5), b.metal((0.8, 0.8, 0.8), 0.05),
          build.affine_from_rotation_y_translation(25.0, (-0.6, 0.0, -1.0)))
    b.box((0.2, 0.0, 0.2), (0.9, 0.7, 0.9), b.lambertian_color((0.7, 0.3, 0.2)),
          build.affine_from_axis_angle((1.0, 2.0, 0.5), 20.0, (0.5, 0.0, -0.8)))
    b.rect_xy(-3.0, 3.0, 0.0, 2.0, -3.0, False,
              b.lambertian_color((0.3, 0.5, 0.7)))
    return b.finish()


def image_box_scene(build):
    """Image textures on a rotated box, a rect and a sphere under the
    gradient sky, built by either package's build module ``build``: the
    fused fast path refuses it, the differentiable bounce takes it (the
    box UV). The 8x16 image is drawn by numpy from seed 0."""
    img = np.random.default_rng(0).random((8, 16, 3), dtype=np.float32)
    b = build.SceneBuilder()
    tex = b.image_texture(img)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5, 0.5, 0.5)))
    b.sphere((1.0, 0.5, -1.0), 0.5, b.lambertian(tex))
    b.box((-0.5, 0.0, -0.5), (0.5, 1.0, 0.5), b.lambertian(tex),
          build.affine_from_rotation_y_translation(30.0, (-0.7, 0.0, -1.2)))
    b.rect_xy(-3.0, 3.0, 0.0, 2.0, -3.0, False, b.lambertian(tex))
    return b.finish()


def scene_camera(make_camera, aspect: float = 16 / 9):
    """The camera of :func:`sky_boxes_scene` and :func:`image_box_scene`,
    from either package's ``make_camera``."""
    return make_camera((0.0, 1.5, 3.0), (0.0, 0.5, -1.0), (0.0, 1.0, 0.0),
                       50.0, aspect, 0.0, 4.0)


# The scenes of the silhouette checks (tests/test_torch_silhouette.py),
# twins of tests/test_silhouette.py's: a flat-shaded sphere, rect or box
# under a constant sky, a moving sphere under a shutter-open camera, and a
# mixed scene of the three families.
SIL_EYE = ((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0, 1.0)


def sil_camera(make_camera, aperture: float = 0.0, shutter: bool = False):
    """tests/test_silhouette.py's camera (``CAM``; ``MCAM`` with
    ``shutter``) from either package's ``make_camera``."""
    kw = {"time0": 0.0, "time1": 1.0} if shutter else {}
    return make_camera(*SIL_EYE, aperture, 3.0, **kw)


def flat_sphere_scene(build, cx=0.0):
    b = build.SceneBuilder()
    b.sphere((cx, 0.0, 0.0), 0.6, b.lambertian_color((0.15, 0.15, 0.15)))
    b.sky = (0.75, 0.75, 0.75)
    return b.finish()


def moving_flat_scene(build, dx):
    b = build.SceneBuilder()
    b.moving_sphere((0.0, 0.0, 0.0), (dx, 0.0, 0.0), 0.0, 1.0, 0.6,
                    b.lambertian_color((0.15, 0.15, 0.15)))
    b.sky = (0.75, 0.75, 0.75)
    return b.finish()


def flat_rect_scene(build, dx):
    b = build.SceneBuilder()
    b.rect_xy(-0.483 + dx, 0.517 + dx, -0.483, 0.517, 0.0, False,
              b.lambertian_color((0.15, 0.15, 0.15)))
    b.sky = (0.75, 0.75, 0.75)
    return b.finish()


def flat_box_scene(build, dx):
    b = build.SceneBuilder()
    b.box((-0.395, -0.41, -0.4), (0.405, 0.39, 0.4),
          b.lambertian_color((0.15, 0.15, 0.15)),
          build.affine_from_rotation_y_translation(25.0, (dx, 0.013, 0.0)))
    b.sky = (0.75, 0.75, 0.75)
    return b.finish()


def mixed_edges_scene(build):
    """tests/test_silhouette.py's mixed scene (a sphere, a rect and a
    rotated box) with a moving sphere added."""
    b = build.SceneBuilder()
    b.sphere((-0.8, 0.0, 0.0), 0.4, b.lambertian_color((0.2, 0.2, 0.2)))
    b.moving_sphere((0.3, 0.4, 0.0), (0.3, 0.0, 0.0), 0.0, 1.0, 0.3,
                    b.lambertian_color((0.6, 0.2, 0.2)))
    b.rect_xy(-0.3, 0.3, -0.3, 0.3, -0.5, False,
              b.lambertian_color((0.2, 0.2, 0.2)))
    b.box((0.5, -0.3, -0.3), (1.1, 0.3, 0.3), b.lambertian_color((0.2, 0.2, 0.2)),
          build.affine_from_rotation_y_translation(15.0, (0.0, 0.0, 0.0)))
    b.sky = (0.75, 0.75, 0.75)
    return b.finish()


def silhouette_cases(build, make_camera):
    """name -> (scene, camera, width, height, max_depth, n_samples) of the
    silhouette fixture (tests/goldens/torch_port_silhouette.npz), from
    either package's build module and ``make_camera``."""
    return {
        "sphere": (flat_sphere_scene(build, 0.25), sil_camera(make_camera),
                   32, 32, 3, 128),
        "moving": (moving_flat_scene(build, 0.55),
                   sil_camera(make_camera, shutter=True), 32, 32, 3, 128),
        "aperture": (flat_sphere_scene(build, 0.2137),
                     sil_camera(make_camera, aperture=0.25), 40, 40, 3, 128),
        "rect": (flat_rect_scene(build, 0.2137), sil_camera(make_camera),
                 40, 40, 3, 128),
        "box": (flat_box_scene(build, 0.2137), sil_camera(make_camera),
                40, 40, 3, 128),
        "mixed": (mixed_edges_scene(build),
                  sil_camera(make_camera, aperture=0.1, shutter=True),
                  32, 32, 2, 64),
    }


# The silhouette fixture's key (``PRNGKey(SIL_KEY_SEED)`` in both packages)
# and the bound of a whole boundary term against it, per leaf by relative
# L2 (tests/test_torch_silhouette.py gives the reasons).
SIL_KEY_SEED = 2
SIL_WHOLE_TOL = 5e-2


def sil_grad_img(name: str, height: int, width: int) -> np.ndarray:
    """The loss cotangent of a silhouette case: numpy normals from a seed
    of the case's name, scaled to an MSE's."""
    seed = sum(map(ord, name))
    g = np.random.default_rng(seed).standard_normal((height, width, 3))
    return (g * (2.0 / (height * width * 3))).astype(np.float32)


def jax_rect_scene_winners(jscene, ro, rd):
    """JAX's closest hit over spheres (Pallas, interpret mode) and rects,
    merged as ``_fast_bounce_fused_prims`` merges them (numpy)."""
    import jax.numpy as jnp

    from pathtrace_tpu.config import MAX_T, MIN_T
    from pathtrace_tpu.ops import intersect as jisect
    from pathtrace_tpu.ops.intersect_pallas import sphere_nearest_pallas_cols

    cols = [jnp.asarray(c) for c in (*ro.T, *rd.T)]
    t, idx = sphere_nearest_pallas_cols(
        jscene.spheres, *cols, jnp.zeros(ro.shape[0], jnp.float32), MIN_T,
        MAX_T, has_motion=False, cull=False)
    t_r, i_r = jisect.rect_nearest_planes(jscene.rects, *cols)
    offset = ((jscene.spheres.center.shape[0] + 127) // 128) * 128
    wins = t_r < t
    return (np.asarray(jnp.where(wins, t_r, t)),
            np.asarray(jnp.where(wins, offset + i_r, idx)))


def jax_scene_winners(jscene, ro, rd, lane=None, seed=0, depth=0):
    """JAX's closest hit over every kind of a scene, merged in the order
    ``_fast_bounce_fused_prims`` merges them (numpy): spheres (Pallas in
    interpret mode; no sweep in a scene without spheres), rects, boxes and
    media (the free-flight draws ``8 + j`` of ``lane``, ``seed`` and
    ``depth``), each winning only when strictly nearer. idx is a row of
    the blocks sphere, rect (rect scenes), box, medium: the port's winner
    table."""
    import jax.numpy as jnp

    from pathtrace_tpu.config import MAX_T, MIN_T
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops import fastpath as jfp
    from pathtrace_tpu.ops import intersect as jisect
    from pathtrace_tpu.ops.intersect_pallas import sphere_nearest_pallas_cols

    feats = JFeatures.from_scene(jscene)
    cols = [jnp.asarray(c) for c in (*ro.T, *rd.T)]
    if feats.has_spheres:
        t, idx = (np.asarray(x) for x in sphere_nearest_pallas_cols(
            jscene.spheres, *cols, jnp.zeros(ro.shape[0], jnp.float32),
            MIN_T, MAX_T, has_motion=False, cull=False))
    else:
        t = np.full(ro.shape[0], MAX_T, np.float32)
        idx = np.zeros(ro.shape[0], np.int32)
    kinds = []
    if feats.has_rects:
        kinds.append((jisect.rect_nearest_planes(jscene.rects, *cols), 128))
    if feats.has_boxes:
        kinds.append((jisect.box_nearest_planes(jscene.boxes, *cols),
                      jscene.boxes.count))
    if feats.has_media:
        n = jscene.media.count
        j_lane = jnp.asarray(np.asarray(lane).astype(np.uint32))
        med_u = jnp.stack([jfp.counter_uniform(j_lane, jnp.int32(seed),
                                               depth, 8 + j)
                           for j in range(n)], axis=-1)
        kinds.append((jisect.media_nearest_planes(jscene.media, *cols, med_u),
                      n))
    offset = ((jscene.spheres.center.shape[0] + 127) // 128) * 128
    for (t_k, i_k), n in kinds:
        t_k, i_k = np.asarray(t_k), np.asarray(i_k)
        wins = t_k < t
        t, idx = np.where(wins, t_k, t), np.where(wins, offset + i_k, idx)
        offset += n
    return t.astype(np.float32), idx.astype(np.int32)


def jax_fused_state(st):
    """The JAX package's ``FastStateP`` of the port's state ``st``."""
    import jax.numpy as jnp

    from pathtrace_tpu.ops import fastpath as jfp

    planes = st.planes.numpy()
    return jfp.FastStateP(*(jnp.asarray(p) for p in planes[:6]),
                          jnp.asarray(st.time.numpy()),
                          *(jnp.asarray(p) for p in planes[6:12]),
                          jnp.asarray(st.alive.numpy()),
                          jnp.asarray(st.lane.numpy().astype(np.uint32)))


@functools.lru_cache(maxsize=None)
def _jax_shade():
    import jax

    from pathtrace_tpu.ops.shade_pallas import shade_bounce_planes

    return jax.jit(shade_bounce_planes,
                   static_argnames=("features", "max_depth"))


def jax_shade_planes(jscene, table, t, idx, st, seed, depth, max_depth,
                     emit_scale=None):
    """``shade_bounce_planes`` on the port's state ``st`` and the winners
    (t, idx) in ``table`` (numpy): the 13 output planes (numpy). In an
    image scene the texels come from the reference's pre-pass
    ``_image_rgb_planes`` over its [3, N] atlas, as its fused bounce
    computes them."""
    import jax.numpy as jnp

    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops import fastpath as jfp

    jfeat = JFeatures.from_scene(jscene)
    planes = st.planes.numpy()
    R = t.shape[0]
    attrs3 = table[idx].reshape(R // 128, 128, -1).transpose(0, 2, 1)
    sp = {name: jnp.asarray(planes[k]) for k, name in enumerate(PLANE_NAMES)}
    sp.update(time=jnp.asarray(st.time.numpy()),
              alive=jnp.asarray(st.alive.numpy().astype(np.float32)),
              lane=jnp.asarray(st.lane.numpy()))
    img_planes = None
    if jfeat.has_image:
        img_planes = jfp._image_rgb_planes(
            jfp._atlas_planes(jscene), jnp.asarray(t),
            jnp.asarray(np.ascontiguousarray(attrs3)), jax_fused_state(st),
            jfeat)
    outs = _jax_shade()(
        jnp.asarray(t), jnp.asarray(np.ascontiguousarray(attrs3)), sp, seed,
        depth, jscene.sky, jscene.use_gradient_sky, features=jfeat,
        max_depth=max_depth, img_planes=img_planes,
        emit_scale=None if emit_scale is None else jnp.asarray(emit_scale))
    return [np.asarray(o) for o in outs]


def port_light_fixture_trace(ref, **kw):
    """The port's CPU ``trace_fast`` of the rays of a ``simple_light``
    fixture (``LIGHT_FIXTURE``)."""
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as tfp

    scene, _ = presets.simple_light(16 / 9)
    return tfp.trace_fast(scene, *(torch.from_numpy(ref[k]) for k in
                                   ("rays.ro", "rays.rd", "rays.time")),
                          int(ref["seed"]), int(ref["max_depth"]),
                          SceneFeatures.from_scene(scene), **kw)


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


@contextlib.contextmanager
def adaptive_picks(replay=None):
    """Within the block, ``np.argpartition`` keeps each call's pick (the
    last ``a.size - kth`` ids: a refinement round of ``render_adaptive``)
    in the yielded list and, given ``replay`` (one id array a round),
    returns call ``i``'s result with those ids put in place of its own, so
    a run replays another's choices. Only ``render_adaptive`` may call
    ``np.argpartition`` within the block."""
    real = np.argpartition
    own = []

    def hooked(a, kth, *args, **kw):
        res = real(a, kth, *args, **kw)
        own.append(res[kth:].copy())
        if replay is not None:
            res = res.copy()
            res[kth:] = replay[len(own) - 1]
        return res

    np.argpartition = hooked
    try:
        yield own
    finally:
        np.argpartition = real


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

# The same contract on ``smallpt``, held on the path state (ray origin and
# direction, radiance, throughput and liveness after ten bounces of each
# package's own closest hit and shade; tests/test_torch_sphere_presets.py),
# because its radiance is black on all but a few rays (a radius-1.5 light,
# a black sky): per-ray radiance puts 0 of the fixture's 4096 rays outside
# 1e-3 on the CPU. Its five walls are radius-1e3 spheres about 1e3 away,
# where the expanded quadratic cancels hardest: against JAX 0.29% of the
# path states leave 1e-3 after one bounce and 1.37% after ten; JAX against
# itself with the camera directions one ULP longer, 0.32% and 1.07%. Twice
# the port's reading.
SMALLPT_DEPTH10_BUDGET = 0.03


def port_bounce_chain(scene, ro, rd, tm, seed: int, max_depth: int):
    """The port's wavefront bounces without compaction: ``max_depth + 1``
    rounds of ``fastpath.closest_hit`` and ``shade_from_winners`` on every
    lane, dead ones included (a dead lane's planes stay as they were).
    Returns (planes [12, R], alive [R]) on the rays' device: K1 and K2 on
    the card, their plain versions on the CPU."""
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as tfp
    from pathtrace_tpu_torch.ops.shade_kernel import shade_from_winners

    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    flags = tfp.feature_flags(feats)
    st = tfp.make_state(ro, rd, tm)
    for depth in range(max_depth + 1):
        t, idx = tfp.closest_hit(tables, st, depth, feats, seed=seed)
        planes, alive = shade_from_winners(
            tables.table, idx, t, st.planes, st.time, st.alive, st.lane,
            seed, depth, max_depth, tables.sky4, flags, atlas=tables.atlas)
        st = tfp.FastStateP(planes[:12], st.time, alive, st.lane)
    return st.planes, st.alive


def white_sky(scene):
    """The port's ``scene`` under a constant white sky: a path that leaves
    the scene then returns its throughput, so per-ray radiance shows every
    bounce of a scene whose own sky is black (``smallpt``)."""
    import torch

    return dataclasses.replace(
        scene, sky=torch.ones_like(scene.sky),
        use_gradient_sky=torch.zeros_like(scene.use_gradient_sky))


def states_outside(planes, alive, ref_planes, ref_alive):
    """Lanes whose path state (the 12 planes, numpy [12, R]) leaves the
    reference's by more than 1e-3 in a plane, or whose liveness differs."""
    close = np.ones(ref_alive.shape[0], bool)
    for k in range(ref_planes.shape[0]):
        close &= lane_close(planes[k], ref_planes[k])
    return ~(close & (np.asarray(alive) == np.asarray(ref_alive)))


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


def check_smallpt_contract(radiance, ray_count, ref_radiance, ref_count,
                           max_depth):
    """``smallpt``'s slice contract: per-ray radiance as
    ``check_slice_contract`` holds it (``DEPTH10_BUDGET``), and the
    segment counts within ``max_depth`` segments per path that its own
    budget lets diverge (``SMALLPT_DEPTH10_BUDGET`` of the rays): its paths
    diverge unseen in the radiance, black on all but a few rays. Returns
    the fraction of rays outside."""
    close = lane_close(radiance, ref_radiance).all(axis=1)
    frac = float((~close).mean())
    assert frac <= DEPTH10_BUDGET, f"{frac:.4%} of rays beyond 1e-3"
    paths = SMALLPT_DEPTH10_BUDGET * close.size
    assert abs(int(ray_count) - int(ref_count)) <= paths * max_depth, (
        ray_count, ref_count)
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


# ---------------------------------------------------------------------------
# the -X trace's lines (tests/test_torch_drivers.py, chip_smoke.py)
# ---------------------------------------------------------------------------

_NUM = re.compile(r"-?\d+\.\d*(?:e[-+]?\d+)?|-?\d+")


def _split_line(line: str):
    """(the line with every number replaced by '#', its floats after
    ``t=``, its other floats, its integers)."""
    ts, floats, ints = [], [], []

    def sub(m):
        tok = m.group(0)
        if "." in tok or "e" in tok:
            is_t = line[max(m.start() - 2, 0):m.start()] == "t="
            (ts if is_t else floats).append(float(tok))
        else:
            ints.append(int(tok))
        return "#"

    shape = " ".join(_NUM.sub(sub, line).split())
    # numpy pads an array's columns to a common width
    shape = shape.replace("[ ", "[").replace(" ]", "]")
    return shape, ts, floats, ints


def assert_trace_lines_match(lines, ref_lines):
    """The ``-X`` contract: the same line structure (words and brackets),
    the same integers (indices, node ids, census counts, materials), every
    hit distance ``t=`` within rel 1e-5, and the other floats (origins,
    directions, points, normals) within 1e-4, relative and absolute: a
    direction one ULP off (the card's camera normalizes in another order)
    moves a grazing root's t by ~2e-6 relative through the expanded
    quadratic, and a point near the origin ``ro + t rd`` keeps only the
    digits that ``ro`` (~3 on ``small``) leaves it."""
    assert len(lines) == len(ref_lines), (lines, ref_lines)
    for a, b in zip(lines, ref_lines):
        sa, ta, fa, ia = _split_line(a)
        sb, tb, fb, ib = _split_line(b)
        assert sa == sb, (a, b)
        assert ia == ib, (a, b)
        np.testing.assert_allclose(ta, tb, rtol=1e-5, atol=0.0,
                                   err_msg=f"{a!r} vs {b!r}")
        np.testing.assert_allclose(fa, fb, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{a!r} vs {b!r}")


def many_boxes_and_media(n_boxes: int, n_media: int, seed: int = 0):
    """A scene of ``n_boxes`` rotated boxes and ``n_media`` media (every
    third a sphere, the others rotated slabs) over ``final_full``'s floor
    (x, z in [-100, 500], y in [0, 300]), the 5th of each masked: more than
    one shared-memory tile of the box and media kernel (480 boxes, 400
    media a tile) at the counts the card phases take."""
    from pathtrace_tpu_torch.models.build import (
        SceneBuilder, affine_from_axis_angle,
    )

    g = np.random.default_rng(seed)
    b = SceneBuilder()
    iso = b.constant_texture((0.7, 0.7, 0.7))
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    lo, hi = (-100.0, 0.0, -100.0), (500.0, 300.0, 500.0)
    for _ in range(n_boxes):
        p0 = g.uniform(lo, hi)
        xf = affine_from_axis_angle(g.normal(size=3), float(g.uniform(0, 90)),
                                    g.uniform(-20.0, 20.0, 3))
        b.box(tuple(p0), tuple(p0 + g.uniform(5.0, 40.0, 3)), mat, xf)
    for i in range(n_media):
        c = g.uniform(lo, hi)
        dens = float(g.uniform(1e-3, 5e-2))
        if i % 3 == 0:
            b.medium_sphere(tuple(c), float(g.uniform(10.0, 60.0)), dens, iso)
        else:
            xf = affine_from_axis_angle(g.normal(size=3),
                                        float(g.uniform(0.0, 90.0)),
                                        g.uniform(-20.0, 20.0, 3))
            b.medium_box(tuple(c - 30.0), tuple(c + 30.0), dens, iso, xf)
    scene = b.finish()
    if n_boxes > 4:
        scene.boxes.mask[4] = False
    if n_media > 4:
        scene.media.mask[4] = False
    return scene


@contextlib.contextmanager
def plain_box_media_and_turb():
    """Within the block the fast and general paths sweep boxes and media
    through the plain [R, N] forms (under autograd: t a gather at the
    argmin) and take the plain masked turbulence, on any device: the
    route before their kernels, for comparisons on the card."""
    from pathtrace_tpu_torch.config import MAX_T, MIN_T
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect as isect
    from pathtrace_tpu_torch.ops import intersect_box as ib
    from pathtrace_tpu_torch.ops import turb_kernel

    def nearest(op, rays, uniforms=None, t_min=MIN_T, t_max=MAX_T):
        box = (ib.box_nearest_rn(op.boxes, *rays, t_min=t_min, t_max=t_max)
               if op.boxes is not None else None)
        med = (ib.media_nearest_rn(op.media, *rays, uniforms, t_min=t_min,
                                   t_max=t_max)
               if op.media is not None else None)
        return box, med

    def hits(op, ro, rd, uniforms=None, t_min=MIN_T, t_max=MAX_T):
        return nearest(op, (*ro.unbind(1), *rd.unbind(1)), uniforms, t_min,
                       t_max)

    saved = (fp.box_media_nearest, fp.box_media_hits, fp.noise_turb,
             isect.box_media_hits)
    fp.box_media_nearest, fp.box_media_hits = nearest, hits
    fp.noise_turb, isect.box_media_hits = turb_kernel.turb_plain, hits
    try:
        yield
    finally:
        (fp.box_media_nearest, fp.box_media_hits, fp.noise_turb,
         isect.box_media_hits) = saved


def marble_smoke_scene(aspect: float = 1.0):
    """``cornell_smoke``'s room with a marble (noise-textured) box in place
    of the first smoke box, the second a grey fog, and a smoke sphere:
    the hit points on boxes and in media move the marble's colour, so a
    differentiable trace gives the box and media leaves a gradient through
    their t (constant albedos give none)."""
    import numpy as _np

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.build import SceneBuilder

    b = SceneBuilder(perlin_rng=_np.random.default_rng(0))
    presets._cornell_walls(b, (7.0, 7.0, 7.0),
                           (113.0, 443.0, 127.0, 432.0, 554.0))
    b.box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0),
          b.lambertian(b.noise_texture(0.05)), presets._box1_xform())
    b.medium_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), 0.02,
                 b.constant_texture((0.6, 0.6, 0.6)), presets._box2_xform())
    b.medium_sphere((380.0, 330.0, 200.0), 90.0, 0.05,
                    b.constant_texture((0.9, 0.9, 0.9)))
    b.sky = (0.4, 0.4, 0.4)  # paths out of the open side carry light too
    return b.finish(), presets._cornell_camera(aspect)


def diff_box_media_grads(device, size: int = 32):
    """(radiance [R, 3], {leaf: gradient}) of ``trace_fast_diff`` (depth
    4, one sample a pixel of a ``size`` square film) of
    :func:`marble_smoke_scene` on ``device``, for a fixed weighting of
    the radiance, with respect to the boxes' and media's geometry and
    the media's density."""
    import torch

    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.parallel.inverse import split_scene
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    scene, cam = marble_smoke_scene()
    scene = scene.to(device)
    feats = SceneFeatures.from_scene(scene)
    ro, rd, tm = generate_primary_rays(cam, size, size, 1, PRNGKey(3),
                                       device=device)
    rays = (ro.reshape(-1, 3), rd.reshape(-1, 3), tm.reshape(-1))
    w = torch.rand((rays[0].shape[0], 3), device=device,
                   generator=torch.Generator(device=device).manual_seed(1))
    params, rebuild, names = split_scene(
        scene, lambda p: p.startswith(("boxes.", "media."))
        and p.endswith(("p0", "p1", "obj_from_world", "density")))
    rad, _ = fp.trace_fast_diff(rebuild(params), *rays, 7, 4, feats)
    grads = torch.autograd.grad((w * rad).sum(), params)
    return rad.detach(), dict(zip(names, grads))
