"""Preset scenes of the slice (counterpart of
``pathtrace_tpu/models/presets.py``): ``random`` (the Shirley "Next Week"
cover scene, whose small diffuse spheres move over the shutter),
``random_spheres`` (the same scene with static spheres), its 64x64-grid
variant ``random_spheres_xl``, ``small``, ``two_perlin_spheres`` (the CLI
default), ``simple_light`` (an emissive sphere and rect over marble),
``cornell`` (six rects, a rect light and two rotated boxes),
``cornell_smoke`` (the same walls and two rotated media boxes), ``earth``
(an image-textured globe), ``smallpt`` (smallpt's sphere-walled Cornell
box), ``aras`` (Aras Pranckevicius's 46-sphere ToyPathTracer scene),
``final`` (the reference's empty-world stub) and ``final_full`` (the
completed "Next Week" final scene, which the general integrator renders).
Each builds its scene, its Perlin tables included, with the same numpy
generator calls as the JAX preset, so both packages produce identical
leaves. :func:`image_light_scene` is no preset but a test and bench scene:
``simple_light`` with image textures."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from pathtrace_tpu_torch.camera import Camera, make_camera
from pathtrace_tpu_torch.models.build import (
    SceneBuilder,
    affine_from_rotation_y_translation,
)
from pathtrace_tpu_torch.models.types import Scene

# presets of the JAX package whose scene classes this port cannot render
NOT_PORTED = ()


def _standard_camera(aspect: float, time1: float = 1.0,
                     aperture: float = 0.1) -> Camera:
    return make_camera(
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0), vfov_degrees=20.0, aspect=aspect,
        aperture=aperture, focus_dist=10.0, time0=0.0, time1=time1,
    )


def _random_impl(aspect: float, only_spheres: bool, seed: int,
                 half_extent: int = 11) -> Tuple[Scene, Camera]:
    """Shirley cover scene on a ``2 * half_extent`` square grid of small
    spheres (11: the reference's 22x22, 488 spheres; 32: the 64x64
    scene-scale variant, 4100 spheres). ``only_spheres=False`` is the
    motion-blurred ``random`` preset: each diffuse sphere moves up by
    ``0.5 * u`` over the shutter [0, 1]."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    checker = b.checker_texture(
        b.constant_texture((0.2, 0.3, 0.1)), b.constant_texture((0.9, 0.9, 0.9))
    )
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(checker))
    for a in range(-half_extent, half_extent):
        for c in range(-half_extent, half_extent):
            choose = rng.random()
            centre = np.array(
                [a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()], np.float32
            )
            if choose < 0.8:
                albedo = (
                    rng.random() * rng.random(),
                    rng.random() * rng.random(),
                    rng.random() * rng.random(),
                )
                # the end point is drawn in both variants, so the
                # generator stays in step with the JAX preset
                centre1 = centre + np.array([0.0, 0.5 * rng.random(), 0.0],
                                            np.float32)
                if only_spheres:
                    b.sphere(centre, 0.2, b.lambertian_color(albedo))
                else:
                    b.moving_sphere(centre, centre1, 0.0, 1.0, 0.2,
                                    b.lambertian_color(albedo))
            elif choose < 0.95:
                albedo = (
                    0.5 * (1.0 + rng.random()),
                    0.5 * (1.0 + rng.random()),
                    0.5 * (1.0 + rng.random()),
                )
                b.sphere(centre, 0.2, b.metal(albedo, 0.5 * rng.random()))
            else:
                b.sphere(centre, 0.2, b.dielectric(1.5))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian_color((0.4, 0.2, 0.1)))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    return b.finish(pad_multiple=128, spatial_sort=True), _standard_camera(aspect)


def random(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Cover scene with motion-blurred diffuse spheres: 488 spheres (391
    of them moving) padded to 512."""
    return _random_impl(aspect, only_spheres=False, seed=seed)


def random_spheres(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Shirley cover scene with static spheres: 488 spheres padded to 512."""
    return _random_impl(aspect, only_spheres=True, seed=seed)


def random_spheres_xl(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """The cover scene on a 64x64 grid: 4100 static spheres padded to 4224
    (33 tiles of 128), the scene-scale preset of the tile-culled path."""
    return _random_impl(aspect, only_spheres=True, seed=seed, half_extent=32)


def small(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """5-sphere scene with a hollow glass shell."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((0.1, 0.2, 0.5)))
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian_color((0.8, 0.8, 0.0)))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.0))
    b.sphere((-1.0, 0.0, -1.0), 0.5, b.dielectric(1.5))
    b.sphere((-1.0, 0.0, -1.0), -0.45, b.dielectric(1.5))
    lookfrom = np.array([3.0, 3.0, 2.0])
    lookat = np.array([0.0, 0.0, -1.0])
    cam = make_camera(
        lookfrom, lookat, (0.0, 1.0, 0.0), 20.0, aspect,
        aperture=0.1, focus_dist=float(np.linalg.norm(lookfrom - lookat)),
        time0=0.0, time1=1.0,
    )
    return b.finish(), cam


def two_perlin_spheres(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Default preset: marble ground and marble sphere."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    noise = b.noise_texture(4.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(noise))
    b.sphere((0.0, 2.0, 0.0), 2.0, b.lambertian(noise))
    return b.finish(), _standard_camera(aspect, time1=0.0, aperture=0.0)


def simple_light(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Emissive sphere and rect over marble, black sky."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    noise = b.noise_texture(4.0)
    light_tex = b.constant_texture((4.0, 4.0, 4.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(noise))
    b.sphere((0.0, 2.0, 0.0), 2.0, b.lambertian(noise))
    b.sphere((0.0, 7.0, 0.0), 2.0, b.diffuse_light(light_tex))
    b.rect_xy(3.0, 5.0, 1.0, 3.0, -2.0, False, b.diffuse_light(light_tex))
    b.sky = (0.0, 0.0, 0.0)
    cam = make_camera(
        (50.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0, aspect,
        aperture=0.0, focus_dist=10.0, time0=0.0, time1=0.0,
    )
    return b.finish(), cam


def _cornell_camera(aspect: float) -> Camera:
    return make_camera(
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0), 40.0,
        aspect, aperture=0.0, focus_dist=10.0, time0=0.0, time1=1.0,
    )


def _cornell_walls(b: SceneBuilder, light_color, light_rect) -> None:
    red = b.lambertian_color((0.65, 0.05, 0.05))
    white = b.lambertian_color((0.73, 0.73, 0.73))
    green = b.lambertian_color((0.12, 0.45, 0.15))
    light = b.diffuse_light_color(light_color)
    b.rect_yz(0.0, 555.0, 0.0, 555.0, 555.0, True, green)
    b.rect_yz(0.0, 555.0, 0.0, 555.0, 0.0, False, red)
    b.rect_xz(*light_rect, False, light)
    b.rect_xz(0.0, 555.0, 0.0, 555.0, 555.0, True, white)
    b.rect_xz(0.0, 555.0, 0.0, 555.0, 0.0, False, white)
    b.rect_xy(0.0, 555.0, 0.0, 555.0, 555.0, True, white)


def _box1_xform():
    return affine_from_rotation_y_translation(-18.0, (130.0, 0.0, 65.0))


def _box2_xform():
    return affine_from_rotation_y_translation(15.0, (265.0, 0.0, 295.0))


def cornell(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Cornell box: six walls (one a rect light) and two rotated white
    boxes, black sky."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    _cornell_walls(b, (15.0, 15.0, 15.0), (213.0, 343.0, 227.0, 332.0, 554.0))
    white = b.lambertian_color((0.73, 0.73, 0.73))
    b.box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), white, _box1_xform())
    b.box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white, _box2_xform())
    b.sky = (0.0, 0.0, 0.0)
    return b.finish(), _cornell_camera(aspect)


def cornell_smoke(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Cornell box with two rotated media boxes of density 0.01 (white
    smoke and black fog) under a larger, dimmer light."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    _cornell_walls(b, (7.0, 7.0, 7.0), (113.0, 443.0, 127.0, 432.0, 554.0))
    b.medium_box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), 0.01,
                 b.constant_texture((1.0, 1.0, 1.0)), _box1_xform())
    b.medium_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), 0.01,
                 b.constant_texture((0.0, 0.0, 0.0)), _box2_xform())
    b.sky = (0.0, 0.0, 0.0)
    return b.finish(), _cornell_camera(aspect)


def _procedural_earth_image(size: int = 256, seed: int = 7) -> np.ndarray:
    """The stand-in for the reference's ``media/earthmap.jpg`` (a file its
    repository does not ship): a [size, 2 size, 3] continent-like map from
    four octaves of bilinear value noise, bit for bit the JAX package's."""
    rng = np.random.default_rng(seed)
    h, w = size, size * 2
    acc = np.zeros((h, w), np.float32)
    for octave in range(4):
        n = 2 ** (octave + 2)
        coarse = rng.random((n, n + n)).astype(np.float32)
        yy = np.linspace(0, n - 1, h, dtype=np.float32)
        xx = np.linspace(0, 2 * n - 1, w, dtype=np.float32)
        y0 = np.floor(yy).astype(int)
        x0 = np.floor(xx).astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        y1 = np.minimum(y0 + 1, n - 1)
        x1 = np.minimum(x0 + 1, 2 * n - 1)
        v = (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
            + coarse[np.ix_(y1, x1)] * fy * fx
        )
        acc += v * (0.5 ** octave)
    acc /= acc.max()
    land = acc > 0.55
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = np.where(land, 0.35 + 0.3 * acc, 0.05)
    img[..., 1] = np.where(land, 0.45 + 0.3 * acc, 0.15 + 0.2 * acc)
    img[..., 2] = np.where(land, 0.25, 0.45 + 0.3 * acc)
    return img


def earth(aspect: float, seed: int = 0,
          image_path: Optional[str] = None) -> Tuple[Scene, Camera]:
    """An image-textured globe of radius 2 at the origin. ``image_path``:
    a PNG or JPEG map; by default the procedural stand-in."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    tex = b.image_texture(image_path if image_path
                          else _procedural_earth_image())
    b.sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(tex))
    return b.finish(), _standard_camera(aspect, time1=0.0, aperture=0.0)


def smallpt(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """smallpt's Cornell box of spheres: five radius-1e3 walls, a mirror
    ball, a glass ball and a small bright light (400 W/sr, radius 1.5),
    black sky."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    b.sphere((1e3 + 1.0, 40.8, 81.6), 1e3, b.lambertian_color((0.75, 0.25, 0.25)))
    b.sphere((-1e3 + 99.0, 40.8, 81.6), 1e3, b.lambertian_color((0.25, 0.25, 0.75)))
    b.sphere((50.0, 40.8, 1e3), 1e3, b.lambertian_color((0.75, 0.75, 0.75)))
    b.sphere((50.0, 1e3, 81.6), 1e3, b.lambertian_color((0.75, 0.75, 0.75)))
    b.sphere((50.0, -1e3 + 81.6, 81.6), 1e3, b.lambertian_color((0.75, 0.75, 0.75)))
    b.sphere((27.0, 16.5, 47.0), 16.5, b.metal((0.999, 0.999, 0.999), 0.0))
    b.sphere((73.0, 16.5, 78.0), 16.5, b.dielectric(1.5))
    b.sphere((50.0, 81.6 - 16.5, 81.6), 1.5,
             b.diffuse_light_color((400.0, 400.0, 400.0)))
    b.sky = (0.0, 0.0, 0.0)
    cam = make_camera(
        (50.0, 52.0, 295.6), (50.0, 33.0, 0.0), (0.0, 1.0, 0.0), 30.0, aspect,
        aperture=0.05, focus_dist=100.0, time0=0.0, time1=1.0,
    )
    return b.finish(), cam


def final(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """The reference's 'final' stub: an empty world (the builder pads it to
    one dead sphere) under the gradient sky, seen by the standard camera."""
    return (SceneBuilder(perlin_rng=np.random.default_rng(seed)).finish(),
            _standard_camera(aspect))


def final_full(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """The completed "Next Week" final scene: a 20x20 field of ground
    boxes of random height, a rect light, a moving sphere, glass and fuzzy
    metal spheres, a glass ball around a dense blue medium, a whole-scene
    haze (a radius-5000 medium), the image-textured earth, a marble ball
    and 1000 small white spheres rotated 15 degrees about y (baked into
    their centres), black sky. The fast path refuses it (an image texture
    in a scene with boxes and media); ``auto`` routes it to the general
    integrator."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    ground = b.lambertian_color((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = 1.0 + 100.0 * rng.random()
            b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)
    b.rect_xz(123.0, 423.0, 147.0, 412.0, 554.0, False,
              b.diffuse_light_color((7.0, 7.0, 7.0)))
    c0 = np.array([400.0, 400.0, 200.0], np.float32)
    b.moving_sphere(c0, c0 + np.array([30.0, 0.0, 0.0], np.float32),
                    0.0, 1.0, 50.0, b.lambertian_color((0.7, 0.3, 0.1)))
    b.sphere((260.0, 150.0, 45.0), 50.0, b.dielectric(1.5))
    b.sphere((0.0, 150.0, 145.0), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))
    # the subsurface ball: a glass boundary around a dense blue medium
    b.sphere((360.0, 150.0, 145.0), 70.0, b.dielectric(1.5))
    b.medium_sphere((360.0, 150.0, 145.0), 70.0, 0.2,
                    b.constant_texture((0.2, 0.4, 0.9)))
    b.medium_sphere((0.0, 0.0, 0.0), 5000.0, 1e-4,
                    b.constant_texture((1.0, 1.0, 1.0)))
    b.sphere((400.0, 200.0, 400.0), 100.0,
             b.lambertian(b.image_texture(_procedural_earth_image())))
    b.sphere((220.0, 280.0, 300.0), 80.0,
             b.lambertian(b.noise_texture(0.1)))
    white = b.lambertian_color((0.73, 0.73, 0.73))
    pts = rng.random((1000, 3)).astype(np.float32) * 165.0
    th = np.deg2rad(15.0)
    rot = np.array([[np.cos(th), 0.0, np.sin(th)],
                    [0.0, 1.0, 0.0],
                    [-np.sin(th), 0.0, np.cos(th)]], np.float32)
    pts = pts @ rot.T + np.array([-100.0, 270.0, 395.0], np.float32)
    for p in pts:
        b.sphere(p, 10.0, white)
    b.sky = (0.0, 0.0, 0.0)
    cam = make_camera(
        (478.0, 278.0, -600.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0), 40.0,
        aspect, aperture=0.0, focus_dist=10.0, time0=0.0, time1=1.0,
    )
    return b.finish(pad_multiple=128, spatial_sort=True), cam


def aras(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Aras Pranckevicius's ToyPathTracer scene: 46 spheres (a big gray
    ground ball, a mixed foreground group, a glass ball, two emissives and
    four 9-sphere rows of gray and coloured Lambertian and mirror metal),
    gradient sky."""
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian_color((0.8, 0.8, 0.8)))
    b.sphere((2.0, 0.0, -1.0), 0.5, b.lambertian_color((0.8, 0.4, 0.4)))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((0.4, 0.8, 0.4)))
    b.sphere((-2.0, 0.0, -1.0), 0.5, b.metal((0.4, 0.4, 0.8), 0.0))
    b.sphere((2.0, 0.0, 1.0), 0.5, b.metal((0.4, 0.8, 0.4), 0.0))
    b.sphere((0.0, 0.0, 1.0), 0.5, b.metal((0.4, 0.8, 0.4), 0.2))
    b.sphere((-2.0, 0.0, 1.0), 0.5, b.metal((0.4, 0.8, 0.4), 0.6))
    b.sphere((0.5, 1.0, 0.5), 0.5, b.dielectric(1.5))
    b.sphere((-1.5, 1.5, 0.0), 0.3, b.diffuse_light_color((30.0, 25.0, 15.0)))

    # four 9-sphere rows, x = 4..-4 at z = -3/-4/-5/-6
    grays = [(0.1 * g,) * 3 for g in range(1, 10)]
    hues = [(0.8, 0.1, 0.1), (0.8, 0.5, 0.1), (0.8, 0.8, 0.1),
            (0.4, 0.8, 0.1), (0.1, 0.8, 0.1), (0.1, 0.8, 0.5),
            (0.1, 0.8, 0.8), (0.1, 0.1, 0.8), (0.5, 0.1, 0.8)]
    for i, x in enumerate(range(4, -5, -1)):
        b.sphere((x, 0.0, -3.0), 0.5, b.lambertian_color(grays[i]))
        b.sphere((x, 0.0, -4.0), 0.5, b.metal(grays[i], 0.0))
        b.sphere((x, 0.0, -5.0), 0.5, b.metal(hues[i], 0.0))
        # the z = -6 row is Lambertian except its last (x = -4) sphere
        mat = (b.metal(hues[i], 0.0) if x == -4
               else b.lambertian_color(hues[i]))
        b.sphere((x, 0.0, -6.0), 0.5, mat)

    b.sphere((1.5, 1.5, -2.0), 0.3, b.diffuse_light_color((3.0, 10.0, 20.0)))
    cam = make_camera(
        (0.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0,
        aspect, aperture=0.02, focus_dist=3.0, time0=0.0, time1=1.0,
    )
    return b.finish(), cam


def wall_image() -> np.ndarray:
    """A 40 x 72 texture of random texels (numpy, seed 3): the second
    image of :func:`image_light_scene`, so neighbouring texels differ and
    a texel picked wrongly shows in the albedo."""
    return np.random.default_rng(3).random((40, 72, 3), dtype=np.float32)


def image_light_scene(build, earth_image: np.ndarray,
                      textured_light: bool = False, box: bool = False):
    """``simple_light``'s geometry with image textures (a test and bench
    scene, not a preset; ``simple_light``'s camera sees it): the big
    sphere wears ``earth_image`` (:func:`_procedural_earth_image`, or the
    reference package's, which is the same) instead of the marble, and two
    walls wear :func:`wall_image`, the atlas's second image: a yz rect
    behind the spheres as the camera sees them (the camera looks down -x)
    and an xy rect beside them, seen at a grazing angle and by scattered
    rays. The marble ground, the emissive sphere and rect and the black
    sky stay. ``build`` is a build module: this package's
    (``pathtrace_tpu_torch.models.build``) or one with the same
    ``SceneBuilder`` (the reference package's builds identical leaves).
    ``textured_light``: both lights wear the marble noise instead of a
    constant (next-event estimation then evaluates their texture);
    ``box``: a grey box beside the globe (an image texture in a box
    scene: the fast path's non-fused bounce)."""
    b = build.SceneBuilder()
    noise = b.noise_texture(4.0)
    light_tex = (b.noise_texture(4.0) if textured_light
                 else b.constant_texture((4.0, 4.0, 4.0)))
    earth = b.lambertian(b.image_texture(earth_image))
    wall = b.lambertian(b.image_texture(wall_image()))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(noise))
    b.sphere((0.0, 2.0, 0.0), 2.0, earth)
    b.sphere((0.0, 7.0, 0.0), 2.0, b.diffuse_light(light_tex))
    b.rect_xy(3.0, 5.0, 1.0, 3.0, -2.0, False, b.diffuse_light(light_tex))
    b.rect_yz(0.0, 8.0, -7.0, 7.0, -6.0, False, wall)
    b.rect_xy(-6.0, 6.0, 0.0, 8.0, -7.0, False, wall)
    if box:
        b.box((-1.0, 0.0, 2.5), (0.5, 1.5, 4.0),
              b.lambertian_color((0.6, 0.6, 0.6)))
    b.sky = (0.0, 0.0, 0.0)
    return b.finish()


_REGISTRY: Dict[str, Callable[..., Tuple[Scene, Camera]]] = {
    "aras": aras,
    "cornell": cornell,
    "cornell_smoke": cornell_smoke,
    "earth": earth,
    "final": final,
    "final_full": final_full,
    "random": random,
    "random_spheres": random_spheres,
    "random_spheres_xl": random_spheres_xl,
    "simple_light": simple_light,
    "small": small,
    "smallpt": smallpt,
    "two_perlin_spheres": two_perlin_spheres,
}


def names():
    return sorted(_REGISTRY)


def from_name(name: str, aspect: float, seed: int = 0,
              image_path: Optional[str] = None) -> Tuple[Scene, Camera]:
    """Preset lookup; raises ``ValueError`` for presets this port cannot
    render yet and for unknown names. ``image_path`` feeds the presets
    with an image texture (``earth``); the others ignore it, as the
    reference's do."""
    fn = _REGISTRY.get(name)
    if fn is not None:
        if name == "earth" and image_path:
            return fn(aspect, seed=seed, image_path=image_path)
        return fn(aspect, seed=seed)
    if name in NOT_PORTED:
        raise ValueError(
            f"preset '{name}' is not ported yet (this port renders: "
            f"{', '.join(names())})"
        )
    raise ValueError(f"unrecognised preset '{name}'")
