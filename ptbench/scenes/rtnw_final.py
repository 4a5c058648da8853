"""The final scene of *Ray Tracing: The Next Week* (v3, section 10): a
field of ground boxes of random height, a rect light, a moving sphere,
glass and fuzzy metal balls, a glass ball around a dense blue medium, a
global haze, an image-textured earth, a marble ball and a cluster of small
white spheres rotated about y, under a black sky. Built from the run's
seed through the renderer's ``SceneBuilder`` and ``make_camera``, with
the draws of the renderer's ``final_full`` preset, so seed 0 gives that
preset. The earth's map is the procedural stand-in of ``earth_map``."""

from __future__ import annotations

import numpy as np


def earth_map(size: int, seed: int) -> np.ndarray:
    """A [size, 2 size, 3] continent-like map from four octaves of bilinear
    value noise: the stand-in for the book's ``earthmap.jpg``."""
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
        v = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
             + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
             + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
             + coarse[np.ix_(y1, x1)] * fy * fx)
        acc += v * (0.5 ** octave)
    acc /= acc.max()
    land = acc > 0.55
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = np.where(land, 0.35 + 0.3 * acc, 0.05)
    img[..., 1] = np.where(land, 0.45 + 0.3 * acc, 0.15 + 0.2 * acc)
    img[..., 2] = np.where(land, 0.25, 0.45 + 0.3 * acc)
    return img


def build(cfg: dict, seed: int):
    from pathtrace_tpu_torch import SceneBuilder, make_camera

    sc, film, cam = cfg["scene"], cfg["film"], cfg["camera"]
    rng = np.random.default_rng(seed)
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    ground = b.lambertian_color((0.48, 0.83, 0.53))
    n, w = sc["ground_boxes_per_side"], 100.0
    for i in range(n):
        for j in range(n):
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
    b.sphere((360.0, 150.0, 145.0), 70.0, b.dielectric(1.5))
    b.medium_sphere((360.0, 150.0, 145.0), 70.0, 0.2,
                    b.constant_texture((0.2, 0.4, 0.9)))
    b.medium_sphere((0.0, 0.0, 0.0), 5000.0, 1e-4,
                    b.constant_texture((1.0, 1.0, 1.0)))
    b.sphere((400.0, 200.0, 400.0), 100.0,
             b.lambertian(b.image_texture(earth_map(sc["earth_map_size"],
                                                    sc["earth_map_seed"]))))
    b.sphere((220.0, 280.0, 300.0), 80.0, b.lambertian(b.noise_texture(0.1)))
    white = b.lambertian_color((0.73, 0.73, 0.73))
    pts = rng.random((sc["cluster_spheres"], 3)).astype(np.float32) * 165.0
    th = np.deg2rad(15.0)
    rot = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                    [-np.sin(th), 0.0, np.cos(th)]], np.float32)
    pts = pts @ rot.T + np.array([-100.0, 270.0, 395.0], np.float32)
    for p in pts:
        b.sphere(p, 10.0, white)
    b.sky = (0.0, 0.0, 0.0)
    scene = b.finish(pad_multiple=128, spatial_sort=True)
    camera = make_camera(
        cam["lookfrom"], cam["lookat"], (0.0, 1.0, 0.0), cam["vfov"],
        film["width"] / film["height"], aperture=cam["aperture"],
        focus_dist=cam["focus_dist"], time0=0.0, time1=cam["time1"])
    return scene, camera
