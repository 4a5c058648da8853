"""The cover scene of *Ray Tracing in One Weekend*, in the variant with a
checker ground: a ``2 * half_extent`` square grid of small spheres (80%
diffuse, 15% metal, 5% glass) around three large ones, seen by the book's
camera. Built from the run's seed through the renderer's ``SceneBuilder``
and ``make_camera``, with the draws of the renderer's ``random_spheres``
preset, so seed 0 gives that preset."""

from __future__ import annotations

import numpy as np


def build(cfg: dict, seed: int):
    from pathtrace_tpu_torch import SceneBuilder, make_camera

    sc, film, cam = cfg["scene"], cfg["film"], cfg["camera"]
    rng = np.random.default_rng(seed)
    b = SceneBuilder(perlin_rng=np.random.default_rng(seed))
    odd, even = sc["checker"]
    checker = b.checker_texture(b.constant_texture(odd),
                                b.constant_texture(even))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(checker))
    half = sc["half_extent"]
    for a in range(-half, half):
        for c in range(-half, half):
            choose = rng.random()
            centre = np.array([a + 0.9 * rng.random(), 0.2,
                               c + 0.9 * rng.random()], np.float32)
            if choose < 0.8:
                albedo = tuple(rng.random() * rng.random() for _ in range(3))
                rng.random()  # the moving variant's end point
                b.sphere(centre, 0.2, b.lambertian_color(albedo))
            elif choose < 0.95:
                albedo = tuple(0.5 * (1.0 + rng.random()) for _ in range(3))
                b.sphere(centre, 0.2, b.metal(albedo, 0.5 * rng.random()))
            else:
                b.sphere(centre, 0.2, b.dielectric(1.5))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian_color((0.4, 0.2, 0.1)))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    scene = b.finish(pad_multiple=128, spatial_sort=True)
    camera = make_camera(
        lookfrom=cam["lookfrom"], lookat=cam["lookat"], vup=(0.0, 1.0, 0.0),
        vfov_degrees=cam["vfov"], aspect=film["width"] / film["height"],
        aperture=cam["aperture"], focus_dist=cam["focus_dist"],
        time0=0.0, time1=cam["time1"])
    return scene, camera
