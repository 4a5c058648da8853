"""Preset scenes of the slice (counterpart of
``pathtrace_tpu/models/presets.py``): ``random_spheres`` (the Shirley cover
scene, static spheres), ``small`` and ``two_perlin_spheres`` (the CLI
default). Each builds its scene with the same numpy generator calls as the
JAX preset, so both packages produce identical leaves."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from pathtrace_tpu_torch.camera import Camera, make_camera
from pathtrace_tpu_torch.models.build import SceneBuilder
from pathtrace_tpu_torch.models.types import Scene

# presets of the JAX package whose scene classes this slice cannot render
NOT_PORTED = ("aras", "cornell", "cornell_smoke", "earth", "final",
              "final_full", "random", "random_spheres_xl", "simple_light",
              "smallpt")


def _standard_camera(aspect: float, time1: float = 1.0,
                     aperture: float = 0.1) -> Camera:
    return make_camera(
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0), vfov_degrees=20.0, aspect=aspect,
        aperture=aperture, focus_dist=10.0, time0=0.0, time1=time1,
    )


def random_spheres(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Shirley cover scene with static spheres: 488 spheres padded to 512."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    checker = b.checker_texture(
        b.constant_texture((0.2, 0.3, 0.1)), b.constant_texture((0.9, 0.9, 0.9))
    )
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(checker))
    for a in range(-11, 11):
        for c in range(-11, 11):
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
                # the moving-sphere variant's end point: drawn (and unused)
                # so the generator stays in step with the JAX preset
                rng.random()
                b.sphere(centre, 0.2, b.lambertian_color(albedo))
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


def small(aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """5-sphere scene with a hollow glass shell."""
    b = SceneBuilder()
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
    b = SceneBuilder()
    noise = b.noise_texture(4.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(noise))
    b.sphere((0.0, 2.0, 0.0), 2.0, b.lambertian(noise))
    return b.finish(), _standard_camera(aspect, time1=0.0, aperture=0.0)


_REGISTRY: Dict[str, Callable[..., Tuple[Scene, Camera]]] = {
    "random_spheres": random_spheres,
    "small": small,
    "two_perlin_spheres": two_perlin_spheres,
}


def names():
    return sorted(_REGISTRY)


def from_name(name: str, aspect: float, seed: int = 0) -> Tuple[Scene, Camera]:
    """Preset lookup; raises ``ValueError`` for presets this port cannot
    render yet and for unknown names."""
    fn = _REGISTRY.get(name)
    if fn is not None:
        return fn(aspect, seed=seed)
    if name in NOT_PORTED:
        raise ValueError(
            f"preset '{name}' is not ported yet (this port renders: "
            f"{', '.join(names())})"
        )
    raise ValueError(f"unrecognised preset '{name}'")
