"""Gradients of the port's general path against JAX's and against finite
differences, and the camera's ``vfov`` gradient.

Twins of tests/test_grad.py (``TestCameraGrad``, ``TestAlbedoGrad``,
``TestGeometryGrad``, ``TestMaterialGrad.test_metal_fuzz``) on the port's
``render_frame(..., differentiable=True)``: the general integrator's
``trace_diff`` under autograd, the spheres through ``SphereNearest``
(K6's plain version here). Common random numbers: the same Threefry key
drives the autodiff pass and both finite-difference renders, so the
estimator is a deterministic function of the parameter.

Each gradient is held twice:

* to ``jax.grad`` of the reference's loss at the same key and point, at
  rel 1e-3. The JAX values are the fixture
  ``tests/goldens/torch_port_camera_grads.npz``, which
  ``PYTHONPATH=. python tests/test_torch_camera_grad.py`` writes from
  tests/test_grad.py's ``render_loss`` on the CPU;
* to central differences at the reference's step and ``rel``, with an
  ``abs`` of 1e-7, far below the smallest gradient here (9.8e-6 for
  ``vfov``), and with the sign asserted. The loss is accumulated in
  float64: a float32 mean carries rounding noise of a few 1e-6 into a
  difference quotient, as large as the camera's gradients themselves.

The camera takes its half-height from libm's ``tanf`` (XLA's float32
``tan`` on the CPU, so the basis equals the reference's bit for bit)
through an autograd function whose backward is ``1 + tan^2``: a ``vfov``
tensor that requires a gradient gives ``horizontal`` and ``vertical``
one.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch import camera as tcam  # noqa: E402
from pathtrace_tpu_torch.camera import make_camera  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.render.frame import render_frame  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_camera_grads.npz")
CAM = ((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 40.0, 1.0, 0.0, 3.0)
FD_ABS = 1e-7

# name: (Threefry seed, point, finite-difference step), tests/test_grad.py's
CASES = {
    "lookfrom_z": (5, 3.0, 1e-3),
    "vfov": (6, 40.0, 1e-2),
    "defocus_aperture": (7, 0.4, 1e-3),
    "albedo": (0, 0.4, 1e-2),
    "emission": (0, 2.0, 1e-2),
    "sphere_center_z": (1, -4.0, 1e-3),
    "sphere_radius": (2, 4.0, 1e-3),
    "metal_fuzz": (3, 0.3, 1e-3),
}


def fd_grad(f, x0: float, h: float) -> float:
    with torch.no_grad():
        return (float(f(torch.tensor(x0 + h))) - float(f(torch.tensor(x0 - h)))) / (2.0 * h)


def auto_grad(f, x0: float) -> float:
    x = torch.tensor(x0, requires_grad=True)
    (g,) = torch.autograd.grad(f(x), x)
    return float(g)


def render(scene, cam, key, w=24, h=24, spp=4, depth=3):
    img, _ = render_frame(scene, cam, w, h, spp, depth, key,
                          differentiable=True,
                          features=SceneFeatures.from_scene(scene))
    return img.double()


def render_loss(scene, cam_args, key):
    return render(scene, make_camera(*cam_args), key).mean()


def full_view_sphere_scene(albedo=(0.4, 0.5, 0.6)):
    """A big sphere filling the whole frame: no silhouette in view."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -4.0), 4.0, b.lambertian_color(albedo))
    return b.finish()


def _one_sphere(material_of):
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -4.0), 4.0, material_of(b))
    return b


def _with(scene, group: str, leaf: str, index, value):
    """``scene`` with one element of a leaf replaced by ``value`` (a
    tensor, whose graph the new leaf keeps)."""
    obj = getattr(scene, group)
    arr = getattr(obj, leaf).clone()
    arr[index] = value
    return dataclasses.replace(scene, **{
        group: dataclasses.replace(obj, **{leaf: arr})})


def loss_of(name: str):
    """The port's loss of case ``name`` as a function of its parameter."""
    key = PRNGKey(CASES[name][0])
    scene = full_view_sphere_scene()
    if name == "lookfrom_z":
        return lambda z: render_loss(
            scene, (torch.stack([torch.tensor(0.0), torch.tensor(0.0), z]),)
            + CAM[1:], key)
    if name == "vfov":
        return lambda fov: render_loss(scene, CAM[:3] + (fov,) + CAM[4:], key)
    if name == "defocus_aperture":
        # the aperture-disk offset scales fixed uniforms, so the aperture
        # gradient is smooth; blur keeps the image mean to first order, so
        # the loss is the second moment of a defocused marble sphere
        marble = _one_sphere(lambda b: b.lambertian(b.noise_texture(2.0))).finish()

        def loss(ap):
            img = render(marble, make_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0),
                                             (0.0, 1.0, 0.0), 40.0, 1.0, ap,
                                             5.0), key)
            return (img * img).mean()
        return loss
    if name == "emission":
        b = _one_sphere(lambda b: b.diffuse_light_color((2.0, 2.0, 2.0)))
        b.sky = (0.0, 0.0, 0.0)
        light = b.finish()
        return lambda e: render_loss(_with(light, "textures", "color", 0, e),
                                     CAM, key)
    if name == "metal_fuzz":
        metal = _one_sphere(lambda b: b.metal((0.9, 0.9, 0.9), 0.3)).finish()
        return lambda fz: render_loss(_with(metal, "materials", "fuzz", 0, fz),
                                      CAM, key)
    group, leaf, index = {
        "albedo": ("textures", "color", (0, 0)),
        "sphere_center_z": ("spheres", "center", (0, 2)),
        "sphere_radius": ("spheres", "radius", 0),
    }[name]
    return lambda x: render_loss(_with(scene, group, leaf, index, x), CAM, key)


@functools.lru_cache(maxsize=None)
def autodiff(name: str) -> float:
    return auto_grad(loss_of(name), CASES[name][1])


def grads(name: str):
    """(autodiff, finite-difference) gradients of case ``name``."""
    _, x0, h = CASES[name]
    return autodiff(name), fd_grad(loss_of(name), x0, h)


def assert_fd(g_auto: float, g_fd: float, rel: float) -> None:
    assert np.isfinite(g_auto) and g_auto != 0.0
    assert np.sign(g_auto) == np.sign(g_fd)
    assert g_auto == pytest.approx(g_fd, rel=rel, abs=FD_ABS)


# ---------------------------------------------------------------------------
# the camera
# ---------------------------------------------------------------------------

def test_vfov_tensor_gives_vertical_a_gradient():
    vfov = torch.tensor(40.0, requires_grad=True)
    cam = make_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                      vfov, 1.5, 0.0, 3.0)
    assert cam.vertical.requires_grad and cam.horizontal.requires_grad
    (g,) = torch.autograd.grad(cam.vertical[1], vfov)
    # vertical.y = 2 fd tan(theta / 2): d/dvfov = fd sec^2(theta/2) pi/180
    th = np.deg2rad(40.0) / 2
    assert float(g) == pytest.approx(3.0 / np.cos(th) ** 2 * np.pi / 180.0,
                                     rel=1e-5)


@pytest.mark.parametrize("deg", [20.0, 30.0, 40.0, 60.0, 90.0])
def test_tanf_forward_keeps_libm_bits(deg):
    x = np.float32(np.deg2rad(deg) / 2)
    want = np.float32(tcam._libm_tanf(float(x)))
    got = tcam._Tanf.apply(torch.tensor(x))
    assert got.numpy().tobytes() == want.tobytes()
    # a float vfov and a float32-tensor one give the same camera where
    # theta rounds alike (a whole number of degrees below 2^24)
    a = make_camera((0.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), deg,
                    1.5, 0.02, 3.0)
    b = make_camera((0.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                    torch.tensor(deg), 1.5, 0.02, 3.0)
    th64 = np.float32(deg * np.pi / 180.0 * 0.5)
    th32 = np.float32(np.float32(np.float32(deg) * np.float32(np.pi))
                      / np.float32(180.0)) * np.float32(0.5)
    if th64 == th32:
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name),
                               getattr(b, f.name).detach()), (deg, f.name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_camera_grad_matches_jax_autodiff(name):
    want = float(np.load(FIXTURE)[name])
    assert autodiff(name) == pytest.approx(want, rel=1e-3)


# ---------------------------------------------------------------------------
# twins of tests/test_grad.py against finite differences
# ---------------------------------------------------------------------------

class TestCameraGrad:
    def test_lookfrom_z(self):
        assert_fd(*grads("lookfrom_z"), rel=0.05)

    def test_vfov(self):
        assert_fd(*grads("vfov"), rel=0.05)

    def test_defocus_aperture(self):
        g_auto, g_fd = grads("defocus_aperture")
        assert abs(g_auto) > 1e-4  # the blur moves the second moment
        assert_fd(g_auto, g_fd, rel=0.05)


class TestAlbedoGrad:
    def test_linear_in_albedo(self):
        g_auto, g_fd = grads("albedo")
        assert_fd(g_auto, g_fd, rel=2e-2)
        assert g_auto > 0.0

    def test_emission_grad(self):
        g_auto, g_fd = grads("emission")
        assert_fd(g_auto, g_fd, rel=1e-3)
        # every pixel sees the light and the 3 channels share e: d mean/de = 1
        assert g_auto == pytest.approx(1.0, abs=1e-3)


class TestGeometryGrad:
    """Through the closest hit's backward (K6's plain version)."""

    @pytest.mark.parametrize("name", ["sphere_center_z", "sphere_radius"])
    def test_sphere_leaf(self, name):
        assert_fd(*grads(name), rel=0.05)

    def test_metal_fuzz(self):
        assert_fd(*grads("metal_fuzz"), rel=0.05)


def jax_grads() -> dict:
    """``jax.grad`` of tests/test_grad.py's losses at ``CASES``' keys and
    points, on the CPU: the fixture's values."""
    import jax
    import jax.numpy as jnp
    import test_grad as tg
    from pathtrace_tpu.camera import make_camera as jmake_camera
    from pathtrace_tpu.models.build import SceneBuilder as JBuilder
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.render.frame import render_frame as jrender_frame

    def one_sphere(material_of, sky=None):
        b = JBuilder()
        b.sphere((0.0, 0.0, -4.0), 4.0, material_of(b))
        if sky is not None:
            b.sky = sky
        return b.finish()

    def with_leaf(scene, group, leaf, index, value):
        obj = getattr(scene, group)
        arr = jnp.asarray(getattr(obj, leaf)).at[index].set(value)
        return dataclasses.replace(scene, **{
            group: dataclasses.replace(obj, **{leaf: arr})})

    def loss(scene, cam_args, key):
        return tg.render_loss(scene, cam_args, JFeatures.from_scene(scene), key)

    sphere = tg.full_view_sphere_scene()
    marble = one_sphere(lambda b: b.lambertian(b.noise_texture(2.0)))
    light = one_sphere(lambda b: b.diffuse_light_color((2.0, 2.0, 2.0)),
                       sky=(0.0, 0.0, 0.0))
    metal = one_sphere(lambda b: b.metal((0.9, 0.9, 0.9), 0.3))

    def aperture(ap, key):
        cam = jmake_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                           40.0, 1.0, ap, 5.0)
        img, _ = jrender_frame(marble, cam, 24, 24, 4, 3, key,
                               differentiable=True,
                               features=JFeatures.from_scene(marble))
        return jnp.mean(img * img)

    fns = {
        "lookfrom_z": lambda z, k: loss(
            sphere, (jnp.stack([jnp.float32(0.0), jnp.float32(0.0), z]),)
            + tg.CAM[1:], k),
        "vfov": lambda f, k: loss(sphere, tg.CAM[:3] + (f,) + tg.CAM[4:], k),
        "defocus_aperture": aperture,
        "albedo": lambda a, k: loss(
            with_leaf(sphere, "textures", "color", (0, 0), a), tg.CAM, k),
        "emission": lambda e, k: loss(
            with_leaf(light, "textures", "color", 0, e), tg.CAM, k),
        "sphere_center_z": lambda z, k: loss(
            with_leaf(sphere, "spheres", "center", (0, 2), z), tg.CAM, k),
        "sphere_radius": lambda r, k: loss(
            with_leaf(sphere, "spheres", "radius", 0, r), tg.CAM, k),
        "metal_fuzz": lambda f, k: loss(
            with_leaf(metal, "materials", "fuzz", 0, f), tg.CAM, k),
    }
    out = {}
    for name, (seed, x0, _) in CASES.items():
        out[name] = np.float64(jax.grad(fns[name])(
            jnp.float32(x0), jax.random.PRNGKey(seed)))
        print(name, repr(float(out[name])), flush=True)
    return out


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(__file__))
    np.savez(FIXTURE, **jax_grads())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
