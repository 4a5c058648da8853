"""The silhouette boundary term of the port (``ops/silhouette.py``) against
the JAX package's, against finite differences, and in the trainer.

Against JAX (the fixture ``tests/goldens/torch_port_silhouette.npz``,
written by ``PYTHONPATH=. python tests/test_torch_silhouette.py`` on the
CPU from tests/torch_port_util.py's ``silhouette_cases``: a flat sphere, a
moving sphere under an open shutter, a sphere under an aperture camera, a
rect, a box, and a mixed scene of all three families with a moving
sphere, an aperture and an open shutter), the estimator is held in its
two halves and whole:

* the radiance jumps: every pair the reference traced (its film points,
  normals, lens and shutter uniforms and key, recorded in the fixture)
  goes through the port's ``_edge_radiance_pairs``; each sample's
  (L_in - L_out) within 1e-3, except at most ``PAIR_BUDGET`` of the
  samples: a pair is two rays of the general trace at depth <= 3, whose
  per-ray budget is 0.5% (a ray that meets an edge flips its hit on a
  ULP), so 1%. Every sample of every case is counted; none is sampled;
* the geometry: the port's ``silhouette_grads_all`` with the reference's
  recorded jumps in place of its own trace, per leaf by relative L2
  within ``GEOMETRY_TOL`` (1e-2). The float32 tangent's central
  difference at 1e-3 rad keeps about four digits whichever order the
  projections round in (measured: at most 5e-4 on every leaf but one);
  the moving sphere's radius gradient is a sum that cancels to 2% of its
  centre's, which reads 5.3e-3;
* whole: per leaf within ``WHOLE_TOL`` (5e-2): the two halves above pin
  the estimator, and one flipped pair allowed by the budget moves a leaf
  by its sample's share of the weights, a few percent in the smallest
  family here (the rect case weights 128 samples, most of them zero off
  the edge).

Against finite differences: twins of tests/test_silhouette.py's FD
checks (the sphere, rect, box, aperture and moving-sphere cases) on the
port alone, at the reference's sizes, with its sign assertion and
relative bounds (0.35 for the sphere, 0.3 rect/box/aperture, 0.5 for the
centre delta), and the interior-only control where the reference has one.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.camera import get_rays, make_camera  # noqa: E402
from pathtrace_tpu_torch.models import build  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import silhouette as tsil  # noqa: E402
from pathtrace_tpu_torch.render.frame import render_frame  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from torch_port_util import (  # noqa: E402
    SIL_KEY_SEED, SIL_WHOLE_TOL, flat_box_scene, flat_rect_scene,
    flat_sphere_scene, lane_close, moving_flat_scene, rel_l2, sil_camera,
    sil_grad_img, silhouette_cases,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_silhouette.npz")
KEY_SEED = SIL_KEY_SEED
PAIR_BUDGET = 0.01
GEOMETRY_TOL = 1e-2
WHOLE_TOL = SIL_WHOLE_TOL
CASES = ("sphere", "moving", "aperture", "rect", "box", "mixed")
# the example's --geometry run at the fixture's size
EXAMPLE_ARGS = ["--geometry", "--steps", "5", "--size", "16"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(name):
    scene, cam, W, H, D, M = silhouette_cases(build, make_camera)[name]
    return scene, cam, W, H, D, M, _t(sil_grad_img(name, H, W))


def _pairs(ref, name):
    """The reference's recorded pair traces of a case, in call order."""
    n = int(ref[f"{name}.n_pairs"])
    fields = ("s", "t", "n_hat", "key", "dL", "lens", "time", "eps")
    return [{f: ref[f"{name}.pairs{i}.{f}"] for f in fields}
            for i in range(n)]


class TestProjection:
    """Twins of tests/test_silhouette.py's ``TestProjection``."""

    def test_roundtrip_center_pixel(self):
        cam = sil_camera(make_camera)
        s, t, ok = tsil.project_to_film(cam, torch.zeros(3))
        assert bool(ok)
        assert abs(float(s) - 0.5) < 1e-5 and abs(float(t) - 0.5) < 1e-5

    def test_ray_point_projects_back(self):
        cam = sil_camera(make_camera)
        ro, rd, _ = get_rays(cam, torch.tensor([0.23]), torch.tensor([0.71]),
                             torch.full((1, 3), 0.5))
        s, t, ok = tsil.project_to_film(cam, (ro + 2.5 * rd)[0])
        assert bool(ok)
        assert abs(float(s) - 0.23) < 1e-5 and abs(float(t) - 0.71) < 1e-5


@pytest.mark.parametrize("name", CASES)
def test_edge_pairs_match_jax(name):
    ref = np.load(FIXTURE)
    scene, cam, W, H, D, _, _ = _case(name)
    feats = SceneFeatures.from_scene(scene)
    outside, total = 0, 0
    for p in _pairs(ref, name):
        got = tsil._edge_radiance_pairs(
            scene, cam, _t(p["s"]), _t(p["t"]), _t(p["n_hat"]),
            float(p["eps"]), W, H, _t(p["key"].astype(np.int64)), D, feats,
            lens_uni=_t(p["lens"]) if p["lens"].size else None,
            time_uni=_t(p["time"]) if p["time"].size else None)
        close = lane_close(got.numpy(), p["dL"]).all(axis=1)
        outside += int((~close).sum())
        total += close.size
    assert total > 0
    assert outside <= PAIR_BUDGET * total, (name, outside, total)


@pytest.mark.parametrize("name", CASES)
def test_silhouette_geometry_matches_jax(name, monkeypatch):
    """The port's estimator on the reference's own radiance jumps."""
    ref = np.load(FIXTURE)
    scene, cam, W, H, D, M, g = _case(name)
    recorded = iter(_pairs(ref, name))

    def replay(*args, **kw):
        return _t(next(recorded)["dL"])

    monkeypatch.setattr(tsil, "_edge_radiance_pairs", replay)
    got = tsil.silhouette_grads_all(scene, cam, W, H, g, PRNGKey(KEY_SEED),
                                    max_depth=D, n_samples=M)
    names = list(ref[f"{name}.names"])
    assert sorted(got) == sorted(names)
    for n in names:
        err = rel_l2(got[n].numpy(), ref[f"{name}.grad.{n}"])
        assert err <= GEOMETRY_TOL, (name, n, err)


@pytest.mark.parametrize("name", CASES)
def test_silhouette_grads_all_matches_jax(name):
    ref = np.load(FIXTURE)
    scene, cam, W, H, D, M, g = _case(name)
    got = tsil.silhouette_grads_all(scene, cam, W, H, g, PRNGKey(KEY_SEED),
                                    max_depth=D, n_samples=M)
    names = list(ref[f"{name}.names"])
    assert sorted(got) == sorted(names)
    for n in names:
        b = ref[f"{name}.grad.{n}"]
        assert np.isfinite(got[n].numpy()).all(), (name, n)
        err = rel_l2(got[n].numpy(), b)
        assert err <= WHOLE_TOL, (name, n, err)
    if name == "mixed":
        assert {"spheres.center_delta", "rects.a0", "boxes.p0"} <= set(got)


# ---------------------------------------------------------------------------
# finite differences (the port alone)
# ---------------------------------------------------------------------------

def _render(scene, cam, W, H, S, key, differentiable=False):
    img, _ = render_frame(scene, cam, W, H, S, 3, key,
                          differentiable=differentiable,
                          features=SceneFeatures.from_scene(scene))
    return img


def _set(scene, group, leaf, index, value):
    import dataclasses

    g = getattr(scene, group)
    x = getattr(g, leaf).clone()
    x[index] = value
    return dataclasses.replace(scene,
                               **{group: dataclasses.replace(g, **{leaf: x})})


def _mse(img, target):
    return float(((img.double() - target.double()) ** 2).mean())


def test_fd_vs_boundary_term_across_edge():
    """Twin of ``test_fd_vs_boundary_term_across_edge``: d(MSE)/d(center.x)
    of a flat-shaded sphere, FD of the full loss against the interior
    gradient plus the boundary term (0.35)."""
    cam = sil_camera(make_camera)
    key = PRNGKey(3)
    target = _render(flat_sphere_scene(build, 0.0), cam, 32, 32, 8, key)
    scene0 = flat_sphere_scene(build, 0.25)

    cx = torch.tensor(0.25, requires_grad=True)
    img = _render(_set(scene0, "spheres", "center", (0, 0), cx), cam, 32, 32,
                  8, key, differentiable=True)
    (g_int,) = torch.autograd.grad(((img - target) ** 2).mean(), cx)
    g_int = float(g_int)
    with torch.no_grad():
        img0 = _render(scene0, cam, 32, 32, 8, key)
        d_center, _, _ = tsil.silhouette_grads(
            scene0, cam, 32, 32, 2.0 * (img0 - target) / img0.numel(),
            PRNGKey(9), max_depth=3, n_samples=512)
        g_edge = float(d_center[0, 0])
        h = 0.02
        g_fd = (_mse(_render(_set(scene0, "spheres", "center", (0, 0),
                                  0.25 + h), cam, 32, 32, 8, key), target)
                - _mse(_render(_set(scene0, "spheres", "center", (0, 0),
                                    0.25 - h), cam, 32, 32, 8, key),
                       target)) / (2 * h)
    assert abs(g_fd) > 5 * abs(g_int), (g_fd, g_int)
    total = g_int + g_edge
    assert np.sign(total) == np.sign(g_fd)
    assert abs(total - g_fd) < 0.35 * abs(g_fd), (g_fd, g_int, g_edge)


def _fd_edge_case(mk, family, leaf_of, cam, size, spp, n_edge, key_edge,
                  h, rel):
    """FD of the loss w.r.t. a translation ``dx`` of ``mk(dx)`` against the
    family's boundary term (common random numbers)."""
    key = PRNGKey(3)
    target = _render(mk(0.0), cam, size, size, spp, key)
    dx0 = 0.2137
    scene0 = mk(dx0)
    with torch.no_grad():
        img0 = _render(scene0, cam, size, size, spp, key)
        grad_img = 2.0 * (img0 - target) / img0.numel()
        if family == "sphere":
            terms = tsil.silhouette_grads(scene0, cam, size, size, grad_img,
                                          PRNGKey(key_edge), max_depth=3,
                                          n_samples=n_edge)
        else:
            fn = (tsil.rect_silhouette_grads if family == "rect"
                  else tsil.box_silhouette_grads)
            terms = fn(scene0, cam, size, size, grad_img, PRNGKey(key_edge),
                       max_depth=3, n_per_edge=n_edge)
        g_edge = leaf_of(terms)
        g_fd = (_mse(_render(mk(dx0 + h), cam, size, size, spp, key), target)
                - _mse(_render(mk(dx0 - h), cam, size, size, spp, key),
                       target)) / (2 * h)
    assert np.sign(g_edge) == np.sign(g_fd), (g_fd, g_edge)
    assert abs(g_edge - g_fd) < rel * abs(g_fd), (g_fd, g_edge)


def test_fd_vs_edge_rect():
    """Twin of ``test_fd_vs_edge_rect`` (40x40 x16, 256 samples an edge)."""
    _fd_edge_case(lambda dx: flat_rect_scene(build, dx), "rect",
                  lambda t: float(t["rects.a0"][0] + t["rects.a1"][0]),
                  sil_camera(make_camera), 40, 16, 256, 9, 0.004, 0.3)


def test_fd_vs_edge_box():
    """Twin of ``test_fd_vs_edge_box`` (the world translation's column of
    ``world_from_obj``)."""
    _fd_edge_case(lambda dx: flat_box_scene(build, dx), "box",
                  lambda t: float(t["boxes.world_from_obj"][0, 0, 3]),
                  sil_camera(make_camera), 40, 16, 256, 11, 0.004, 0.3)


def test_aperture_lens_integration():
    """Twin of ``test_aperture_lens_integration``: each edge sample rides
    its own lens point (40x40 x64, 2048 samples)."""
    _fd_edge_case(lambda dx: flat_sphere_scene(build, dx), "sphere",
                  lambda t: float(t[0][0, 0]),
                  sil_camera(make_camera, aperture=0.25), 40, 64, 2048, 9,
                  0.01, 0.3)


def test_fd_vs_boundary_term_center_delta():
    """Twin of ``TestMovingSilhouette.test_fd_vs_boundary_term_center_delta``:
    the contour at per-sample shutter times gives ``center_delta`` its
    boundary term (32x32 x16, 1024 samples, 0.5)."""
    cam = sil_camera(make_camera, shutter=True)
    key = PRNGKey(4)
    target = _render(moving_flat_scene(build, 0.2), cam, 32, 32, 16, key)
    dx0 = 0.55
    scene0 = moving_flat_scene(build, dx0)
    assert SceneFeatures.from_scene(scene0).has_motion

    dx = torch.tensor(dx0, requires_grad=True)
    img = _render(_set(scene0, "spheres", "center_delta", (0, 0), dx), cam,
                  32, 32, 16, key, differentiable=True)
    (g_int,) = torch.autograd.grad(((img - target) ** 2).mean(), dx)
    g_int = float(g_int)
    with torch.no_grad():
        img0 = _render(scene0, cam, 32, 32, 16, key)
        d_center, d_delta, _ = tsil.silhouette_grads(
            scene0, cam, 32, 32, 2.0 * (img0 - target) / img0.numel(),
            PRNGKey(11), max_depth=3, n_samples=1024)
        g_edge = float(d_delta[0, 0])
        h = 0.04
        loss = [_mse(_render(_set(scene0, "spheres", "center_delta", (0, 0),
                                  dx0 + s * h), cam, 32, 32, 16, key), target)
                for s in (1, -1)]
        g_fd = (loss[0] - loss[1]) / (2 * h)
    assert abs(g_fd) > 5 * abs(g_int), (g_fd, g_int)
    g_ad = g_int + g_edge
    assert np.sign(g_ad) == np.sign(g_fd)
    assert abs(g_ad - g_fd) < 0.5 * abs(g_fd), (g_ad, g_fd, g_int, g_edge)
    assert abs(float(d_center[0, 0])) > 0.0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_adds_the_boundary_term():
    """``silhouette=True``: after the backward each named leaf's gradient
    gains ``silhouette_grads_all`` of the step's forward image at
    ``fold_in(key, 0x51)``, before Adam (the interior-only gradient of the
    same step plus the terms, exactly)."""
    from pathtrace_tpu_torch.parallel import inverse as tinv

    cam = sil_camera(make_camera)
    key = PRNGKey(1)
    target = _render(flat_sphere_scene(build, 0.0), cam, 16, 16, 4, key)

    def fresh(silhouette):
        return tinv.make_inverse_renderer(
            flat_sphere_scene(build, 0.3), cam, 16, 16, samples=4,
            max_depth=3, device="cpu", silhouette=silhouette,
            trainable=lambda p: p in ("spheres.center", "spheres.radius"),
            silhouette_samples=64)

    r0, s0, names = fresh(False)
    r1, s1, _ = fresh(True)
    assert names == ["spheres.center", "spheres.radius"]
    start = [p.detach().clone() for p in s1.params]
    s0, l0 = r0.train_step(s0, target, key)
    s1, l1 = r1.train_step(s1, target, key)
    assert float(l0) == float(l1)
    with torch.no_grad():
        img = r1.render(start, key)
    terms = r1.silhouette_terms(start, target, key, img)
    assert terms["spheres.center"].abs().max() > 0
    for n, p0, p1 in zip(names, s0.params, s1.params):
        assert torch.equal(p1.grad, p0.grad + terms[n]), n


def test_example_geometry_tracks_jax(tmp_path, capsys):
    """The example's ``--geometry`` run (``small``, 16x16 x4, depth 3,
    colours and ``spheres.center`` with the boundary term, 5 steps) against
    the reference example's losses at the same size (the fixture): the
    first loss to 1e-5 relative, every later one to 3% (measured at most
    1.6%: Adam's normalized steps turn the two packages' ~1e-6 gradient
    differences into centre differences of up to 1e-3 by step 4, which
    move a few of the 1024 rays across an edge), and the loss lower after
    the last step than before the first in both."""
    from pathtrace_tpu_torch.examples import inverse_render

    rc = inverse_render.main(["--device", "cpu", *EXAMPLE_ARGS, "--out",
                              str(tmp_path / "g.npy")])
    log = capsys.readouterr().out
    assert rc == 0, log
    assert "trainable parameters: ['spheres.center', 'textures.color']" in log
    losses = [float(x) for x in re.findall(r"loss ([\d.]+), ", log)]
    ref = np.load(FIXTURE)["example.losses"]
    assert len(losses) == len(ref) == 5
    assert losses[0] == pytest.approx(float(ref[0]), rel=1e-5)
    np.testing.assert_allclose(losses, ref, rtol=3e-2)
    assert losses[-1] < losses[0] and ref[-1] < ref[0]


# ---------------------------------------------------------------------------
# the fixture (JAX on the CPU)
# ---------------------------------------------------------------------------

def make_fixture() -> dict:
    import jax
    import jax.numpy as jnp

    from pathtrace_tpu.camera import make_camera as jmake
    from pathtrace_tpu.models import build as jbuild
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops import silhouette as jsil

    out = {}
    calls = []
    orig = jsil._edge_radiance_pairs

    def recording(scene, camera, s, t, n_hat_px, eps_px, width, height, key,
                  max_depth, features, lens_uni=None, time_uni=None):
        dL = orig(scene, camera, s, t, n_hat_px, eps_px, width, height, key,
                  max_depth, features, lens_uni=lens_uni, time_uni=time_uni)
        entry = {"eps": np.float32(eps_px)}
        calls.append(entry)
        lens = jnp.zeros((0, 2)) if lens_uni is None else lens_uni
        tu = jnp.zeros((0,)) if time_uni is None else time_uni

        def record(s_, t_, n_, k_, d_, l_, u_):
            entry.update(s=np.asarray(s_), t=np.asarray(t_),
                         n_hat=np.asarray(n_),
                         key=np.asarray(k_).astype(np.uint32),
                         dL=np.asarray(d_), lens=np.asarray(l_),
                         time=np.asarray(u_))

        jax.debug.callback(record, s, t, n_hat_px, key, dL, lens, tu,
                           ordered=True)
        return dL

    jsil._edge_radiance_pairs = recording
    try:
        for name, (scene, cam, W, H, D, M) in silhouette_cases(
                jbuild, jmake).items():
            calls.clear()
            terms = jsil.silhouette_grads_all(
                scene, cam, W, H, jnp.asarray(sil_grad_img(name, H, W)),
                jax.random.PRNGKey(KEY_SEED), max_depth=D,
                features=JFeatures.from_scene(scene), n_samples=M)
            jax.effects_barrier()
            out[f"{name}.names"] = np.array(sorted(terms))
            out.update({f"{name}.grad.{n}": np.asarray(v)
                        for n, v in terms.items()})
            out[f"{name}.n_pairs"] = np.int64(len(calls))
            for i, c in enumerate(calls):
                out.update({f"{name}.pairs{i}.{k}": v for k, v in c.items()})
    finally:
        jsil._edge_radiance_pairs = orig
    out["example.losses"] = np.array(jax_example_losses(), np.float64)
    return out


def jax_example_losses():
    """The reference example's ``--geometry`` losses at EXAMPLE_ARGS's size
    (its main, on a one-device mesh)."""
    import jax
    import jax.numpy as jnp

    from pathtrace_tpu.models import presets
    from pathtrace_tpu.parallel import mesh as pmesh
    from pathtrace_tpu.parallel.inverse import make_inverse_renderer

    steps, size = int(EXAMPLE_ARGS[2]), int(EXAMPLE_ARGS[4])
    scene, cam = presets.small(aspect=1.0)
    renderer, state, names = make_inverse_renderer(
        scene, cam, size, size, samples=4, max_depth=3,
        mesh=pmesh.make_render_mesh(jax.devices()[:1]), learning_rate=2e-2,
        trainable=lambda p: ("textures.color" in p) or (p == "spheres.center"),
        silhouette=True)
    key = jax.random.PRNGKey(0)
    target = renderer.render(state.params, key)
    perturbed = list(state.params)
    for i, name in enumerate(names):
        if name == "spheres.center":
            perturbed[i] = perturbed[i] + jnp.asarray([0.05, 0.0, 0.0])
        if name == "textures.color":
            perturbed[i] = jnp.clip(perturbed[i] + 0.2, 0.0, 1.0)
    state = renderer.init(perturbed)
    losses = []
    for _ in range(steps):
        state, loss = renderer.train_step(state, target, key)
        losses.append(float(loss))
    return losses


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
