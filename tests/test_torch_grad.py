"""The port's training path against the JAX package: the closest hit's
backward (K6), the differentiable trace, one Adam step, and the committed
gradient fixture.

Tolerances and why:

* K6 plain vs JAX ``_vjp_bwd`` on JAX's own (t, idx): every gradient to
  1e-5 relative to the magnitude of the terms it sums. The derivative
  ``dt/db = -1 -/+ b/s`` cancels when ``|b| ~ s`` (rays on the 1000-radius
  ground), so a one-ULP difference of XLA's rounding shows up relative to
  ``|g| (1 + |b|/s)``, not to the result (measured: one ray of 2048 on
  random_spheres exceeds 1e-5 of its own result).
* ``trace_fast_diff`` at depth 4: forward under the lane contract; the
  gradient of ``sum(w * radiance)``, ``w`` from numpy and zero on the rays
  outside the contract, per default-trainable leaf by relative L2. Rays
  that pass the contract still differ by up to ~1e-4 in t, because K1's
  expanded quadratic is rounded differently by XLA (tests/test_torch_
  kernels.py); through the normals of the 0.2-radius spheres that moves
  the centre and radius gradients by ~1.5% (measured on 2048 rays:
  centre 1.5e-2, radius 1.8e-2, fuzz 2.4e-3, ref_idx 2.5e-3, colour
  1.8e-4). Restricted to rays whose radiance agrees to 1e-6, every leaf
  is within 1e-3 (measured: at most 4.4e-4), which pins the difference
  on the forward drift and not on the gradient code.
* One Adam step: loss to 1e-6, gradients as above, and the updated
  parameters to 1e-6 where the gradient is not zero in both. Five steps
  on fixed rays: losses to 2e-4, parameter displacement to 1e-3.

The fixture ``tests/goldens/torch_port_grad_small.npz`` carries 2048
primary rays of ``random_spheres``, the seed, the weights ``w`` and JAX's
radiance and per-leaf gradients at depth 4, for the card check, which
has no JAX. Its weights keep only rays that agree with JAX to 1e-5, so
the port is held to it by the tighter ``FIXTURE_GRAD_TOL``
(tests/torch_port_util.py). Regenerate it with
``PYTHONPATH=. python tests/test_torch_grad.py``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.config import MAX_T, MIN_T  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu.ops import intersect_pallas as jip  # noqa: E402
from pathtrace_tpu.parallel import inverse as jinv  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel as tik  # noqa: E402
from pathtrace_tpu_torch.parallel import inverse as tinv  # noqa: E402
from torch_port_util import (  # noqa: E402
    FIXTURE_GRAD_TOL, GRAD_TOL, assert_grads_close, assert_lanes_close,
    jax_camera_rays, jax_trace_vjp, lane_close, port_grads, port_trace_diff,
    rel_l2, scene_pair,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_grad_small.npz")
N_RAYS = 2048
DEPTH = 4
SEED = 7
ASPECT = 16 / 9
# the fixture's weights are kept on rays whose radiance agrees to this
FIXTURE_TIGHT = 1e-5


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _term_scales(center, radius, ro, rd, idx, g):
    """Magnitudes of the terms each K6 gradient sums (float64): of
    dt/db, ``|g| (1 + |b|/s)``; of dt/dcq, ``|g| / (2 s)``."""
    c = center[idx].astype(np.float64)
    r = radius[idx].astype(np.float64)
    oc = ro.astype(np.float64) - c
    b = (oc * rd).sum(1)
    disc = b * b - ((oc * oc).sum(1) - r * r)
    inv_s = np.where(disc > 0, 1.0 / np.sqrt(np.maximum(disc, 1e-300)), 0.0)
    m_b = np.abs(g) * (1.0 + np.abs(b) * inv_s)
    m_q = np.abs(g) * inv_s  # |g_q * 2| per unit of oc
    s_ro = m_b[:, None] * np.abs(rd) + m_q[:, None] * np.abs(oc)
    s_rd = m_b[:, None] * np.abs(oc)
    s_r = m_q * np.abs(r)
    n = center.shape[0]
    s_c = np.zeros((n, 3))
    np.add.at(s_c, idx, s_ro)
    s_rad = np.zeros(n)
    np.add.at(s_rad, idx, s_r)
    return s_c, s_rad, s_ro, s_rd


@pytest.mark.parametrize("preset", ["small", "random_spheres"])
def test_k6_plain_matches_jax_vjp_bwd(preset):
    jscene, jcam, scene = scene_pair(preset, ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=3)
    sp = jscene.spheres
    t, idx = jip._sphere_nearest_pallas_impl(
        sp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), MIN_T, MAX_T,
        False)
    t, idx = np.asarray(t), np.asarray(idx)
    g_t = np.random.default_rng(5).standard_normal(N_RAYS).astype(np.float32)
    g_sp, g_ro, g_rd, _ = jip._vjp_bwd(
        MIN_T, MAX_T, False,
        (sp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), t, idx),
        (jnp.asarray(g_t), None))
    got = tik.sphere_nearest_bwd(
        scene.spheres.center, scene.spheres.radius, torch.from_numpy(ro),
        torch.from_numpy(rd), torch.from_numpy(t), torch.from_numpy(idx),
        torch.from_numpy(g_t))
    hit = t < MAX_T
    scales = _term_scales(np.asarray(sp.center), np.asarray(sp.radius), ro,
                          rd, idx, np.where(hit, g_t, 0.0))
    for name, a, b, scale in zip(
            ("center", "radius", "ro", "rd"), got,
            (g_sp.center, g_sp.radius, g_ro, g_rd), scales):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        bound = 1e-5 * (np.abs(b) + scale) + 1e-7
        worst = float(np.max(np.abs(a - b) - bound))
        assert worst <= 0.0, f"{preset} g_{name}: {worst}"
    # misses get exactly nothing
    assert np.all(got[2].numpy()[~hit] == 0) and np.all(got[3].numpy()[~hit] == 0)


def test_sphere_nearest_function_backward_is_k6():
    """SphereNearest: forward = the closest hit, backward = K6 (counted),
    and no gradient to the soa."""
    scene, cam = presets.small(ASPECT)
    from pathtrace_tpu_torch.camera import get_rays
    from torch_port_util import numpy_uniforms

    s, t_, u = numpy_uniforms(512, seed=2)
    ro, rd, _ = get_rays(cam, torch.from_numpy(s), torch.from_numpy(t_),
                         torch.from_numpy(u))
    center = scene.spheres.center.clone().requires_grad_(True)
    radius = scene.spheres.radius.clone().requires_grad_(True)
    ro = ro.clone().requires_grad_(True)
    soa = tfp.build_sphere_soa(scene)
    t, idx = tik.SphereNearest.apply(soa, center, radius, ro, rd)
    t_ref, idx_ref = tik.sphere_nearest(soa, torch.cat([ro, rd], 1).T.contiguous())
    assert torch.equal(t, t_ref) and torch.equal(idx, idx_ref)
    calls = tik.BWD_PLAIN_CALLS
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(512)
                         .astype(np.float32))
    g_c, g_r, g_ro = torch.autograd.grad((g * torch.where(
        t < MAX_T, t, 0.0)).sum(), (center, radius, ro))
    assert tik.BWD_PLAIN_CALLS == calls + 1
    ref = tik.sphere_nearest_bwd_plain(center, radius, ro, rd, t, idx, g)
    assert torch.equal(g_c, ref[0]) and torch.equal(g_r, ref[1])
    assert torch.equal(g_ro, ref[2])


# ---------------------------------------------------------------------------
# the differentiable trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["small", "random_spheres"])
def test_trace_fast_diff_matches_jax(preset):
    jscene, jcam, scene = scene_pair(preset, ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=1)
    rad, params, names = port_trace_diff(scene, ro, rd, tm, SEED, DEPTH)
    got = rad.detach().numpy()
    w0 = np.random.default_rng(9).standard_normal((N_RAYS, 3)).astype(np.float32)
    ref_rad, jgrads, jnames = jax_trace_vjp(jscene, ro, rd, tm, SEED, DEPTH)
    assert names == jnames
    assert_lanes_close(got, ref_rad, what=f"{preset} radiance")
    for tight, tol in ((1e-3, GRAD_TOL), (1e-6, None)):
        keep = lane_close(got, ref_rad, tight, tight).all(axis=1)
        w = w0 * keep[:, None]
        assert_grads_close(port_grads(rad, params, w), jgrads(w), names,
                           tol or {n: 1e-3 for n in names},
                           f"{preset} (rays within {tight})")


def test_split_scene_names_match_jax():
    for preset in ("small", "random_spheres", "two_perlin_spheres"):
        jscene, _, scene = scene_pair(preset, ASPECT)
        _, _, jnames = jinv.split_scene(jscene)
        params, rebuild, names = tinv.split_scene(scene)
        assert names == jnames
        for n, p in zip(names, params):
            assert p.requires_grad and p.is_leaf, n
        rebuilt = rebuild(params)
        assert rebuilt.spheres.center is params[0]
        assert torch.equal(rebuilt.spheres.mat_id, scene.spheres.mat_id)


def test_albedo_gradient_matches_fd():
    """Twin of tests/test_fastpath.py::test_albedo_gradient_matches_fd_exactly
    on the port."""
    scene, cam = presets.small(1.0)
    feats = SceneFeatures.from_scene(scene)
    _, jcam, _ = scene_pair("small", 1.0)
    ro, rd, tm = (torch.from_numpy(x) for x in jax_camera_rays(jcam, 2048))

    def loss(c0):
        color = torch.cat([c0.reshape(1, 1).expand(1, 3),
                           scene.textures.color[1:]])
        s2 = dataclasses.replace(
            scene, textures=dataclasses.replace(scene.textures, color=color))
        rad, _ = tfp.trace_fast_diff(s2, ro, rd, tm, 3, 4, feats)
        return rad.mean()

    c0 = torch.tensor(0.3, requires_grad=True)
    (g_auto,) = torch.autograd.grad(loss(c0), c0)
    with torch.no_grad():
        g_fd = (loss(c0 + 1e-2) - loss(c0 - 1e-2)) / 2e-2
    assert float(g_auto) == pytest.approx(float(g_fd), rel=1e-3)
    assert float(g_auto) > 0


def test_adam_step_matches_jax_optax():
    import optax

    W, H, S = 16, 8, 2
    jscene, jcam, scene = scene_pair("small", W / H)
    ro, rd, tm = jax_camera_rays(jcam, H * W * S, seed=4)
    target = np.random.default_rng(2).random((H, W, 3)).astype(np.float32)
    target *= 0.5

    renderer, state, names = tinv.make_inverse_renderer(
        scene, presets.small(W / H)[1], W, H, samples=S, max_depth=DEPTH,
        device="cpu")
    before = [p.detach().clone() for p in state.params]
    rays = tuple(torch.from_numpy(x) for x in (ro, rd, tm))
    state, loss = renderer.step_on(state, torch.from_numpy(target), rays, SEED)
    assert state.step == 1
    got_g = [p.grad.numpy() for p in state.params]

    jparams, rebuild, jnames = jinv.split_scene(jscene)
    feats = JFeatures.from_scene(jscene)

    def jloss(p):
        rad, _ = jfp.trace_fast_diff(rebuild(p), jnp.asarray(ro),
                                     jnp.asarray(rd), jnp.asarray(tm), SEED,
                                     DEPTH, feats)
        img = rad.reshape(H, W, S, 3).mean(axis=2)
        return jnp.mean((img - target) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    opt = optax.adam(renderer.learning_rate)
    updates, _ = opt.update(jg, opt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)

    assert names == jnames
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    assert_grads_close(got_g, [np.asarray(g) for g in jg], names, GRAD_TOL,
                       "adam step")
    for name, p0, p, g, jp, jp0 in zip(names, before, state.params, got_g,
                                       jnew, jparams):
        moved = (g != 0) | (np.asarray(jg[names.index(name)]) != 0)
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   np.asarray(jp)[moved], rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(p0.numpy()[~moved],
                                      np.asarray(jp0)[~moved])


@pytest.mark.parametrize("which", ["default", "color"])
def test_train_steps_track_jax(which):
    """The example's problem (``small``; target rendered from the scene,
    texture colours +0.2, clipped), five Adam steps on one fixed set of
    rays and bounce seed, so that the loss changes only with the
    parameters: the port against JAX's ``trace_fast_diff`` +
    ``optax.adam`` step by step. With every default-trainable leaf the
    loss rises in both: the geometry starts at its optimum, its gradients
    are interior-only (no silhouette term), and Adam's first step moves
    every centre, radius, fuzz and index by the learning rate. With the
    colours alone it falls in both. Losses agree to 2e-4 relative and the
    parameters' displacement per leaf to 1e-3 relative L2 (measured: at
    most 7.6e-5 and 4.6e-4). Run with ``-s`` to see both sequences."""
    import optax

    W, H, S, STEPS, LR = 32, 18, 2, 5, 2e-2
    trainable = (tinv.default_trainable if which == "default"
                 else (lambda p: "textures.color" in p))
    jscene, jcam, scene = scene_pair("small", W / H)
    rays = jax_camera_rays(jcam, H * W * S, seed=20)
    jparams, rebuild, names = jinv.split_scene(jscene, trainable)
    feats = JFeatures.from_scene(jscene)

    def jimage(p):
        rad, _ = jfp.trace_fast_diff(rebuild(p), *rays, SEED, DEPTH, feats)
        return rad.reshape(H, W, S, 3).mean(axis=2)

    target = np.asarray(jax.jit(jimage)(jparams))
    jvg = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean((jimage(p) - target) ** 2)))

    def perturb(p, name):
        return p if name != "textures.color" else (p + 0.2).clip(0.0, 1.0)

    jparams = [perturb(p, n) for p, n in zip(jparams, names)]
    start = [np.asarray(p) for p in jparams]
    opt = optax.adam(LR)
    opt_state = opt.init(jparams)
    renderer, state, tnames = tinv.make_inverse_renderer(
        scene, presets.small(W / H)[1], W, H, samples=S, max_depth=DEPTH,
        device="cpu", trainable=trainable, learning_rate=LR)
    assert tnames == names
    with torch.no_grad():
        for p, n in zip(state.params, names):
            p.copy_(perturb(p, n))
    trays = tuple(torch.from_numpy(x) for x in rays)
    jlosses, losses = [], []
    for _ in range(STEPS):
        jl, jg = jvg(jparams)
        updates, opt_state = opt.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state, loss = renderer.step_on(state, torch.from_numpy(target),
                                       trays, SEED)
        jlosses.append(float(jl))
        losses.append(float(loss))
        for n, p, jp, p0 in zip(names, state.params, jparams, start):
            err = rel_l2(p.detach().numpy() - p0, np.asarray(jp) - p0)
            assert err <= 1e-3, f"{n} after step {state.step}: {err:.3e}"
    print(f"\n{which}: JAX {jlosses}\n{which}: port {losses}")
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4)
    rises = which == "default"
    assert (jlosses[-1] > jlosses[0]) == rises, jlosses
    assert (losses[-1] > losses[0]) == rises, losses


def test_keyed_render_and_first_loss_match_jax():
    """The trainer keyed as the reference's: ``render(params, key)`` draws
    the bounce seed ``randint(fold_in(key, 7), (), 0, 2^31 - 1)`` and the
    rays of ``split(key)[0]``, so at ``PRNGKey(0)`` the port's image, its
    first loss (texture colours +0.2 against the unperturbed render) and
    that loss's gradients follow JAX's ``InverseRenderer`` on a one-device
    mesh with the fast path (its padding lanes are born dead): pixels to
    1e-3 except at most 2% of them (a pixel's 2 rays, 0.5% a ray at depth
    4), the loss to 1e-3 relative, every default-trainable leaf within
    ``GRAD_TOL``."""
    from pathtrace_tpu.parallel import mesh as pmesh
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    W, H, S = 16, 12, 2
    jscene, jcam, scene = scene_pair("small", W / H)
    jr, jstate, names = jinv.make_inverse_renderer(
        jscene, jcam, W, H, samples=S, max_depth=DEPTH,
        mesh=pmesh.make_render_mesh(jax.devices()[:1]), use_fast_path=True)
    renderer, state, tnames = tinv.make_inverse_renderer(
        scene, presets.small(W / H)[1], W, H, samples=S, max_depth=DEPTH,
        device="cpu")
    assert tnames == names
    jkey, key = jax.random.PRNGKey(0), PRNGKey(0)
    target = np.asarray(jax.jit(jr.render)(jstate.params, jkey))
    with torch.no_grad():
        img = renderer.render(state.params, key).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    outside = ~lane_close(img, target).all(axis=-1)
    assert outside.mean() <= 0.02, outside.mean()

    def perturb(p, name):
        return p if name != "textures.color" else (p + 0.2).clip(0.0, 1.0)

    jparams = [perturb(p, n) for p, n in zip(jstate.params, names)]
    jloss, jgrads = jax.jit(jax.value_and_grad(jr.loss))(jparams, target,
                                                         jkey)
    with torch.no_grad():
        for p, n in zip(state.params, names):
            p.copy_(perturb(p, n))
    loss = renderer.loss(state.params, torch.from_numpy(target.copy()), key)
    grads = torch.autograd.grad(loss, state.params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-3)
    assert_grads_close([g.numpy() for g in grads],
                       [np.asarray(g) for g in jgrads], names, GRAD_TOL,
                       "first step")


def test_inverse_renderer_refuses_what_is_not_ported():
    """The silhouette term and the general-path fallback are ported: a
    renderer with ``silhouette=True`` builds, and a checker whose child is
    a noise texture trains through the general integrator. What the
    trainer still refuses is the fast path forced on such a scene."""
    scene, cam = presets.small(1.0)
    renderer, _, _ = tinv.make_inverse_renderer(
        scene, cam, 8, 8, device="cpu", silhouette=True)
    assert renderer.silhouette and renderer.use_fast_path
    from pathtrace_tpu_torch.models.build import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(
        b.checker_texture(b.noise_texture(1.0), b.constant_texture((1, 1, 1)))))
    renderer, _, _ = tinv.make_inverse_renderer(b.finish(), cam, 8, 8,
                                                device="cpu")
    assert not renderer.use_fast_path
    with pytest.raises(ValueError, match="not ported yet"):
        tinv.make_inverse_renderer(b.finish(), cam, 8, 8, device="cpu",
                                   use_fast_path=True)


def test_example_trains_on_cpu(tmp_path, capsys):
    from pathtrace_tpu_torch.examples import inverse_render

    out = tmp_path / "inv.npy"
    rc = inverse_render.main(["--device", "cpu", "--steps", "3", "--size",
                              "12", "--samples", "2", "--out", str(out)])
    log = capsys.readouterr().out
    assert rc == 0, log
    losses = [float(x) for x in
              __import__("re").findall(r"loss ([\d.]+), ", log)]
    assert len(losses) == 3 and all(np.isfinite(losses))
    img = np.load(out)
    assert img.shape == (12, 24, 3) and np.isfinite(img).all()
    geo = tmp_path / "geo.npy"
    assert inverse_render.main(["--device", "cpu", "--geometry", "--steps",
                                "1", "--size", "8", "--samples", "1",
                                "--out", str(geo)]) == 0
    assert "['spheres.center', 'textures.color']" in capsys.readouterr().out
    assert np.isfinite(np.load(geo)).all()


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def make_grad_fixture() -> dict:
    """Rays, seed, weights, and JAX's radiance and gradients of
    ``trace_fast_diff`` on random_spheres at depth 4. The weights are
    zero on rays where the port's CPU trace and JAX's differ by more than
    ``FIXTURE_TIGHT``."""
    jscene, jcam, scene = scene_pair("random_spheres", ASPECT)
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=11)
    rad, _, _ = port_trace_diff(scene, ro, rd, tm, SEED, DEPTH)
    w = np.random.default_rng(13).standard_normal((N_RAYS, 3)).astype(np.float32)
    ref_rad, jgrads, names = jax_trace_vjp(jscene, ro, rd, tm, SEED, DEPTH)
    keep = lane_close(rad.detach().numpy(), ref_rad, FIXTURE_TIGHT,
                      FIXTURE_TIGHT).all(axis=1)
    w = w * keep[:, None]
    out = {"rays.ro": ro, "rays.rd": rd, "rays.time": tm, "w": w,
           "radiance": ref_rad, "seed": np.int64(SEED),
           "max_depth": np.int64(DEPTH), "names": np.array(names)}
    out.update({f"grad.{n}": g for n, g in zip(names, jgrads(w))})
    return out


def test_grad_fixture_matches_jax_regeneration():
    ref = np.load(FIXTURE)
    new = make_grad_fixture()
    assert set(ref.files) == set(new), set(ref.files) ^ set(new)
    for key in ("rays.ro", "rays.rd", "rays.time", "seed", "max_depth",
                "names"):
        assert np.array_equal(ref[key], new[key]), key
    # XLA and the port's CPU code may round differently on another host
    assert_lanes_close(new["radiance"], ref["radiance"], what="radiance")
    assert (new["w"] != 0).mean() >= 0.9
    names = list(ref["names"])
    assert_grads_close([new[f"grad.{n}"] for n in names],
                       [ref[f"grad.{n}"] for n in names], names, GRAD_TOL,
                       "regenerated fixture")


def test_port_cpu_grads_hold_fixture():
    ref = np.load(FIXTURE)
    scene, _ = presets.random_spheres(ASPECT)
    rad, params, names = port_trace_diff(scene, ref["rays.ro"], ref["rays.rd"],
                                         ref["rays.time"], int(ref["seed"]),
                                         int(ref["max_depth"]))
    assert names == list(ref["names"])
    assert_lanes_close(rad.detach().numpy(), ref["radiance"], what="radiance")
    got = port_grads(rad, params, ref["w"])
    assert_grads_close(got, [ref[f"grad.{n}"] for n in names], names,
                       FIXTURE_GRAD_TOL, "fixture")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **make_grad_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
