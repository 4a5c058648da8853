"""The box and media sweep's module (``ops/box_media_kernel.py``, the
kernel of ``csrc/box_media_nearest.cu`` on the card) and the turbulence's
(``ops/turb_kernel.py``, ``csrc/turb.cu``), on the CPU against the JAX
package and the port's plain forms.

* The CPU route (the plain [R, N] forms) against the reference's [R, N]
  ``box_nearest`` / ``media_nearest`` on ``final_full`` (400 boxes, 2
  media; camera and scattered rays), ``cornell`` and ``cornell_smoke``:
  idx equal, t within the sweep tests' tolerances
  (``tests/test_torch_boxes.py`` ``COLS_RTOL``, ``tests/test_torch_media.py``
  1e-5).
* The records against the ``Boxes`` / ``Media`` leaves, bit for bit, and
  their widths against the kernel's rows (read from the source).
* The winner's t recomputed at idx (``box_winner_t``, ``media_winner_t``,
  through ``box_media_hits``): bit for bit the [R, N] form's t, per-ray
  gradients bit for bit its gradients, every leaf's within 1e-5 (the
  leaves' sums in another order).
* The turbulence Function: its CPU forward is ``fast_turb_c`` on the
  masked-in lanes bit for bit and 0 on the others; its gradient is
  autograd's through the masked ``fast_turb_c``, and autograd's through
  ``fast_turb_c`` on every masked-in lane.
* ``trace_fast_diff`` of ``torch_port_util.marble_smoke_scene`` (a
  marble box, media): the radiance bit for bit and every box and media
  leaf's gradient within 1e-5 of the route through the [R, N] forms under
  autograd (``plain_box_media_and_turb``).
* Dispatch: a tensor on neither the CPU nor a CUDA device raises.

Card tests of both kernels live in ``tests/test_torch_cuda.py``.
"""

import functools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.ops import intersect as jisect  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import box_media_kernel as bmk  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_box as ib  # noqa: E402
from pathtrace_tpu_torch.ops import turb_kernel  # noqa: E402
from torch_port_util import (  # noqa: E402
    diff_box_media_grads, jax_camera_rays, plain_box_media_and_turb, rel_l2,
)

ASPECT = 16 / 9
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "pathtrace_tpu_torch", "csrc")
# the sweep tests' tolerances against the reference's [R, N] forms, whose
# einsums map the rays in another order (tests/test_torch_boxes.py,
# tests/test_torch_media.py)
BOX_COLS_RTOL = 1e-4
MEDIA_COLS_RTOL = 1e-5
LEAF_RTOL = 1e-5  # a leaf's gradient summed in another order


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX scene, JAX camera, port scene)."""
    kw = {"seed": 0} if name == "final_full" else {}
    jscene, jcam = getattr(jpresets, name)(ASPECT, **kw)
    return jscene, jcam, getattr(presets, name)(ASPECT, **kw)[0]


@functools.lru_cache(maxsize=None)
def _rays(name, kind, n=1024):
    """Camera rays of the scene, or rays scattered from their box hits
    (else 10 units along the ray) in uniform directions, a few with a
    direction component exactly 0."""
    _, jcam, scene = _scene(name)
    ro, rd, _ = jax_camera_rays(jcam, n, seed=4)
    if kind == "camera":
        return ro, rd
    t, _ = ib.box_nearest_rn(scene.boxes, *_t(ro).unbind(1),
                             *_t(rd).unbind(1))
    hit = (t < 1e30).numpy()
    p = ro + np.where(hit, t.numpy(), 10.0)[:, None] * rd
    d = np.random.default_rng(8).normal(size=p.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8, 0] = 0.0
    return p.astype(np.float32), d


def _uniforms(n_rays, n_media, seed=3):
    return np.random.default_rng(seed).random((n_rays, n_media),
                                              dtype=np.float32)


def _operand(scene):
    return bmk.box_media_operand(scene, SceneFeatures.from_scene(scene))


# ---------------------------------------------------------------------------
# the CPU route against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kind", [
    ("final_full", "camera"), ("final_full", "scattered"),
    ("cornell", "camera"), ("cornell_smoke", "camera")])
def test_cpu_route_equals_jax_sweeps(name, kind):
    jscene, _, scene = _scene(name)
    ro, rd = _rays(name, kind)
    op = _operand(scene)
    u = _uniforms(ro.shape[0], scene.media.count)
    rays = torch.cat([_t(ro).T, _t(rd).T]).contiguous()
    plain = bmk.PLAIN_CALLS
    box, med = bmk.box_media_nearest(op, rays, _t(u.T))
    assert bmk.PLAIN_CALLS == plain + 1
    assert (box is not None) == (op.boxes is not None)
    assert (med is not None) == (op.media is not None)
    if box is not None:
        t_ref, i_ref = jisect.box_nearest(jscene.boxes, jnp.asarray(ro),
                                          jnp.asarray(rd))
        np.testing.assert_array_equal(box[1].numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(box[0].numpy(), np.asarray(t_ref),
                                   rtol=BOX_COLS_RTOL)
        assert box[0].dtype == torch.float32 and box[1].dtype == torch.int32
        assert (box[0] < 1e30).any()
    if med is not None:
        t_ref, i_ref = jisect.media_nearest(jscene.media, jnp.asarray(ro),
                                            jnp.asarray(rd), jnp.asarray(u))
        np.testing.assert_array_equal(med[1].numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(med[0].numpy(), np.asarray(t_ref),
                                   rtol=MEDIA_COLS_RTOL)
        assert (med[0] < 1e30).any()


def test_flights_are_the_plain_forms_operations():
    """The [n_media, R] flights the kernel reads equal the [R, N] form's
    ``-log(max(u, 1e-38)) / density`` element for element, bit for bit."""
    _, _, scene = _scene("final_full")
    u = _t(_uniforms(1000, scene.media.count))
    got = bmk.media_flights(scene.media.density, u.T)
    ref = -torch.log(torch.clamp(u, min=1e-38)) / scene.media.density[None]
    assert got.shape == (scene.media.count, 1000) and got.is_contiguous()
    assert torch.equal(got, ref.T)
    assert torch.equal(bmk.media_flights(scene.media.density, list(u.T)),
                       got)


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["final_full", "cornell", "cornell_smoke"])
def test_records_hold_the_leaves(name):
    _, _, scene = _scene(name)
    bx, md = scene.boxes, scene.media
    rb, rm = bmk.pack_boxes(bx), bmk.pack_media(md)
    assert rb.shape == (bx.count, bmk.BOX_W) and rb.is_contiguous()
    assert rm.shape == (md.count, bmk.MEDIA_W) and rm.is_contiguous()
    for rec, prims in ((rb, bx), (rm, md)):
        assert torch.equal(rec[:, :12], prims.obj_from_world.reshape(-1, 12))
        assert torch.equal(rec[:, 12:15], prims.p0)
        assert torch.equal(rec[:, 15:18], prims.p1)
        assert torch.equal(rec[:, 18], prims.mask.float())
    assert torch.equal(rb[:, 19], torch.zeros(bx.count))
    assert torch.equal(rm[:, 19], md.kind.float())
    assert torch.equal(rm[:, 20], md.radius)
    assert torch.equal(rm[:, 21:], torch.zeros(md.count, 3))
    op = bmk.pack_operand(bx, None)
    assert op.media is None and op.media_rec is None
    assert bmk.pack_operand(None, None) is None
    # the scene's operand holds the kinds its features find
    op = _operand(scene)
    assert (op.boxes is bx) == bool(bx.mask.any())
    assert (op.media is md) == bool(md.mask.any())


def test_record_widths_are_the_kernels_rows():
    src = open(os.path.join(CSRC, "box_media_nearest.cu")).read()
    rows = {k: int(v) for k, v in re.findall(
        r"constexpr int (kBoxRows|kMediaRows) = (\d+);", src)}
    assert rows == {"kBoxRows": bmk.BOX_W // 4, "kMediaRows": bmk.MEDIA_W // 4}
    assert "pt_box_media_nearest" in src
    assert "pt_noise_turb" in open(os.path.join(CSRC, "turb.cu")).read()


# ---------------------------------------------------------------------------
# the winner's t where autograd needs it
# ---------------------------------------------------------------------------

def _leaf_copies(prims, names):
    return {n: getattr(prims, n).detach().clone().requires_grad_(True)
            for n in names}


@pytest.mark.parametrize("kind", ["boxes", "media"])
@pytest.mark.parametrize("rays_kind", ["camera", "scattered"])
def test_winner_t_is_the_rn_forms_t_and_gradient(kind, rays_kind):
    """On ``final_full`` (400 boxes; its 2 media, and 24 random ones):
    t at the kernel's idx, recomputed under autograd, equals the [R, N]
    form's t bit for bit; the gradients of a weighted sum of the hits'
    t match the [R, N] form's: per ray bit for bit, per leaf within
    ``LEAF_RTOL``."""
    _, _, scene = _scene("final_full")
    ro_np, rd_np = _rays("final_full", rays_kind)
    names = ["p0", "p1", "obj_from_world"]
    if kind == "media":
        names += ["radius", "density"]
        prims0 = _media_mix(scene)
    else:
        prims0 = scene.boxes
    u = _t(_uniforms(ro_np.shape[0], prims0.count).T)
    w = _t(np.random.default_rng(2).random(ro_np.shape[0],
                                           dtype=np.float32) + 0.5)

    def run(recompute):
        leaves = _leaf_copies(prims0, names)
        prims = prims0.__class__(**{**{f: getattr(prims0, f) for f in
                                       prims0.__dataclass_fields__},
                                    **leaves})
        ro = _t(ro_np).requires_grad_(True)
        rd = _t(rd_np).requires_grad_(True)
        if recompute:
            op = (bmk.pack_operand(prims, None) if kind == "boxes"
                  else bmk.pack_operand(None, prims))
            box, med = bmk.box_media_hits(op, ro, rd, u)
            t, idx = box if kind == "boxes" else med
        else:
            planes = (*ro.unbind(1), *rd.unbind(1))
            t, idx = (ib.box_nearest_rn(prims, *planes) if kind == "boxes"
                      else ib.media_nearest_rn(prims, *planes, u))
        hit = t < 1e30
        loss = (torch.where(hit, t, 0.0) * w).sum()
        grads = torch.autograd.grad(loss, [ro, rd, *leaves.values()])
        return t.detach(), idx, grads, hit

    t_a, i_a, g_a, hit = run(False)
    t_b, i_b, g_b, _ = run(True)
    assert hit.float().mean() > 0.05
    assert torch.equal(i_a, i_b)
    assert t_a.numpy().tobytes() == t_b.numpy().tobytes()
    for name, a, b in zip(["ro", "rd", *names], g_a, g_b):
        if name in ("ro", "rd"):
            assert torch.equal(a, b), name
        else:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=LEAF_RTOL,
                                       atol=1e-6 * float(a.abs().max()),
                                       err_msg=name)
    assert float(g_a[0].abs().sum()) > 0.0


def _media_mix(scene):
    """``final_full``'s 2 media and 24 random slab and sphere media over
    its floor (slabs rotated), the 5th masked."""
    from pathtrace_tpu_torch.models.build import (
        SceneBuilder, affine_from_axis_angle,
    )

    b = SceneBuilder()
    iso = b.constant_texture((0.7, 0.7, 0.7))
    g = np.random.default_rng(6)
    for i in range(24):
        c = g.uniform((-100.0, 0.0, -100.0), (500.0, 300.0, 500.0))
        dens = float(g.uniform(1e-3, 5e-2))
        if i % 3 == 0:
            b.medium_sphere(tuple(c), float(g.uniform(30.0, 100.0)), dens, iso)
        else:
            xf = affine_from_axis_angle(g.normal(size=3),
                                        float(g.uniform(0.0, 90.0)),
                                        g.uniform(-20.0, 20.0, 3))
            b.medium_box(tuple(c - 50.0), tuple(c + 50.0), dens, iso, xf)
    extra = b.finish().media
    mix = extra.__class__(**{
        f: torch.cat([getattr(scene.media, f), getattr(extra, f)])
        for f in extra.__dataclass_fields__})
    mix.mask[6] = False
    return mix


def test_box_media_hits_keeps_the_bits_without_autograd():
    """Without autograd the kernel's (here the plain form's) t comes back
    as it is, and under autograd only the t of a kind whose inputs need a
    gradient is recomputed."""
    _, _, scene = _scene("final_full")
    ro, rd = (_t(x) for x in _rays("final_full", "camera"))
    op = _operand(scene)
    u = _t(_uniforms(ro.shape[0], scene.media.count).T)
    box, med = bmk.box_media_hits(op, ro, rd, u)
    assert not box[0].requires_grad and not med[0].requires_grad
    box_g, med_g = bmk.box_media_hits(op, ro.clone().requires_grad_(True),
                                      rd, u)
    assert box_g[0].requires_grad and med_g[0].requires_grad
    assert torch.equal(box[0], box_g[0].detach())
    assert torch.equal(med[0], med_g[0].detach())
    with torch.no_grad():
        box_n, _ = bmk.box_media_hits(op, ro.clone().requires_grad_(True),
                                      rd, u)
    assert not box_n[0].requires_grad


def test_trace_fast_diff_gradients_are_the_rn_forms():
    dev = torch.device("cpu")
    rad, grads = diff_box_media_grads(dev, size=24)
    with plain_box_media_and_turb():
        rad_p, grads_p = diff_box_media_grads(dev, size=24)
    assert torch.equal(rad, rad_p) and set(grads) == set(grads_p)
    for name, g in grads_p.items():
        assert rel_l2(grads[name].numpy(), g.numpy()) <= LEAF_RTOL, name
    assert float(grads["boxes.p0"].abs().max()) > 0.0
    assert float(grads["media.density"].abs().max()) > 0.0


def test_a_tensor_elsewhere_raises():
    _, _, scene = _scene("cornell")
    op = bmk.pack_operand(scene.boxes, None)
    with pytest.raises(ValueError, match="unsupported device"):
        bmk.box_media_nearest(op, torch.zeros((6, 4), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        turb_kernel.noise_turb(torch.zeros((4, 3), device="meta"),
                               torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match=r"\[6, R\]"):
        bmk.box_media_nearest(op, torch.zeros((3, 4)))


# ---------------------------------------------------------------------------
# the turbulence
# ---------------------------------------------------------------------------

def _turb_points(n=4096, seed=12):
    """Points at the scales ``final_full``'s marble sphere sees (|p| to
    ~600), lattice points, negatives, and a few near 0."""
    g = np.random.default_rng(seed)
    p = g.uniform(-600.0, 600.0, (n, 3)).astype(np.float32)
    p[: n // 8] = np.round(p[: n // 8])
    p[n // 8: n // 4] *= np.float32(1e-3)
    mask = g.random(n) < 0.6
    return _t(p), _t(mask)


def test_turbulence_cpu_forward_is_fast_turb_c_on_the_masked_lanes():
    p, mask = _turb_points()
    plain = turb_kernel.PLAIN_CALLS
    got = turb_kernel.noise_turb(p, mask)
    assert turb_kernel.PLAIN_CALLS == plain + 1
    ref = tfp.fast_turb_c(p[:, 0], p[:, 1], p[:, 2])
    assert got[mask].numpy().tobytes() == ref[mask].numpy().tobytes()
    assert (got[~mask] == 0.0).all() and got.dtype == torch.float32
    assert torch.isfinite(ref).all() and float(ref[mask].abs().max()) > 0.1


def test_turbulence_gradient_is_the_plain_paths():
    p, mask = _turb_points(1024, seed=13)
    g = _t(np.random.default_rng(1).normal(size=1024).astype(np.float32))
    a = p.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad((turb_kernel.noise_turb(a, mask) * g).sum(),
                                a)
    b = p.clone().requires_grad_(True)
    ref = torch.where(mask, tfp.fast_turb_c(b[:, 0], b[:, 1], b[:, 2]), 0.0)
    (gb,) = torch.autograd.grad((ref * g).sum(), b)
    assert torch.equal(ga, gb)
    c = p.clone().requires_grad_(True)
    (gc,) = torch.autograd.grad(
        (tfp.fast_turb_c(c[:, 0], c[:, 1], c[:, 2]) * g).sum(), c)
    assert torch.equal(ga[mask], gc[mask])
    assert (ga[~mask] == 0.0).all() and float(ga[mask].abs().max()) > 0.0


def test_turbulence_backward_counts_and_takes_no_lane_out_of_the_mask():
    """Each backward is counted, and one with no lane masked in gives a
    zero gradient."""
    p, mask = _turb_points(256, seed=14)
    calls = turb_kernel.BWD_PLAIN_CALLS
    for m in (mask, torch.zeros_like(mask)):
        a = p.clone().requires_grad_(True)
        (ga,) = torch.autograd.grad(turb_kernel.noise_turb(a, m).sum(), a)
        assert (ga[~m] == 0.0).all() and ga.shape == p.shape
    assert turb_kernel.BWD_PLAIN_CALLS == calls + 2


def test_turbulence_bound_counts_the_bytes_it_must_move():
    """The mask in and the value out for every lane, the point only for
    a masked-in lane; 1708 operations a masked-in lane."""
    y = turb_kernel.yardsticks(1000, 30)
    assert y["bytes"] == 5 * 1000 + 12 * 30
    assert y["operations"] == 1708 * 30
    assert y["bound_ms"] == max(y["bytes_ms"], y["issue_ceiling_ms"])
