"""The culled closest hit (K4 flat, K5 two-level) and tile-order frames of
the PyTorch port, on the CPU (plain versions). The CUDA kernels against
their plain versions: tests/test_torch_cuda.py.

* The plain K4 and K5 equal the plain K1 bit for bit in (t, idx) on the
  cases of tests/test_pallas.py:88-231 (scattered and axis-parallel rays,
  an uneven supertile, the 4096-sphere grid) at 1, 2 and 4 rays a thread
  (the kernels' skip unit, tests/test_torch_cull_sweep.py), count the
  (ray, live slot) pairs they sweep, and hold K1's contract
  against the JAX package's ``cull="flat"``/``"hier"`` kernels.
* The cull culls: on tile-ordered camera rays of random_spheres_xl the
  plain version's (group, tile) sweep count is far below brute force's,
  and it moves when one tile box changes.
* Tile order: the permutation, the packed gather and the un-permute equal
  the JAX package's.
* End to end: the trace with the cull forced on and off is bit-identical,
  and the port's frame chain (permute, trace, un-permute) on the JAX
  package's rays holds the slice contract against the JAX chain.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.config import MAX_T, MIN_T  # noqa: E402
from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu.ops.intersect_pallas import sphere_nearest_pallas_cols  # noqa: E402
from pathtrace_tpu_torch.camera import get_rays  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, assert_lanes_close, check_slice_contract, numpy_uniforms,
)


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rays6(ro, rd):
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([ro.T, rd.T]).astype(np.float32)))


def _operand(spheres, hier, s_tiles):
    """(soa [5, slots], CullBoxes) of a port Spheres for a given cull."""
    slots = ik.cull_slots(spheres.count, hier, s_tiles)
    soa = tfp.build_sphere_soa(_scene_of(spheres), slots)
    return soa, ik.cull_boxes(spheres.center, spheres.radius, spheres.mask,
                              slots, hier, s_tiles)


def _scene_of(spheres):
    scene, _ = presets.small(1.0)
    return dataclasses.replace(scene, spheres=spheres)


def _cover20():
    return presets._random_impl(16 / 9, True, 0, half_extent=20)


def _grid_spheres(n=4096):
    """The synthetic grid of test_hier_bit_identical_big_scene: 4096
    spheres of radius 0.6 on a jittered 16^3 lattice (32 tiles)."""
    rng = np.random.default_rng(23)
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(16)),
                 -1).reshape(-1, 3)[:n]
    centers = (g * 2.0 + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    b = SceneBuilder()
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    for c in centers:
        b.sphere(c, 0.6, mat)
    ro = rng.uniform(-4, 36, (4096, 3)).astype(np.float32)
    return b.finish().spheres, ro, _unit(rng.normal(size=(4096, 3)))


def _axis_rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = (rng.random((n, 3)) * 22 - 11).astype(np.float32)
    rd = np.zeros((n, 3), np.float32)
    rd[np.arange(n), np.arange(n) % 3] = np.where(np.arange(n) % 2 == 0,
                                                  1.0, -1.0)
    return ro, rd


def _scattered_rays(n, seed, spread):
    rng = np.random.default_rng(seed)
    ro = (rng.random((n, 3)) * spread - spread / 2).astype(np.float32)
    return ro, _unit(rng.normal(size=(n, 3)))


# (rays, cull, s_tiles): the cases of tests/test_pallas.py:88-231
BRUTE_CASES = {
    "scattered-flat": ("scattered", False, 1),
    "axis-flat": ("axis", False, 1),
    "scattered-hier": ("scattered", True, 2),
    "axis-hier": ("axis", True, 2),
    "uneven-supertile": ("uneven", True, 3),   # 4 tiles in supertiles of 3
    "grid-4096": ("grid", True, 2),            # 32 tiles, 16 supertiles
}


# each case at one ray a thread (the unit the launcher picks at these
# widths), then at 2 and 4 rays a thread: a warp of 64 or 128 rays
CULL_UNITS = [pytest.param(case, k, id=case if k == 1 else f"{case}-k{k}")
              for case in BRUTE_CASES for k in (1, 2, 4)]


@pytest.mark.parametrize("case, k_rays", CULL_UNITS)
def test_plain_culls_equal_plain_k1(case, k_rays):
    rays, hier, s_tiles = BRUTE_CASES[case]
    if rays == "grid":
        spheres, ro, rd = _grid_spheres()
    else:
        spheres = presets.random_spheres(1.0)[0].spheres
        ro, rd = {"scattered": lambda: _scattered_rays(2048, 11, 24.0),
                  "axis": lambda: _axis_rays(512, 3),
                  "uneven": lambda: _scattered_rays(1024, 19, 18.0)}[rays]()
    soa, cull = _operand(spheres, hier, s_tiles)
    assert (cull.supers is not None) == hier
    rays6 = _rays6(ro, rd)
    t, idx = ik.sphere_nearest_plain(soa, rays6)
    t_c, idx_c, sweeps, _, _ = ik.sphere_nearest_culled_plain(
        soa, rays6, cull, k_rays=k_rays)
    assert (t < 1e30).float().mean() > 0.05
    assert torch.equal(t_c, t) and torch.equal(idx_c, idx)
    # the units holding a ray (cull_groups: the kernel's indexing)
    units = int((ik.cull_groups(rays6.shape[1], k_rays)
                 < rays6.shape[1]).any(dim=1).sum())
    # scattered rays over random_spheres' ground tile: a unit of 64 or
    # 128 of them may want every tile
    assert 0 < int(sweeps) <= units * cull.tiles.shape[1]
    if k_rays == 1:
        assert int(sweeps) < units * cull.tiles.shape[1]


@pytest.mark.parametrize("k_rays", [1, 2, 4])
def test_slots_count_the_pairs_swept(k_rays):
    """The pair count by hand: one tile of 100 live spheres in 128 slots
    and 96 rays, of which only rays 0-31 look at the tile. At every unit
    one sweep runs, and it counts its rays below R (32, however many the
    unit holds) times the live slots."""
    b = SceneBuilder()
    mat = b.lambertian_color((0.5, 0.5, 0.5))
    rng = np.random.default_rng(4)
    for c in rng.uniform(-2.0, 2.0, (100, 3)):
        b.sphere((float(c[0]), float(c[1]), float(c[2]) - 10.0), 0.3, mat)
    soa, cull = _operand(b.finish().spheres, False, 1)
    assert cull.tiles.shape[1] == 1 and int((soa[4] > 0).sum()) == 100
    R = 96
    rd = _unit(rng.normal(size=(R, 3)) * 0.05 + np.array([0.0, 0.0, 1.0]))
    rd[:32, 2] *= -1.0  # towards the spheres
    rays = _rays6(np.zeros((R, 3), np.float32), rd)
    res = ik.sphere_nearest_culled_plain(soa, rays, cull, k_rays=k_rays)
    assert (res.t[:32] < 1e30).any() and not (res.t[32:] < 1e30).any()
    assert int(res.sweeps) == 1
    assert int(res.slots) == 32 * 100
    assert int(res.tests) == R


def test_boxes_equal_the_reference_formula():
    """The tile and supertile boxes of ``intersect_pallas.py:518-549``,
    evaluated in numpy float32 on the xl scene padded to supertiles."""
    sp = presets.random_spheres_xl(1.0)[0].spheres
    hier, s_tiles = ik.cull_mode((sp.count + 127) // 128)
    assert (hier, s_tiles) == (True, 16)
    slots = ik.cull_slots(sp.count, hier, s_tiles)
    assert slots == 6144
    cull = ik.cull_boxes(sp.center, sp.radius, sp.mask, slots, hier, s_tiles)
    c, r, m = sp.center.numpy(), np.abs(sp.radius.numpy()), sp.mask.numpy()
    f = np.float32
    pad = np.full((slots - c.shape[0], 3), f(MAX_T))
    lo = np.concatenate([np.where(m[:, None], c - r[:, None], f(MAX_T)), pad])
    hi = np.concatenate([np.where(m[:, None], c + r[:, None], f(-MAX_T)), -pad])
    lo_t = lo.T.reshape(3, -1, 128).min(axis=2) - f(1e-3)
    hi_t = hi.T.reshape(3, -1, 128).max(axis=2) + f(1e-3)
    np.testing.assert_array_equal(cull.tiles.numpy(), np.concatenate([lo_t, hi_t]))
    sup = np.concatenate([lo_t.reshape(3, -1, 16).min(axis=2),
                          hi_t.reshape(3, -1, 16).max(axis=2)])
    np.testing.assert_array_equal(cull.supers.numpy(), sup)
    # 33 tiles hold spheres; the 15 padding tiles are inverted (empty)
    assert (cull.tiles[0] <= cull.tiles[3]).sum().item() == 33
    # the reference's slab test turns an inverted box into (-inf, inf)
    # for every ray off the axes, so the kernels skip empty tiles first
    ro, rd = _scattered_rays(256, 1, 10.0)
    d = torch.from_numpy(rd).T
    want = ik._box_want(cull.tiles, 40, torch.from_numpy(ro).T, 1.0 / d,
                        d.abs() <= 1e-12, torch.full((256,), MAX_T), MIN_T,
                        MAX_T)
    assert bool(want.all())


def _cover20_rays(kind, n=1000):
    """Camera rays of the half_extent=20 cover scene, or once-scattered
    rays (a Lambertian direction from each camera hit), in numpy."""
    scene, cam = _cover20()
    s, t, u = numpy_uniforms(n, seed=5)
    ro, rd, _ = (x.numpy() for x in get_rays(
        cam, torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(u)))
    if kind == "scattered":
        tt, idx = ik.sphere_nearest_plain(tfp.build_sphere_soa(scene),
                                          _rays6(ro, rd))
        tt, idx = tt.numpy(), idx.numpy()
        hit = tt < 1e30
        ro = (ro + np.where(hit, tt, 0.0)[:, None] * rd).astype(np.float32)
        c = scene.spheres.center.numpy()[idx]
        r = scene.spheres.radius.numpy()[idx]
        u3 = _unit(np.random.default_rng(6).normal(size=(n, 3)))
        rd = _unit(np.where(hit[:, None], (ro - c) / r[:, None] + u3, u3))
    return ro, rd


@pytest.mark.parametrize("cull", ["flat", "hier"])
@pytest.mark.parametrize("rays", ["camera", "scattered"])
def test_plain_culls_match_pallas(cull, rays):
    """Against ``sphere_nearest_pallas_cols(..., cull=...)`` (Pallas in
    interpret mode) under K1's contract with XLA (test_torch_kernels.py,
    test_plain_matches_pallas_cover_scene)."""
    ro, rd = _cover20_rays(rays)
    jscene, _ = jpresets._random_impl(16 / 9, True, 0, half_extent=20)
    t_ref, i_ref = sphere_nearest_pallas_cols(
        jscene.spheres, *(jnp.asarray(c) for c in (*ro.T, *rd.T)),
        jnp.zeros(ro.shape[0], jnp.float32), MIN_T, MAX_T,
        has_motion=False, cull=cull, s_tiles=4)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    hier = cull == "hier"
    soa, boxes = _operand(_cover20()[0].spheres, hier, 4)
    t, idx, _ = ik.sphere_nearest_culled(soa, _rays6(ro, rd), boxes,
                                         count_sweeps=False)
    t, idx = t.numpy(), idx.numpy()
    assert (t_ref < 1e30).mean() > 0.3
    assert ((t < 1e30) == (t_ref < 1e30)).mean() >= 0.995
    assert_lanes_close(t, t_ref, rtol=1e-3, atol=0.0, what="t")
    assert (idx == i_ref).mean() >= 0.995


def _xl_tile_rays():
    """Camera rays of the first 64x64 pixel tile of a 1280x720 film of
    random_spheres_xl, in tile order (one sample per pixel)."""
    scene, cam = presets.random_spheres_xl(1280 / 720)
    rng = np.random.default_rng(8)
    y, x = (a.reshape(-1).astype(np.float32) for a in np.mgrid[0:64, 0:64])
    s = (x + rng.random(4096, dtype=np.float32)) / np.float32(1280)
    t = (y + rng.random(4096, dtype=np.float32)) / np.float32(720)
    u = rng.random((4096, 3), dtype=np.float32)
    ro, rd, _ = get_rays(cam, torch.from_numpy(s), torch.from_numpy(t),
                         torch.from_numpy(u))
    return scene, torch.cat([ro.T, rd.T]).contiguous()


def test_cull_culls():
    scene, rays = _xl_tile_rays()
    tables = tfp.prep_tables(scene, SceneFeatures.from_scene(scene), cull=True)
    cull = tables.cull
    assert cull.supers is not None and cull.s_tiles == 16
    t, idx = ik.sphere_nearest_plain(tables.soa, rays)
    t_c, idx_c, sweeps, tests, _ = ik.sphere_nearest_culled_plain(
        tables.soa, rays, cull)
    assert torch.equal(t_c, t) and torch.equal(idx_c, idx)
    groups = rays.shape[1] // 32
    brute = groups * cull.tiles.shape[1]
    # measured: 256 of 6144 (group, tile) sweeps
    assert 0 < int(sweeps) < brute // 10, (int(sweeps), brute)
    assert int(tests) < rays.shape[1] * cull.tiles.shape[1]
    # the count is live: a swept tile's box cut down to its lowest corner
    # stops the rays that hit that tile's spheres from sweeping it
    k = int(idx[t < 1e30][0]) // 128
    tiles = cull.tiles.clone()
    tiles[3:, k] = tiles[:3, k]
    _, _, cut, _, _ = ik.sphere_nearest_culled_plain(
        tables.soa, rays, cull._replace(tiles=tiles))
    assert int(cut) < int(sweeps)


@pytest.mark.parametrize("name, hw, tiled", [
    ("random_spheres", (720, 1280), False),    # 4 tiles: raster order, K1
    ("random_spheres_xl", (720, 1280), True),  # 33 tiles: tile order, K5
    ("random_spheres_xl", (63, 1280), False),  # the film holds no tile
])
def test_tile_layout_rule(name, hw, tiled):
    scene, _ = presets.from_name(name, 16 / 9)
    feats = SceneFeatures.from_scene(scene)
    assert tfp.tile_layout(scene, feats, *hw) == tiled
    assert tfp.cull_scene(scene, feats) == (name == "random_spheres_xl")
    jscene, _ = jpresets.from_name(name, 16 / 9)
    n_tiles = (jscene.spheres.center.shape[0] + 127) // 128
    assert (n_tiles >= jfp.CULL_MIN_TILES) == (name == "random_spheres_xl")


@pytest.mark.parametrize("hw", [(720, 1280), (64, 64), (100, 130)])
def test_tile_perm_matches_jax(hw):
    order, inv = tfp._tile_perm_np(*hw)
    j_order, j_inv = jfp._tile_perm_np(*hw)
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(inv, j_inv)
    assert order.dtype == j_order.dtype == np.int32


def test_permute_and_unpermute_match_jax():
    H, W, S = 72, 130, 3
    R = H * W * S
    rng = np.random.default_rng(9)
    ro, rd = (rng.normal(size=(R, 3)).astype(np.float32) for _ in range(2))
    tm = rng.random(R, dtype=np.float32)
    order, inv = tfp._tile_perm_np(H, W)
    ref = jfp._permute_rays_jit(jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(tm), jnp.asarray(order), S)
    got = tfp.permute_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                           torch.from_numpy(tm),
                           torch.from_numpy(order).long(), S)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    rad = rng.random((R, 3), dtype=np.float32)
    ref_img = jfp._unpermute_image_jit(jnp.asarray(rad), jnp.asarray(inv),
                                       H, W, S)
    img = tfp.unpermute_image(torch.from_numpy(rad),
                              torch.from_numpy(inv).long(), H, W, S)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=0,
                               atol=1e-6)


def _cover_camera_rays(n):
    scene, cam = presets.random_spheres(16 / 9)
    s, t, u = numpy_uniforms(n, seed=4)
    ro, rd, tm = get_rays(cam, torch.from_numpy(s), torch.from_numpy(t),
                          torch.from_numpy(u))
    return scene, ro, rd, tm


@pytest.mark.parametrize("cull", ["flat", "hier"])
def test_trace_cull_on_off_bit_identical(cull, monkeypatch):
    """tests/test_fastpath.py:196-210 on the port: random_spheres (4
    tiles) traced with the cull forced on (``CULL_MIN_TILES`` 1; ``hier``
    also takes supertiles of 2 tiles) and off (10 000)."""
    scene, ro, rd, tm = _cover_camera_rays(4096)
    feats = SceneFeatures.from_scene(scene)
    if cull == "hier":
        monkeypatch.setattr(ik, "SUPER_TILES", 2)
    calls = (ik.PLAIN_CALLS, ik.FLAT_PLAIN_CALLS, ik.HIER_PLAIN_CALLS)
    monkeypatch.setattr(tfp, "CULL_MIN_TILES", 1)
    a = tfp.trace_fast(scene, ro, rd, tm, 5, 8, feats)
    on = (ik.PLAIN_CALLS, ik.FLAT_PLAIN_CALLS, ik.HIER_PLAIN_CALLS)
    monkeypatch.setattr(tfp, "CULL_MIN_TILES", 10_000)
    b = tfp.trace_fast(scene, ro, rd, tm, 5, 8, feats)
    off = (ik.PLAIN_CALLS, ik.FLAT_PLAIN_CALLS, ik.HIER_PLAIN_CALLS)
    assert torch.equal(a.radiance, b.radiance)
    assert int(a.ray_count) == int(b.ray_count)
    k = 2 if cull == "hier" else 1
    assert on[0] == calls[0] and on[k] > calls[k]   # every bounce culled
    assert off[0] > on[0] and off[1:] == on[1:]


def test_frame_chain_matches_jax():
    """The port's ``trace_frame`` (tile permutation, trace, un-permute,
    sample mean) on the JAX package's camera rays of the half_extent=20
    cover scene (13 tiles: tile order and the flat cull), against the JAX
    chain ``_permute_rays_jit`` -> ``trace_fast`` -> ``_unpermute_image_jit``
    on the same rays, at 64x64, 1 spp, depth 10 (the render path's depth,
    under its 1% budget: measured 0.68%)."""
    W = H = 64
    S, depth, seed = 1, 10, 7
    jscene, jcam = jpresets._random_impl(1.0, True, 0, half_extent=20)
    scene, _ = presets._random_impl(1.0, True, 0, half_extent=20)
    feats = SceneFeatures.from_scene(scene)
    assert tfp.tile_layout(scene, feats, H, W)
    from pathtrace_tpu.camera import get_rays as jget_rays

    rng = np.random.default_rng(12)
    y, x = (a.reshape(-1).astype(np.float32) for a in np.mgrid[0:H, 0:W])
    s = (x + rng.random(H * W, dtype=np.float32)) / np.float32(W)
    t = (y + rng.random(H * W, dtype=np.float32)) / np.float32(H)
    u = rng.random((H * W, 3), dtype=np.float32)
    ro, rd, tm = jget_rays(jcam, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u))
    order, inv = jfp._tile_perm_np(H, W)
    pro, prd, ptm = jfp._permute_rays_jit(ro, rd, tm, jnp.asarray(order), S)
    rad, count = jfp.trace_fast(jscene, pro, prd, ptm, seed, depth,
                                JFeatures.from_scene(jscene))
    ref = np.asarray(jfp._unpermute_image_jit(rad, jnp.asarray(inv), H, W, S))
    calls = ik.FLAT_PLAIN_CALLS
    res = tfp.trace_frame(scene, *(torch.from_numpy(np.array(a))
                                   for a in (ro, rd, tm)),
                          W, H, S, depth, seed, feats)
    assert ik.FLAT_PLAIN_CALLS > calls
    assert res.image.shape == (H, W, 3)
    check_slice_contract(res.image.numpy().reshape(-1, 3), res.ray_count,
                         ref.reshape(-1, 3), int(count), depth,
                         budget=DEPTH10_BUDGET)
