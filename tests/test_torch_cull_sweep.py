"""The culled closest hit's skip unit (csrc/sphere_nearest_culled.cu, K4
and K5), held on the CPU with the plain version.

The kernels give each thread kRays rays (K4 2 or 1 by the launcher's
rule, K5 1), so a warp, the unit that skips a tile, holds 32 x kRays
rays. ``sphere_nearest_culled_plain`` groups the rays as the kernel does
(``cull_groups``, at any kRays: 1, 2 and 4 are held here) and counts the
sweeps at that unit and the (ray, live slot) pairs they sweep. Here:

- ``cull_groups`` maps rays exactly as the kernel's indexing does (block
  ``b``, thread ``x``, ray ``k``: ray ``b * 256 * kRays + k * 256 + x``,
  unit ``8 b + x // 32``);
- a coarser unit never sweeps fewer pairs than a finer one on the same
  rays, and its sweeps cover the finer one's;
- the launcher's rule, mirrored in ``culled_rays_per_thread``, switches
  where its source says, and the plain version's default unit follows it;
- the culls' yardstick (``tools/nearest_bench.cull_yardsticks``) counts
  the pairs swept and the box tests at the fixed 32-ray unit, and the
  profiler names both kernels.

The plain culls' equality with the plain K1 at every kRays, and a pair
count by hand, are in tests/test_torch_cull.py. The card tests of tests/test_torch_cuda.py hold the kernels themselves to
the plain version at every instance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.camera import get_rays  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from pathtrace_tpu_torch.ops import shade_kernel  # noqa: E402
from pathtrace_tpu_torch.tools import nearest_bench, profile_step  # noqa: E402

K_RAYS = (1, 2, 4)


def _tile_rays(scene, cam, n_side=64, seed=8):
    """Camera rays of the first ``n_side`` x ``n_side`` pixel tile of a
    1280x720 film, one sample a pixel, in tile order."""
    rng = np.random.default_rng(seed)
    y, x = (a.reshape(-1).astype(np.float32)
            for a in np.mgrid[0:n_side, 0:n_side])
    n = n_side * n_side
    s = (x + rng.random(n, dtype=np.float32)) / np.float32(1280)
    t = (y + rng.random(n, dtype=np.float32)) / np.float32(720)
    u = rng.random((n, 3), dtype=np.float32)
    ro, rd, tm = get_rays(cam, torch.from_numpy(s), torch.from_numpy(t),
                          torch.from_numpy(u))
    return tfp.make_state(ro, rd, tm)


@pytest.fixture(scope="module")
def culled_scenes():
    """(tables, camera-ray state) of the 13-tile cover scene (K4) and of
    random_spheres_xl (K5)."""
    out = {}
    for name in ("cover20", "xl"):
        if name == "cover20":
            scene, cam = presets._random_impl(1280 / 720, True, 0,
                                              half_extent=20)
        else:
            scene, cam = presets.random_spheres_xl(1280 / 720)
        feats = SceneFeatures.from_scene(scene)
        tables = tfp.prep_tables(scene, feats, cull=True)
        assert (tables.cull.supers is not None) == (name == "xl")
        out[name] = (tables, tfp.feature_flags(feats), _tile_rays(scene, cam))
    return out


def _ray_sets(culled_scenes, name):
    """Camera rays and once-scattered rays (plain K2 from the camera
    rays' winners) of one scene."""
    tables, flags, st = culled_scenes[name]
    t, idx = ik.sphere_nearest_plain(tables.soa, st.planes[:6])
    planes, _ = shade_kernel.shade_from_winners_plain(
        tables.table, idx, t, st.planes, st.time, st.alive, st.lane, 7, 0,
        10, tables.sky4, flags)
    return tables, {"camera": st.planes[:6].contiguous(),
                    "scattered": planes[:6].contiguous()}


@pytest.mark.parametrize("k_rays", K_RAYS)
@pytest.mark.parametrize("n_rays", [1, 255, 256, 3000, 4096])
def test_cull_groups_map_rays_as_the_kernel(n_rays, k_rays):
    """Row g of ``cull_groups`` is the rays of warp g % 8 of block g // 8,
    lane by lane, with the kernel's indexing written out."""
    threads = ik.CULL_THREADS
    blocks = -(-n_rays // (threads * k_rays))
    want = np.empty((blocks * threads // 32, 32 * k_rays), np.int64)
    for b in range(blocks):
        for x in range(threads):
            for k in range(k_rays):
                i = b * threads * k_rays + k * threads + x  # first + k * kThreads
                want[b * (threads // 32) + x // 32, k * 32 + x % 32] = i
    got = ik.cull_groups(n_rays, k_rays)
    np.testing.assert_array_equal(got.numpy(), want)
    # every ray below n_rays in exactly one unit
    flat = got.reshape(-1)
    assert torch.equal(torch.sort(flat[flat < n_rays])[0],
                       torch.arange(n_rays))


@pytest.mark.parametrize("rays", ["camera", "scattered"])
@pytest.mark.parametrize("name", ["cover20", "xl"])
def test_coarser_unit_sweeps_no_fewer_pairs(culled_scenes, name, rays):
    """On the same rays: equal (t, idx) at every unit, each coarser unit's
    pairs swept at least the finer one's, and a unit of 32 x 2k rays
    sweeping a tile whenever one of its two halves (units of 32 x k rays
    of the same block) does: more sweeps at the finer unit, at most
    twice as many."""
    tables, sets = _ray_sets(culled_scenes, name)
    r = sets[rays]
    res = {k: ik.sphere_nearest_culled_plain(tables.soa, r, tables.cull,
                                             k_rays=k) for k in K_RAYS}
    for k in K_RAYS:
        assert torch.equal(res[k].t, res[1].t)
        assert torch.equal(res[k].idx, res[1].idx)
    slots = [int(res[k].slots) for k in K_RAYS]
    sweeps = [int(res[k].sweeps) for k in K_RAYS]
    assert 0 < slots[0] <= slots[1] <= slots[2], slots
    assert sweeps[0] >= sweeps[1] >= sweeps[2] > 0, sweeps
    assert sweeps[0] <= 2 * sweeps[1] and sweeps[1] <= 2 * sweeps[2], sweeps
    live = int((tables.soa[4] > 0).sum())
    assert slots[2] < r.shape[1] * live  # the cull still culls


# the ladder's widths on the 1280x720, 4 spp frames of both culled scenes
# (3,686,400 rays, then the compaction's rungs) and the rays a thread that
# ran fastest there on the H100 (PERF.md): K4 2 down to 262,144 rays, then
# 1; K5 1 throughout
LADDER = {3_686_400: 2, 1_048_576: 2, 524_288: 2, 262_144: 2, 131_072: 1,
          65_536: 1}


@pytest.mark.parametrize("n_sm", [132, 114, 66, 1])
def test_launcher_rule_band_edges(n_sm):
    """The mirror of the launcher's rule: K4 switches from 1 to 2 rays a
    thread where every SM gets 3 blocks of 512 rays (202,752 rays on 132
    SMs); K5 keeps 1; every pick is an instance the source compiles."""
    rule = ik.culled_rays_per_thread
    edge = 3 * n_sm * ik.CULL_THREADS * 2
    assert rule(edge - 1, False, n_sm) == 1
    assert rule(edge, False, n_sm) == 2
    assert rule(1, False, n_sm) == 1
    assert rule(1 << 30, False, n_sm) == 2
    for w in (1, edge - 1, edge, 3_686_400, 1 << 30):
        assert rule(w, True, n_sm) == 1
    # the instances csrc/sphere_nearest_culled.cu compiles: <false, 2>,
    # <false, 1>, <true, 1>
    for hier, instances in ((False, {1, 2}), (True, {1})):
        picks = {rule(w, hier, n_sm) for w in (1, edge - 1, edge, 1 << 30)}
        assert picks == instances
    if n_sm == ik.H100_SMS:
        assert edge == 202_752
        assert {w: rule(w, False, n_sm) for w in LADDER} == LADDER
        assert all(rule(w, True, n_sm) == 1 for w in LADDER)


def test_plain_default_unit_follows_the_rule(culled_scenes, monkeypatch):
    """Off the card the plain version and the wrapper take the rule for
    ``H100_SMS`` SMs: with the edge moved below the 4,096 camera rays (1
    SM), K4's plain version and wrapper count sweeps at 2 rays a thread;
    K5's at 1."""
    for name in ("cover20", "xl"):
        tables, _, st = culled_scenes[name]
        rays = st.planes[:6].contiguous()
        hier = name == "xl"
        at = {k: ik.sphere_nearest_culled_plain(tables.soa, rays, tables.cull,
                                                k_rays=k) for k in (1, 2)}
        assert int(at[2].sweeps) < int(at[1].sweeps)
        for n_sm, want in ((ik.H100_SMS, 1), (1, 1 if hier else 2)):
            monkeypatch.setattr(ik, "H100_SMS", n_sm)
            res = ik.sphere_nearest_culled_plain(tables.soa, rays, tables.cull)
            assert int(res.sweeps) == int(at[want].sweeps), (name, n_sm)
            assert int(res.slots) == int(at[want].slots), (name, n_sm)
            _, _, sweeps = ik.sphere_nearest_culled(tables.soa, rays,
                                                    tables.cull,
                                                    count_sweeps=True)
            assert int(sweeps) == int(at[want].sweeps), (name, n_sm)


def test_cull_yardsticks_count_pairs_and_box_tests(culled_scenes,
                                                   monkeypatch):
    """The culls' yardstick counts 16 operations a (ray, live slot) pair
    swept and 30 a ray-box test, both at the 32-ray warp whatever unit
    the kernel takes, against 32 bytes a ray and the operand and boxes
    once; its issue ceiling is twice its operation bound."""
    for name in ("cover20", "xl"):
        tables, _, st = culled_scenes[name]
        rays = st.planes[:6].contiguous()
        at1 = ik.sphere_nearest_culled_plain(tables.soa, rays, tables.cull,
                                             k_rays=1)
        R, slots, tests = rays.shape[1], int(at1.slots), int(at1.tests)
        got = nearest_bench.cull_yardsticks(tables.soa, tables.cull, rays)
        assert (got["slots_swept"], got["box_tests"]) == (slots, tests)
        ops = 16 * slots + 30 * tests
        nbytes = R * 32 + sum(b.numel() * 4 for b in (
            tables.soa, tables.cull.tiles, tables.cull.supers) if b is not None)
        assert got["bound_by"] == "operations"
        assert got["bound_ms"] == pytest.approx(ops / 67e12 * 1e3, rel=1e-12)
        assert got["issue_ceiling_ms"] == pytest.approx(2 * got["bound_ms"],
                                                        rel=1e-12)
        assert nbytes / 3.35e12 * 1e3 < got["bound_ms"]
    # the kernel's unit does not move it: with K4's edge below these
    # 4,096 scattered rays (1 SM) the plain default sweeps more pairs,
    # the yardstick counts the same
    tables, sets = _ray_sets(culled_scenes, "cover20")
    rays = sets["scattered"]
    before = nearest_bench.cull_yardsticks(tables.soa, tables.cull, rays)
    monkeypatch.setattr(ik, "H100_SMS", 1)
    coarse = ik.sphere_nearest_culled_plain(tables.soa, rays, tables.cull)
    assert int(coarse.slots) > before["slots_swept"]
    assert nearest_bench.cull_yardsticks(tables.soa, tables.cull,
                                         rays) == before
    # with no ray the bytes bound it
    empty = nearest_bench.cull_yardsticks(tables.soa, tables.cull, rays[:, :0])
    assert empty["bound_by"] == "bytes" and empty["slots_swept"] == 0


def test_profiler_names_the_culled_instances():
    """``profile_step`` sorts every (kHier, kRays) instance to K4 or K5."""
    name = ("void (anonymous namespace)::sphere_nearest_culled_kernel<{}, {}>"
            "(float const*, long long)")
    for k in (1, 2, 4):
        assert profile_step._kind(name.format("false", k)).startswith("K4")
        assert profile_step._kind(name.format("true", k)).startswith("K5")
