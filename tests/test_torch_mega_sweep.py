"""K7's resident scene, on the CPU: the rows ``prep_tables`` keeps for the
megakernel's shared memory, its sweep over them against the plain sweep
over every row, the shared-memory rule that refuses a scene too large, and
the yardsticks and lane-pass count ``tools/nearest_bench.py`` gives K7.

K7 (``csrc/megakernel.cu``) keeps resident every sphere row whose
geometry differs from all rows before it, static rows apart from moving
ones, and sweeps them in the kernel's arithmetic (|c|^2 and r^2 taken per
row; the least t, and on equal t the lowest row).
``megakernel.resident_sweep_plain`` is that sweep in plain PyTorch; it must
pick what ``megakernel._sphere_sweep`` picks over all rows, bit for bit, on
camera and scattered rays, with dead rows between live ones, on a ray that
hits a dead row (so one dead row stays resident), and on rays whose time
is not finite.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.config import MAX_T  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from pathtrace_tpu_torch.render.frame import generate_primary_rays  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from pathtrace_tpu_torch.tools import nearest_bench as nb  # noqa: E402

MISS_ROW = 2 ** 31 - 1


def _scene(name):
    """A preset, or ``interleaved``: ``random`` with dead spheres between
    live ones."""
    scene, cam = presets.from_name("random" if name == "interleaved" else name,
                                   16 / 9)
    if name == "interleaved":
        scene.spheres.mask[torch.arange(3, 480, 5)] = False
    return scene, cam


def _rays(cam, n_side=48, seed=0):
    n = n_side * n_side
    return tuple(x.reshape(n, -1).squeeze(-1) for x in
                 generate_primary_rays(cam, n_side, n_side, 1, PRNGKey(seed)))


@pytest.mark.parametrize("name", ["random_spheres", "random", "simple_light",
                                  "interleaved"])
def test_resident_rows_are_live_rows_and_one_dead_row(name):
    """The resident sphere rows are the live spheres and the first dead
    row, static ones first and then moving ones, each in increasing index,
    and they hold the live spheres' geometry; the rect rows are the live
    rects and the first of each kind of dead row."""
    scene, _ = _scene(name)
    tables = mk.prep_tables(scene)
    sp = scene.spheres
    live = torch.nonzero(sp.mask).flatten()
    rows = tables.sphere_rows.long()
    first_dead = int(torch.nonzero(~sp.mask).flatten()[0]) if not bool(
        sp.mask.all()) else sp.count
    assert sorted(rows.tolist()) == sorted(live.tolist() + [first_dead])
    n_s = tables.n_static
    for part in (rows[:n_s], rows[n_s:]):
        assert bool((part[1:] > part[:-1]).all())
    fixed = mk.static_rows(tables.spheres)
    assert bool(fixed[rows[:n_s]].all()) and not bool(fixed[rows[n_s:]].any())
    order = torch.sort(rows).values
    geo = tables.spheres.index_select(0, order[order != first_dead])
    assert torch.equal(geo[:, 0:3], sp.center[live])
    assert torch.equal(geo[:, 8], sp.radius[live])
    assert torch.equal(geo[:, 3:6], sp.center_delta[live])
    if name == "random_spheres":
        assert n_s == rows.shape[0] == 489
    if name == "random":
        assert (n_s, rows.shape[0]) == (98, 489)
    rc = scene.rects
    want = torch.nonzero(rc.mask).flatten().tolist()
    if name == "simple_light":
        assert rc.count == 1 and want == [0]
    assert tables.rect_rows.tolist()[:len(want)] == want
    assert tables.rect_rows.shape[0] <= len(want) + 2


@pytest.mark.parametrize("name", ["random_spheres", "random", "simple_light",
                                  "interleaved"])
def test_resident_sweep_equals_sweep_over_every_row(name):
    """Camera rays and rays off their first hit (a Lambertian-like bounce
    about the normal, unit length): the resident sweep's t equals the
    sweep over all rows bit for bit, and its row where a sphere is hit."""
    scene, cam = _scene(name)
    motion = SceneFeatures.from_scene(scene).has_motion
    tables = mk.prep_tables(scene)
    ro, rd, tm = _rays(cam)
    t, idx = mk._sphere_sweep(tables.spheres, ro, rd, tm, motion)
    hit = t < MAX_T
    rng = np.random.default_rng(1)
    p = ro + torch.where(hit, t, 0.0)[:, None] * rd
    n = p - tables.spheres[idx, 0:3]
    n = n / n.norm(dim=1, keepdim=True)
    d2 = n + torch.from_numpy(rng.normal(size=n.shape).astype(np.float32))
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    for o, d in ((ro, rd), (p[hit], d2[hit])):
        tt = tm[:o.shape[0]]
        t_all, i_all = mk._sphere_sweep(tables.spheres, o, d, tt, motion)
        t_res, i_res = mk.resident_sweep_plain(tables, o, d, tt, motion)
        assert torch.equal(t_all, t_res)
        h = t_all < MAX_T
        assert bool(h.any()) and torch.equal(i_all[h], i_res[h])
        assert bool((i_res[~h] == MISS_ROW).all())


def test_a_dead_row_can_win_so_one_stays_resident():
    """A direction a rounding longer than 1 along +x (as rsqrt may leave
    it) hits the dead row at cx = 1e18 at t ~ 1e18 in the plain sweep, and
    in the resident one, which keeps the first dead row; a sweep of the
    live rows alone would miss. Exactly unit directions miss."""
    scene, _ = _scene("random_spheres")
    tables = mk.prep_tables(scene)
    up = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    o = torch.tensor([[0.0, 5.0, 0.0], [0.0, 5.0, 0.0], [3.0, 7.0, 1.0]])
    d = torch.tensor([[up, 0.0, 0.0], [1.0, 0.0, 0.0], [up, 0.0, 0.0]])
    tm = torch.zeros(3)
    t_all, i_all = mk._sphere_sweep(tables.spheres, o, d, tm, False)
    t_res, i_res = mk.resident_sweep_plain(tables, o, d, tm, False)
    dead = int(torch.nonzero(~scene.spheres.mask).flatten()[0]) if not bool(
        scene.spheres.mask.all()) else scene.spheres.count
    assert i_all.tolist() == [dead, 0, dead] and float(t_all[0]) > 1e17
    assert torch.equal(t_all, t_res) and i_res[0] == dead and i_res[2] == dead
    assert float(t_all[1]) == np.float32(MAX_T)
    live_only = tables._replace(sphere_rows=tables.sphere_rows[
        tables.sphere_rows != dead], n_static=tables.n_static - 1)
    assert float(mk.resident_sweep_plain(live_only, o, d, tm, False)[0][0]) \
        == np.float32(MAX_T)


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_a_ray_of_non_finite_time_hits_no_sphere(bad):
    """In a moving scene every lerped disc of a ray whose time is not
    finite is NaN, so the plain sweep over all rows (static rows lerped
    too) finds no sphere: K7 sweeps such a ray from a NaN origin."""
    scene, cam = _scene("random")
    tables = mk.prep_tables(scene)
    ro, rd, tm = _rays(cam, 16)
    tm = torch.full_like(tm, bad)
    t_all, _ = mk._sphere_sweep(tables.spheres, ro, rd, tm, True)
    t_res, i_res = mk.resident_sweep_plain(tables, ro, rd, tm, True)
    assert bool((t_all == np.float32(MAX_T)).all())
    assert torch.equal(t_all, t_res) and bool((i_res == MISS_ROW).all())


def test_static_rows_predicate():
    """Zero delta and inv_dt of either sign and |time0| <= 1e30 make a row
    static; any motion term or a larger time0 does not."""
    rows = torch.zeros((6, 24))
    rows[1, 3] = -0.0
    rows[1, 7] = -0.0
    rows[2, 4] = 1e-30
    rows[3, 7] = 2.0
    rows[4, 6] = 1e30
    rows[5, 6] = -1.0001e30
    assert mk.static_rows(rows).tolist() == [True, True, False, False, True,
                                             False]


def _tables(n_static, n_moving, n_rects):
    """Synthetic tables with that many resident rows (every row distinct)."""
    n = n_static + n_moving
    n_pad = -(-n // 128) * 128
    sph = torch.zeros((n_pad, 24))
    sph[:, 0] = torch.arange(n_pad, dtype=torch.float32) * 3.0
    sph[:, 1] = -10.0
    sph[:, 8] = 0.5
    sph[n_static:n, 7] = 1.0
    sph[n_static:n, 3] = 0.1
    rows = torch.arange(n, dtype=torch.int32)
    rects = torch.zeros((mk.RECT_ROWS, 24))
    return mk.MegaTables(sph, rects, torch.tensor([0.5, 0.6, 0.7, 1.0]),
                         rows, n_static, torch.arange(n_rects,
                                                      dtype=torch.int32))


@pytest.mark.parametrize("n_static,n_moving,n_rects,motion,fits", [
    (9684, 0, 0, False, True),    # 24 * 9684 = 232,416 bytes
    (9685, 0, 0, False, False),   # padded to 9688 rows: 232,512
    (9680, 4, 0, False, True),    # without motion every row static-form
    (4, 5808, 0, True, True),     # 96 + 40 * 5808 = 232,416
    (4, 5809, 0, True, False),    # padded to 5812 rows: 232,576
    (4, 5784, 35, True, True),    # 96 + 40 * 5784 + 28 * 35 = 232,436
    (4, 5784, 36, True, False),   # + 28 more: 232,464
])
def test_shared_memory_rule_at_its_edges(n_static, n_moving, n_rects, motion,
                                         fits):
    """``trace_megakernel`` takes a scene whose resident rows fit in
    ``SHARED_LIMIT`` bytes and refuses one past it, before any device
    branch."""
    tables = _tables(n_static, n_moving, n_rects)
    feats = SceneFeatures(**{k: False for k in SceneFeatures.__slots__
                             if k.startswith("has_")})
    feats.has_spheres = feats.has_lambertian = True
    feats.has_motion, feats.has_rects = motion, n_rects > 0
    need = mk.shared_bytes(tables, feats)
    assert (need <= mk.SHARED_LIMIT) == fits
    ro = torch.tensor([[0.0, 1.0, 0.0]])
    rd = torch.tensor([[0.0, -1.0, 0.0]])
    args = (tables, ro, rd, torch.zeros(1), 3, 0, feats)
    if fits:
        rad, segs = mk.trace_megakernel(*args)
        assert int(segs) == 1 and bool(torch.isfinite(rad).all())
    else:
        with pytest.raises(ValueError, match="shared memory"):
            mk.trace_megakernel(*args)


def test_scene_shared_bytes_counts():
    assert mk.scene_shared_bytes(489, 0, 2, False) == 24 * 492 + 56
    assert mk.scene_shared_bytes(98, 391, 2, True) == 24 * 100 + 40 * 392 + 56
    assert mk.scene_shared_bytes(98, 391, 2, False) == 24 * 492 + 56


def test_plain_work_and_lane_passes():
    """The plain version's per-ray segments sum to its segment count; a
    block-uniform loop's lane-passes are 32 x the longest ray of each warp
    of consecutive rays."""
    scene, cam = _scene("random_spheres")
    tables = mk.prep_tables(scene)
    ro, rd, tm = _rays(cam, 8)
    work = {}
    _, segs = mk.trace_megakernel(tables, ro, rd, tm, 5, 4,
                                  SceneFeatures.from_scene(scene), work=work)
    per_ray = work["ray_segments"]
    assert int(per_ray.sum()) == int(segs) and int(per_ray.max()) <= 5
    assert nb.k7_lane_passes(torch.tensor([1, 3, 2])) == 32 * 3
    segs_64 = torch.cat([torch.ones(32, dtype=torch.int64),
                         torch.full((32,), 2), torch.tensor([5])])
    assert nb.k7_lane_passes(segs_64) == 32 * (1 + 2 + 5)


@pytest.mark.parametrize("name,ops", [("random_spheres", 488 * 17),
                                      ("random", 97 * 17 + 391 * 30),
                                      ("simple_light", 3 * 17 + 1 * 6)])
def test_k7_yardsticks_count_live_pairs(name, ops):
    """K7's sweep operations a segment: 17 a live static sphere, 30 a live
    moving one under motion, 6 a live rect; the bound is the larger of the
    operations at 67 TFLOP/s and the bytes, the issue ceiling twice the
    operations' time."""
    scene, _ = _scene(name)
    tables = mk.prep_tables(scene)
    feats = SceneFeatures.from_scene(scene)
    ys = nb.k7_yardsticks(scene, tables, feats, 1000, 2000, 1500, 10)
    assert ys["ops_a_segment"] == ops
    total = 2000 * ops + 1500 * nb.K7_OPS_SHADE + 10 * nb.NOISE_OPS
    assert ys["issue_ceiling_ms"] == pytest.approx(
        max(total / nb.ISSUE_PER_S * 1e3,
            (1000 * 40 + 4 * (tables.spheres.numel() + 4 + (
                tables.rects.numel() if feats.has_rects else 0)))
            / nb.HBM_BYTES_PER_S * 1e3))
