"""The closest-hit kernels' shortcuts (csrc/sphere_nearest.cu, K1 and
K3), held to the plain version on the CPU.

The kernels must equal ``sphere_nearest_plain`` bit for bit. Each
shortcut they take before or around the square root has a plain
predicate in ``ops/intersect_kernel.py``, and each is held here to the
plain version's own arithmetic (``_nearest_plain``):

- only live slots are staged (``staged_slots``): a masked slot, even one
  that would be the nearest hit, never wins;
- the root is picked without a t_max test (``kernel_root``): the same
  win and the same t as the windowed choice, for every float32 b and
  disc > 0 and any window, special values included;
- K3 skips a static slot's motion terms (``static_slots``) in a block
  whose rays are all finite (``static_rays_ok``): the same t as with the
  terms, for finite rays; with a NaN time it would not be, hence the
  block test.

``kernel_mirror`` composes them in the kernel's order (live slots in
index order, the block test, a strict ``<`` against the running best)
and must equal the plain version on the presets' rays, scattered rays,
ties and non-finite rays. The card tests of tests/test_torch_cuda.py
hold the CUDA kernels themselves to the plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from pathtrace_tpu_torch.config import MAX_T, MIN_T  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.build import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from pathtrace_tpu_torch.ops import shade_kernel  # noqa: E402
from pathtrace_tpu_torch.render.frame import generate_primary_rays  # noqa: E402
from pathtrace_tpu_torch.tools import nearest_bench, profile_step  # noqa: E402

F32_MAX = float(np.finfo(np.float32).max)
TIME_BOUND = float(np.float32(ik.STATIC_TIME_BOUND))
# float32 values at the edges: zeros of both signs, subnormals, the
# smallest normal, ordinary, huge, infinite, NaN
SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 3e-39, -3e-39, 1.2e-38, 1e-3,
                    -1e-3, 0.5, 1.0, -1.0, 7.25, 1e19, -1e19, 1.8e19, 3e38,
                    -3e38, F32_MAX, np.inf, -np.inf, np.nan], dtype=np.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _random_floats(rng, n: int) -> np.ndarray:
    """``n`` float32 from uniform bit patterns (every exponent equally
    likely: subnormals, huge values, infinities and NaNs included)."""
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)


def _windowed(b, sq, t_min, t_max, best):
    """The plain version's root choice and win (``_nearest_plain``): the
    near root in (t_min, t_max), else the far one, else t_max; a pair
    wins where its t is below the running best."""
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where((t0 > t_min) & (t0 < t_max), t0,
                    torch.where((t1 > t_min) & (t1 < t_max), t1, t_max))
    return t, t < best


def _root_check(b, disc, t_min, t_max, best):
    sq = torch.sqrt(disc.double()).float()
    t_ref, win_ref = _windowed(b, sq, t_min, t_max, best)
    t = ik.kernel_root(b, sq, t_min)
    win = (t > t_min) & (t < best)
    assert torch.equal(win, win_ref)
    assert torch.equal(_bits(t[win]), _bits(t_ref[win]))


def _windows(rng, n):
    """(t_min, t_max, best): windows of every kind, and a running best
    that is t_max (no hit yet) or an earlier winner inside the window."""
    lo = torch.from_numpy(rng.choice(SPECIAL, n))
    hi = torch.from_numpy(rng.choice(SPECIAL, n))
    lo = torch.where(torch.from_numpy(rng.random(n) < 0.5),
                     torch.tensor(np.float32(MIN_T)), lo)
    hi = torch.where(torch.from_numpy(rng.random(n) < 0.5),
                     torch.tensor(np.float32(MAX_T)), hi)
    inner = lo + (hi - lo) * torch.from_numpy(rng.random(n).astype(np.float32))
    ok = (inner > lo) & (inner < hi)
    best = torch.where(ok & torch.from_numpy(rng.random(n) < 0.5), inner, hi)
    return lo, hi, best


def test_kernel_root_matches_windowed_choice_on_special_values():
    """Every (b, disc) pair of SPECIAL (disc > 0) under every window."""
    rng = np.random.default_rng(0)
    b, disc = np.meshgrid(SPECIAL, SPECIAL[SPECIAL > 0], indexing="ij")
    b = torch.from_numpy(np.tile(b.ravel(), 64))
    disc = torch.from_numpy(np.tile(disc.ravel(), 64))
    _root_check(b, disc, *_windows(rng, b.numel()))


def test_kernel_root_matches_windowed_choice_on_random_bits():
    """2^20 float32 (b, disc > 0) from uniform bit patterns."""
    rng = np.random.default_rng(1)
    n = 1 << 20
    b = torch.from_numpy(_random_floats(rng, n))
    disc = torch.from_numpy(np.abs(_random_floats(rng, n)))
    disc = torch.where(disc > 0, disc, 1.0)  # NaN and 0 fail disc > 0
    _root_check(b, disc, *_windows(rng, n))


@settings(max_examples=300, deadline=None)
@given(b=st.floats(width=32), disc=st.floats(width=32, min_value=0.0,
                                             exclude_min=True),
       t_min=st.floats(width=32), t_max=st.floats(width=32),
       frac=st.floats(0.0, 1.0), no_hit=st.booleans())
def test_kernel_root_matches_windowed_choice_hypothesis(b, disc, t_min,
                                                        t_max, frac, no_hit):
    f = np.float32
    with np.errstate(all="ignore"):
        best = f(t_min) + f(frac) * (f(t_max) - f(t_min))
    if no_hit or not f(t_min) < best < f(t_max):
        best = f(t_max)
    args = [torch.tensor([f(v)]) for v in (b, disc, t_min, t_max, best)]
    _root_check(*args)


def _sphere_rows(centre, c2, motion=None):
    """[1, 1] rows of one sphere for ``_nearest_plain``."""
    rows = [torch.tensor([[np.float32(v)]]) for v in (*centre, c2)]
    rows.append(torch.tensor([[True]]))
    if motion is not None:
        motion = [torch.tensor([[np.float32(v)]]) for v in motion]
    return rows, motion


def _static_vs_full(rays, time, centre, c2, zeros, time0):
    """t of one static sphere, with its motion terms (the plain K3) and
    without them (the plain K1), for every ray."""
    rows, motion = _sphere_rows(centre, c2, (*zeros[:3], time0, *zeros[3:]))
    t_full, i_full = ik._nearest_plain(*rows, rays, MIN_T, MAX_T,
                                       motion + [time])
    t_k1, i_k1 = ik._nearest_plain(*rows, rays, MIN_T, MAX_T)
    return t_full, t_k1


def _finite_pool(rng, n):
    """Finite float32 from SPECIAL's finite values, ordinary values and
    random finite bit patterns."""
    x = _random_floats(rng, n)
    x = np.where(np.isfinite(x), x, np.float32(2.5))
    finite = SPECIAL[np.isfinite(SPECIAL)]
    pick = rng.random(n)
    x = np.where(pick < 0.3, rng.choice(finite, n), x)
    return np.where(pick > 0.7, rng.normal(0, 5, n).astype(np.float32), x)


def test_static_shortcut_keeps_t_on_finite_rays():
    """On a static slot (every motion term +-0, |time0| <= 1e30) the
    plain K3 and the plain K1 give the same t, bit for bit, for finite
    rays and |time| <= 1e30: random spheres and rays, edge values
    included, every sign of the zeros."""
    rng = np.random.default_rng(2)
    n = 4096
    for trial in range(100):
        rays = torch.from_numpy(np.stack([_finite_pool(rng, n)
                                          for _ in range(6)]))
        time = torch.from_numpy(np.clip(_finite_pool(rng, n), -1e30, 1e30))
        if trial % 2:  # ordinary camera-like rays: many hits
            rays[:3] = torch.from_numpy(rng.normal(0, 3, (3, n)).astype(np.float32))
            d = rng.normal(size=(3, n)).astype(np.float32)
            rays[3:] = torch.from_numpy(d / np.linalg.norm(d, axis=0))
            time = torch.from_numpy(rng.random(n).astype(np.float32))
        centre = rng.choice(SPECIAL[np.isfinite(SPECIAL)], 3) if trial % 5 == 0 \
            else rng.normal(0, 4, 3).astype(np.float32)
        with np.errstate(over="ignore"):
            c2 = np.float32(centre.astype(np.float64) @ centre - rng.random())
        zeros = rng.choice(np.array([0.0, -0.0], np.float32), 6)
        time0 = rng.choice(np.array([0.0, -0.0, 0.5, -7.0, 1e30, -1e30],
                                    np.float32))
        assert ik.static_rays_ok(rays, time).all()
        t_full, t_k1 = _static_vs_full(rays, time, centre, c2, zeros, time0)
        assert torch.equal(_bits(t_full), _bits(t_k1)), trial


@settings(max_examples=200, deadline=None)
@given(o=st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False),
                  min_size=3, max_size=3),
       d=st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False),
                  min_size=3, max_size=3),
       centre=st.lists(st.floats(-1e6, 1e6, width=32), min_size=3, max_size=3),
       r=st.floats(0.0, 1e3, width=32),
       time=st.floats(-TIME_BOUND, TIME_BOUND, width=32),
       time0=st.floats(-TIME_BOUND, TIME_BOUND, width=32),
       signs=st.lists(st.booleans(), min_size=6, max_size=6))
def test_static_shortcut_keeps_t_hypothesis(o, d, centre, r, time, time0,
                                            signs):
    rays = torch.tensor([[v] for v in (*o, *d)], dtype=torch.float32)
    c = np.array(centre, np.float32)
    c2 = np.float32(np.float32(c @ c) - np.float32(r) * np.float32(r))
    zeros = [-0.0 if s else 0.0 for s in signs]
    t_full, t_k1 = _static_vs_full(rays, torch.tensor([np.float32(time)]),
                                   c, c2, zeros, time0)
    assert torch.equal(_bits(t_full), _bits(t_k1))


def test_static_shortcut_needs_finite_times():
    """With a NaN ray time the motion terms are NaN and the plain K3
    misses where K1 hits: a block with such a ray keeps the terms."""
    rays = torch.tensor([[0.0], [0.0], [0.0], [0.0], [0.0], [-1.0]])
    time = torch.tensor([float("nan")])
    t_full, t_k1 = _static_vs_full(rays, time, (0.0, 0.0, -5.0), 24.0,
                                   [0.0] * 6, 0.0)
    assert t_k1.item() == 4.0 and t_full.item() == np.float32(MAX_T)
    assert not ik.static_rays_ok(rays, time).any()


def test_static_slots_predicate():
    soa = torch.zeros(12, 6)
    soa[8] = torch.tensor([0.0, 2.0, 1e30, 1e31, 0.0, float("nan")])
    soa[5, 4] = -0.0
    soa[9, 0] = -0.0
    assert ik.static_slots(soa).tolist() == [True, True, True, False, True,
                                             False]
    soa[6, 1] = 1e-45  # a subnormal delta moves the slot
    soa[10, 2] = 1.0
    assert ik.static_slots(soa).tolist()[:3] == [True, False, False]


def kernel_mirror(soa, rays, time=None, t_min=MIN_T, t_max=MAX_T,
                  block=1024, guard=True):
    """The kernel's sweep in plain PyTorch: the live slots in index order
    (``staged_slots``), K3's motion terms skipped on ``static_slots`` in
    blocks of ``block`` rays whose rays are all ``static_rays_ok`` (every
    block when ``guard`` is off), ``kernel_root`` and a strict ``<``
    against the running best. (t [R], idx [R] int32)."""
    ox, oy, oz, dx, dy, dz = rays
    ro_d = ox * dx + oy * dy + oz * dz
    ro_ro = ox * ox + oy * oy + oz * oz
    R = rays.shape[1]
    best_t = torch.full((R,), t_max, dtype=torch.float32)
    best_i = torch.zeros(R, dtype=torch.int32)
    if time is not None:
        ok = ik.static_rays_ok(rays, time)
        pad = torch.ones((-R) % block, dtype=torch.bool)
        ok = torch.cat([ok, pad]).reshape(-1, block).all(dim=1)
        ok = ok.repeat_interleave(block)[:R] | (not guard)
        static = ik.static_slots(soa)
    for j in ik.staged_slots(soa).tolist():
        cx, cy, cz, c2 = soa[:4, j]
        b = ro_d - (cx * dx + cy * dy + cz * dz)
        c = ro_ro - 2.0 * (cx * ox + cy * oy + cz * oz) + c2
        if time is not None:
            mx, my, mz, time0, inv_dt, c_dot_d, d2 = soa[5:, j]
            s = (time - time0) * inv_dt
            b_m = b - s * (mx * dx + my * dy + mz * dz)
            c_m = (c - 2.0 * s * (mx * ox + my * oy + mz * oz)
                   + 2.0 * s * c_dot_d + s * s * d2)
            full = ~(static[j] & ok)
            b = torch.where(full, b_m, b)
            c = torch.where(full, c_m, c)
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0).double()).float()
        t = ik.kernel_root(b, sq, t_min)
        win = (disc > 0.0) & (t > t_min) & (t < best_t)
        best_t = torch.where(win, t, best_t)
        best_i = torch.where(win, j, best_i)
    return best_t, best_i


def _many(n=700, moving=False, seed=3):
    """Small spheres in front of the random_spheres camera, two copies of
    one sphere (a tie) at indices far apart, and every third slot
    masked."""
    b = SceneBuilder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5, 0.5, 0.5)))
    mat = b.lambertian_color((0.2, 0.4, 0.6))
    rng = np.random.default_rng(seed)
    for k, (x, z) in enumerate(rng.uniform(-6.0, 6.0, (n - 1, 2))):
        c0 = (float(x), 0.4, float(z))
        if k in (5, 600):
            c0 = (0.0, 1.0, 0.0)
        if moving and k % 4 and k not in (5, 600):
            b.moving_sphere(c0, tuple(np.add(c0, rng.normal(size=3) * 0.3)),
                            0.0, 1.0, 0.4, mat)
        else:
            b.sphere(c0, 0.4, mat)
    scene = b.finish()
    mask = scene.spheres.mask.clone()
    mask[3::3] = False
    mask[6] = mask[601] = True  # both tie copies stay live
    return dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, mask=mask))


def _rays(scene, camera, n, scatter):
    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    gen = torch.Generator()
    gen.manual_seed(0)
    ro, rd, tm = generate_primary_rays(camera, 64, 32, 4, gen)
    R = 64 * 32 * 4
    state = tfp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
    moving = tables.soa.shape[0] == 12
    sel = torch.arange(0, R, R // n)[:n]  # rays from every part of the film
    if scatter:
        t, idx = ik.sphere_nearest_plain(
            tables.soa, state.planes[:6], time=state.time if moving else None)
        planes, _ = shade_kernel.shade_from_winners_plain(
            tables.table, idx, t, state.planes, state.time, state.alive,
            state.lane, 7, 0, 10, tables.sky4, tfp.feature_flags(feats))
        return tables.soa, planes[:6, sel].contiguous(), state.time[sel]
    return tables.soa, state.planes[:6, sel].contiguous(), state.time[sel]


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("name", ["random_spheres", "random", "simple_light",
                                  "many", "many_moving"])
def test_kernel_mirror_matches_plain(name, scatter):
    """The shortcuts together equal the plain version bit for bit: the
    cover scenes (static and moving), simple_light's 125 masked slots of
    128, and 700 spheres with every third slot masked and a tie."""
    if name.startswith("many"):
        scene = _many(moving=name == "many_moving")
        camera = presets.random_spheres(16 / 9)[1]
    else:
        scene, camera = presets.from_name(name, 16 / 9)
    soa, rays, time = _rays(scene, camera, 1024 if name.startswith("many")
                            else 2048, scatter)
    moving = soa.shape[0] == 12
    t_p, i_p = ik.sphere_nearest_plain(soa, rays,
                                       time=time if moving else None)
    for block in (256, 512, 1024):  # 1, 2 and 4 rays a thread
        t, i = kernel_mirror(soa, rays, time if moving else None, block=block)
        assert torch.equal(_bits(t), _bits(t_p)) and torch.equal(i, i_p)
        if moving:
            break
    if name.startswith("many") and not scatter:  # the tie was met
        assert int((i_p == 6).sum()) > 0 and not (i_p == 601).any()


def test_kernel_mirror_with_non_finite_rays():
    """A NaN time, a NaN origin and an infinite direction in one block of
    a moving scene: the block keeps the motion terms and the mirror still
    equals the plain version; without the block test it does not."""
    scene, camera = presets.random(16 / 9)
    soa, rays, time = _rays(scene, camera, 3000, False)
    rays, time = rays.clone(), time.clone()
    time[5] = float("nan")
    rays[0, 1030] = float("nan")
    rays[4, 2100] = float("inf")
    t_p, i_p = ik.sphere_nearest_plain(soa, rays, time=time)
    t, i = kernel_mirror(soa, rays, time)
    assert torch.equal(_bits(t), _bits(t_p)) and torch.equal(i, i_p)
    t_u, i_u = kernel_mirror(soa, rays, time, guard=False)
    assert not (torch.equal(_bits(t_u), _bits(t_p)) and torch.equal(i_u, i_p))


def test_masked_slots_never_win():
    """A masked sphere right in front of every ray changes nothing: the
    plain version gives what it gives over the live slots alone, and the
    staged slots are the live ones in index order."""
    scene, camera = presets.random_spheres(16 / 9)
    soa, rays, _ = _rays(scene, camera, 2000, False)
    t_p, i_p = ik.sphere_nearest_plain(soa, rays)
    blocker = soa.clone()
    slot = int(torch.nonzero(soa[4] == 0)[0])  # a padding slot
    o = rays[:3, 0]
    blocker[:3, slot] = o + 0.0
    blocker[3, slot] = float(o @ o) - 4.0  # radius 2 about the camera
    t_b, i_b = ik.sphere_nearest_plain(blocker, rays)
    assert torch.equal(t_b, t_p) and torch.equal(i_b, i_p)
    blocker[4, slot] = 1.0  # live, it wins every ray
    assert (ik.sphere_nearest_plain(blocker, rays)[1] == slot).all()
    staged = ik.staged_slots(soa)
    assert torch.equal(staged, torch.nonzero(soa[4] > 0).flatten())
    t_s, i_s = ik.sphere_nearest_plain(soa[:, staged].contiguous(), rays)
    assert torch.equal(t_s, t_p) and torch.equal(staged[i_s.long()].int(), i_p)


def test_profiler_names_the_instances():
    """``profile_step`` sorts every rays-a-thread instance to its kernel."""
    name = "void (anonymous namespace)::sphere_nearest_kernel<{}, {}>(float)"
    for k in (1, 2, 4):
        assert profile_step._kind(name.format("true", k)).startswith("K3")
        assert profile_step._kind(name.format("false", k)).startswith("K1")


def test_nearest_bench_yardsticks_and_branch_share():
    """The bench's bound and issue ceiling at full width (16 operations a
    live pair; 38 a moving one, 16 a static one), and its branch share
    against a direct count on a small CPU input."""
    R = 1280 * 720 * 4
    scene, camera = presets.random_spheres(16 / 9)
    soa, rays, _ = _rays(scene, camera, 2048, True)
    n_live = int((soa[4] > 0).sum())
    assert nearest_bench.pair_ops(soa) == 16 * n_live
    k1 = nearest_bench.yardsticks(soa, R)
    assert k1["bound_by"] == "operations"
    assert abs(k1["bound_ms"] - R * n_live * 16 / 67e12 * 1e3) < 1e-9
    assert abs(k1["issue_ceiling_ms"] - 2 * k1["bound_ms"]) < 1e-9
    mscene, _ = presets.random(16 / 9)
    soa12 = tfp.build_sphere_soa(mscene, motion=True)
    live = soa12[4] > 0
    n_static = int((live & ik.static_slots(soa12)).sum())
    assert 0 < n_static < int(live.sum())
    ops = 38 * int(live.sum()) - 22 * n_static
    assert nearest_bench.pair_ops(soa12) == ops
    k3 = nearest_bench.yardsticks(soa12, R)
    assert abs(k3["issue_ceiling_ms"] - R * ops / 33.5e12 * 1e3) < 1e-9
    # a static operand costs K3 what it costs K1
    soa_static = tfp.build_sphere_soa(scene, motion=True)
    assert nearest_bench.pair_ops(soa_static) == 16 * n_live
    share = nearest_bench.branch_share(soa, rays, chunk=1024)
    live = soa[:, soa[4] > 0]
    b = ((rays[0] * rays[3] + rays[1] * rays[4] + rays[2] * rays[5])[:, None]
         - (live[0] * rays[3][:, None] + live[1] * rays[4][:, None]
            + live[2] * rays[5][:, None]))
    c = ((rays[0] * rays[0] + rays[1] * rays[1] + rays[2] * rays[2])[:, None]
         - 2.0 * (live[0] * rays[0][:, None] + live[1] * rays[1][:, None]
                  + live[2] * rays[2][:, None]) + live[3])
    pos = (b * b - c) > 0
    w32 = pos.reshape(-1, 32, pos.shape[1]).any(dim=1).double().mean().item()
    w128 = pos.reshape(2, 4, 8, 32, -1).any(dim=3).any(dim=1)
    assert share["warp32"] == pytest.approx(w32, abs=1e-12)
    assert share["warp128"] == pytest.approx(w128.double().mean().item(),
                                             abs=1e-12)
    assert 0 < share["warp32"] <= share["warp128"] < 1


def test_nearest_bench_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert nearest_bench.main([]) == 1
    assert capsys.readouterr().out == ""
