"""The port's adaptive free run against JAX's at XLA's backend
optimisation level 0 (the committed fixture
``tests/goldens/torch_port_adaptive_o0.npz``, which this file's
``__main__`` writes: ``PYTHONPATH=. python tests/test_torch_adaptive_o0.py``,
JAX on the CPU, ~1 min).

``tests/test_torch_adaptive_aov.py`` holds the port's adaptive runs to
JAX's optimised build in lockstep (JAX's pixel ids replayed round by
round) and its free run statistically: left to pick for itself, the port
agreed with that build on 82.5% (fast route) and 76.2% (general) of
``small``'s spp map, because a sample's radiance differs in its last bits
and two pixels of nearly equal variance can swap places in
``np.argpartition``, whose output order keys the next round's draws. The
fixture holds JAX's free runs of ``small`` (depth 4, 32x32, 2 spp a
round, budget 8 spp a pixel: ``test_torch_drivers.py``'s adaptive case)
on both routes: the image, the spp map, the ray count, every round's
pixel ids, and the warmup's sums and metric.

Measured against it (``PYTHONPATH=. python tests/test_torch_adaptive_o0.py
--measure``): level 0 does not make the samples bit-equal. The warmup's
sums differ from JAX's on 68.2% (fast route) / 62.9% (general) of the
pixels, by at most 160 / 8,589 units in the last place, and the metric on
58.4% / 58.9%; where the sums are equal the metric is equal. These
differences reverse the order of 1 (fast) / 2 (general) of the 523,776
pixel pairs. Computed in float64 from each side's own sums, the metric
orders every pair as that side's float32 metric does (the witness below,
which needs no XLA): the metric's rounding is right on both sides, and
the reversals come from the samples. The fast route's one reversed pair
moves no pick: every round picks JAX's pixels in JAX's order, its spp map
agrees on 100%, no pixel leaves 1e-3 and its ray count is JAX's. The
general route's two keep round 0's set but change its order, so its
picks part from JAX's from the third round on (spp map 75.7%, no better
than against the
optimised build); that fault stays open (ROADMAP §3) and its run is held
statistically here, as in ``test_torch_adaptive_aov.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.config import Params  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.render import adaptive  # noqa: E402
from test_torch_drivers import (  # noqa: E402
    AD_BUDGET, AD_ROUTES, AD_SAMPLES, AD_SIZE,
)
from torch_port_util import DEPTH10_BUDGET, lane_close  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_adaptive_o0.npz")
PRESET, DEPTH = "small", 4
# as test_torch_adaptive_aov.py's: 1 - (1 - b)^8 of the pixels outside 1e-3
PIXEL_BUDGET = 1.0 - (1.0 - DEPTH10_BUDGET) ** 8


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(FIXTURE))


def _free_run(route):
    """The port's free run on ``route``: (image, rays, spp map, the
    warmup's (sum, sum of squares, count, metric), every round's picks)."""
    scene, cam = presets.from_name(PRESET, 1.0, seed=0)
    p = Params(width=AD_SIZE, height=AD_SIZE, samples=AD_SAMPLES,
               max_depth=DEPTH, seed=0)
    warmups, picks = [], []
    metric, argpartition = adaptive._metric, np.argpartition

    def spy_metric(ssum, ssq, cnt):
        m = metric(ssum, ssq, cnt)
        warmups.append(tuple(x.numpy().copy() for x in (ssum, ssq, cnt, m)))
        return m

    def spy_pick(a, kth, *args, **kw):
        res = argpartition(a, kth, *args, **kw)
        picks.append(np.asarray(res)[kth:].copy())
        return res

    adaptive._metric, np.argpartition = spy_metric, spy_pick
    try:
        img, rays, spp = adaptive.render_adaptive(
            scene, cam, p, AD_BUDGET, device="cpu", mode=route,
            log=lambda _s: None)
    finally:
        adaptive._metric, np.argpartition = metric, argpartition
    return img, rays, spp, warmups[0], picks


@pytest.fixture(scope="module")
def runs():
    return {route: _free_run(route) for route in AD_ROUTES}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _metric64(ssum, ssq, cnt):
    """The metric's formula in float64, from float32 sums."""
    s, q, c = (np.asarray(x, np.float64) for x in (ssum, ssq, cnt))
    mean = s / c[:, None]
    return np.maximum(q / c[:, None] - mean * mean, 0.0).sum(axis=1) / c


def _order(m):
    """sign(m_i - m_j) of every pixel pair, above the diagonal."""
    m = np.asarray(m, np.float64)
    return np.triu(np.sign(m[:, None] - m[None, :]), 1)


def test_fast_free_run_holds_the_o0_fixture(ref, runs):
    """The fast route's free run against JAX's at level 0: the spp map on
    at least 99% of the pixels, the image to the golden-pixel budget, the
    ray count within 1% (measured: 100%, 0 pixels, equal)."""
    img, rays, spp = runs["auto"][:3]
    key = "free.auto"
    assert float((spp == ref[f"{key}.spp"]).mean()) >= 0.99
    outside = ~lane_close(img, ref[f"{key}.img"]).all(axis=-1)
    assert float(outside.mean()) <= PIXEL_BUDGET, int(outside.sum())
    r_rays = int(ref[f"{key}.rays"])
    assert abs(rays - r_rays) <= 0.01 * r_rays, (rays, r_rays)


def test_general_free_run_is_the_o0_estimator(ref, runs):
    """The general route's free run spends JAX's budget in JAX's rounds
    and renders its image statistically (its spp map agrees on ~76%)."""
    img, rays, spp = runs["general"][:3]
    key = "free.general"
    assert spp.mean() == ref[f"{key}.spp"].mean()
    assert spp.min() == ref[f"{key}.spp"].min()
    assert abs(float(img.mean()) - float(ref[f"{key}.img"].mean())) < 0.02
    r_rays = int(ref[f"{key}.rays"])
    assert abs(rays - r_rays) <= 0.02 * r_rays, (rays, r_rays)


@pytest.mark.parametrize("route", AD_ROUTES)
def test_warmup_metric_against_float64(ref, runs, route):
    """Where the warmup metric parts from JAX's, which side rounds it
    right, with no XLA in the judgement: where the warmup's sums are bit
    for bit JAX's, so is the metric; computed in float64 from each side's
    own float32 sums, the metric orders every pixel pair (ties aside) as
    that side's float32 metric does, and every pair whose order the two
    sides' metrics reverse is reversed in float64 too, so the reversals
    come from the samples. The top quarter of either float64 metric is
    JAX's round-0 pick."""
    ssum, ssq, cnt, m = runs[route][3]
    key = f"free.{route}"
    ssum_j, ssq_j, m_j = (ref[f"{key}.{k}"] for k in ("ssum0", "ssq0",
                                                       "metric0"))
    same = ((_bits(ssum) == _bits(ssum_j)).all(axis=1)
            & (_bits(ssq) == _bits(ssq_j)).all(axis=1))
    assert same.any()
    np.testing.assert_array_equal(_bits(m)[same], _bits(m_j)[same])
    m64, m64_j = _metric64(ssum, ssq, cnt), _metric64(ssum_j, ssq_j, cnt)
    for m32, exact in ((m, m64), (m_j, m64_j)):
        a, b = _order(m32), _order(exact)
        assert not ((a != b) & (a != 0) & (b != 0)).any()
    reversed32 = _order(m) != _order(m_j)
    assert (_order(m64) != _order(m64_j))[reversed32].all()
    n_pix = m.shape[0]
    k = ref[f"{key}.ids"].shape[1]
    for exact in (m64, m64_j):
        assert set(np.argpartition(exact, n_pix - k)[-k:]) == set(
            ref[f"{key}.ids"][0])


def write_fixture(path: str = FIXTURE) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pathtrace_tpu.config import Params as JParams
    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.render import adaptive as jad

    out = {}
    argpartition = np.argpartition
    metrics, picks, sums = [], [], []
    renders = {f: getattr(jad, f) for f in ("_render_pixels",
                                             "_render_pixels_fast")}

    def recorder(fn):
        def record(*a, **kw):
            s1, s2, rays = fn(*a, **kw)
            sums.append((np.asarray(s1), np.asarray(s2)))
            return s1, s2, rays
        return record

    def spy(a, kth, *args, **kw):
        res = argpartition(a, kth, *args, **kw)
        metrics.append(np.asarray(a).copy())
        picks.append(np.asarray(res)[kth:].copy())
        return res

    js, jcam = jpresets.from_name(PRESET, 1.0, seed=0)
    p = JParams(width=AD_SIZE, height=AD_SIZE, samples=AD_SAMPLES,
                max_depth=DEPTH, seed=0)
    for route in AD_ROUTES:
        metrics.clear()
        picks.clear()
        sums.clear()
        np.argpartition = spy
        for f, fn in renders.items():
            setattr(jad, f, recorder(fn))
        try:
            img, rays, spp = jad.render_adaptive(
                js, jcam, p, AD_BUDGET, features=JFeatures.from_scene(js),
                mode=route, log=lambda _s: None)
        finally:
            np.argpartition = argpartition
            for f, fn in renders.items():
                setattr(jad, f, fn)
        key = f"free.{route}"
        out[f"{key}.img"] = np.asarray(img)
        out[f"{key}.spp"] = np.asarray(spp)
        out[f"{key}.rays"] = np.asarray(int(rays), np.int64)
        out[f"{key}.ids"] = np.stack(picks)
        out[f"{key}.metric0"] = metrics[0]
        # the warmup's sums, added in float32 as the reference adds them
        for i, name in enumerate(("ssum0", "ssq0")):
            out[f"{key}.{name}"] = (np.zeros_like(sums[0][i]) + sums[0][i]
                                    + sums[1][i])
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


def measure(path: str = FIXTURE) -> dict:
    """The port's free runs against the fixture's, per route: the shares
    of the warmup's pixels whose sums and whose metric are bit-equal, the
    largest difference of the sums in units in the last place, the pixel
    pairs whose order the metrics reverse, the rounds whose picks are
    equal in order, the spp map's agreement, the pixels outside 1e-3 and
    the ray counts (``PYTHONPATH=. python tests/test_torch_adaptive_o0.py
    --measure``)."""
    ref = dict(np.load(path))
    out = {}
    for route in AD_ROUTES:
        img, rays, spp, (ssum, ssq, _, m), picks = _free_run(route)
        key = f"free.{route}"
        sums = np.concatenate([ssum, ssq], axis=1)
        sums_j = np.concatenate([ref[f"{key}.ssum0"], ref[f"{key}.ssq0"]],
                                axis=1)
        ulps = np.abs(_bits(sums).astype(np.int64) - _bits(sums_j))
        out[route] = {
            "sums_bit_equal": float((ulps == 0).all(axis=1).mean()),
            "sums_max_ulps": int(ulps.max()),
            "metric0_bit_equal": float((_bits(m) == _bits(
                ref[f"{key}.metric0"])).mean()),
            "pairs_reversed": int((_order(m) != _order(
                ref[f"{key}.metric0"])).sum()),
            "rounds_same_picks": int(sum(np.array_equal(a, b) for a, b in
                                         zip(picks, ref[f"{key}.ids"]))),
            "spp_agree": float((spp == ref[f"{key}.spp"]).mean()),
            "pixels_outside": int((~lane_close(
                img, ref[f"{key}.img"]).all(axis=-1)).sum()),
            "rays": int(rays), "ref_rays": int(ref[f"{key}.rays"])}
    return out


if __name__ == "__main__":
    import sys

    if "--measure" in sys.argv:
        print(measure())
    else:
        # XLA's backend optimisation level 0, read when the backend starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_backend_optimization_level=0")
        write_fixture()
