"""The integer and rounding rules of the hash noise that K2 and K7 run
(``pathtrace_tpu_torch/csrc/pt_device.cuh``), against both packages.

The kernels cannot run here, so this file holds numpy mirrors of their
rules, written in the kernels' order, and asks for the same bits as the
JAX package's ``_hash_unit``, ``_hash3``, ``fast_noise_c`` and
``fast_turb_c`` and the port's twins of them:

- the unit in one rounding, ``fma(float(v), 2^-23, -1)`` with
  ``v = h >> 8``: the exact ``v 2^-23 - 1`` is a float, so it is the
  reference's ``float(v) * 2^-23 - 1``; checked for every ``v`` in
  [0, 2^24), with the low byte of ``h`` clear and set;
- the lattice sums: ``kHashX (ix + d)`` is ``kHashX ix + kHashX d`` mod
  2^32, two terms an axis an octave, one three-way sum a corner;
- the whole restructured octave and the 7-octave turbulence, float32
  operation by operation as ``-fmad=false`` builds them (numpy rounds each
  float32 operation on its own, as eager JAX and PyTorch do on the CPU; an
  FMA is its float64 value, exact here, rounded once to float32);
- the bench's count of the noise at the instructions these rules need
  (243 an octave), and K2's yardsticks built on it: the noise lanes, their
  share and warp occupancy, and the issue ceiling; and the bench's K2
  timing in turns across trees (the order of its runs, its quartiles).
"""

import json
import os
import statistics
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402

F32, F64, U32 = np.float32, np.float64, np.uint32
HASH_X, HASH_Y, HASH_Z = U32(374761393), U32(668265263), U32(1103515245)
SCALE = F32(2.0 ** -23)
CHUNK = 1 << 22  # values of v a step of the exhaustive checks


def fma32(a, b, c):
    """float32 fma(a, b, c) for a = float(v) (v < 2^24) and float32 b, c
    of the unit's range: the float64 value is exact, so one rounding to
    float32 is the FMA's."""
    return (a.astype(F64) * F64(1.0) * np.asarray(b, F64)
            + np.asarray(c, F64)).astype(F32)


def unit_rule(h: np.ndarray) -> np.ndarray:
    """pt_device.cuh hash_unit: fma(float(h >> 8), 2^-23, -1)."""
    return fma32((h >> U32(8)).astype(F32), SCALE, F32(-1.0))


def mix_rule(s: np.ndarray) -> np.ndarray:
    """pt_device.cuh hash_mix: hash3 after its lattice sum."""
    s = s ^ (s >> U32(13))
    s = s * U32(1274126177)
    return s ^ (s >> U32(16))


def lattice_terms(i: np.ndarray, k: np.uint32):
    """The two hash terms of an axis: ``k i`` and ``k i + k`` (mod 2^32)."""
    t0 = i.view(np.uint32) * k
    return t0, t0 + k


def noise_rule(px, py, pz):
    """pt_device.cuh fast_noise, float32 op by op in the kernel's order."""
    for c in (px, py, pz):
        # __float2int_rd is (int32) floor(x) in range; numpy's cast is not
        # defined outside it
        assert np.abs(c).max() < 2.0 ** 31
    fx, fy, fz = np.floor(px), np.floor(py), np.floor(pz)
    ix, iy, iz = (f.astype(np.int32) for f in (fx, fy, fz))
    u, v, w = px - fx, py - fy, pz - fz
    uu = u * u * (F32(3.0) - F32(2.0) * u)
    vv = v * v * (F32(3.0) - F32(2.0) * v)
    ww = w * w * (F32(3.0) - F32(2.0) * w)
    off = [(u, u - F32(1.0)), (v, v - F32(1.0)), (w, w - F32(1.0))]
    wt = [(F32(1.0) - uu, uu), (F32(1.0) - vv, vv), (F32(1.0) - ww, ww)]
    hs = (lattice_terms(ix, HASH_X), lattice_terms(iy, HASH_Y),
          lattice_terms(iz, HASH_Z))
    accum = np.zeros_like(px)
    for di in (0, 1):
        for dj in (0, 1):
            wuv = wt[0][di] * wt[1][dj]
            for dk in (0, 1):
                h = mix_rule(hs[0][di] + hs[1][dj] + hs[2][dk])
                words = (h, h * U32(1664525) + U32(1013904223),
                         h * U32(22695477) + U32(1))
                ds = (di, dj, dk)
                g = [unit_rule(words[k]) * off[k][ds[k]] for k in range(3)]
                dot = g[0] + g[1] + g[2]
                accum = accum + wuv * wt[2][dk] * dot
    return accum


def turb_rule(px, py, pz, octaves=7):
    """pt_device.cuh fast_turb over :func:`noise_rule`."""
    accum = np.zeros_like(px)
    weight = F32(1.0)
    for _ in range(octaves):
        accum = accum + weight * noise_rule(px, py, pz)
        weight = weight * F32(0.5)
        px, py, pz = px * F32(2.0), py * F32(2.0), pz * F32(2.0)
    return np.abs(accum)


def _bits(x) -> bytes:
    x = np.asarray(x)
    assert x.dtype == np.float32
    return x.tobytes()


@pytest.mark.parametrize("low_byte", [0x00, 0xFF])
def test_unit_rule_equals_both_hash_units_for_every_v(low_byte):
    """Every v in [0, 2^24), as h = v << 8 | low_byte: the one-rounding
    unit is the reference's float(v) * 2^-23 - 1, bit for bit."""
    for lo in range(0, 1 << 24, CHUNK):
        h = (np.arange(lo, lo + CHUNK, dtype=np.uint32) << U32(8)) | U32(low_byte)
        got = unit_rule(h)
        ref_j = np.asarray(jfp._hash_unit(jnp.asarray(h)))
        ref_t = tfp._hash_unit(torch.from_numpy(h.astype(np.int64))).numpy()
        assert _bits(got) == _bits(ref_j), lo
        assert _bits(got) == _bits(ref_t), lo
    # the ends and the middle (+0 at v = 2^23)
    h = np.array([0, 0x7FFFFF00, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    np.testing.assert_array_equal(unit_rule(h).view(np.uint32),
                                  np.array([-1.0, -2.0 ** -23, 0.0,
                                            1.0 - 2.0 ** -23],
                                           dtype=np.float32).view(np.uint32))


def _lattice_points():
    rng = np.random.default_rng(11)
    near_zero = np.stack(np.meshgrid(*[np.arange(-3, 4, dtype=np.int32)] * 3,
                                     indexing="ij")).reshape(3, -1)
    negative = rng.integers(-(1 << 30), 0, size=(3, 4096), dtype=np.int32)
    wide = rng.integers(-(1 << 31), (1 << 31) - 1, size=(3, 4096),
                        dtype=np.int64).astype(np.int32)
    edges = np.array([2**31 - 1, -2**31, 2**31 - 2, -1, 0], dtype=np.int32)
    wrap = np.stack(np.meshgrid(edges, edges, edges, indexing="ij")).reshape(3, -1)
    return np.concatenate([near_zero, negative, wide, wrap], axis=1)


@pytest.mark.parametrize("corner", [(di, dj, dk) for di in (0, 1)
                                    for dj in (0, 1) for dk in (0, 1)])
def test_lattice_terms_equal_hash3(corner):
    """kHashX ix (+ kHashX) + ... mixed equals _hash3(ix + di, ...) of both
    packages, near 0, negative, and where ix + 1 wraps at 2^31."""
    ijk = _lattice_points()
    terms = [lattice_terms(c, k)[d] for c, k, d in
             zip(ijk, (HASH_X, HASH_Y, HASH_Z), corner)]
    got = mix_rule(terms[0] + terms[1] + terms[2])
    shifted = [((c.astype(np.int64) + d + 2**31) % 2**32 - 2**31).astype(np.int32)
               for c, d in zip(ijk, corner)]  # int32 wrap of ix + di
    ref_j = np.asarray(jfp._hash3(*(jnp.asarray(s) for s in shifted)))
    ref_t = tfp._hash3(*(torch.from_numpy(s) for s in shifted)).numpy()
    np.testing.assert_array_equal(got, ref_j.astype(np.uint32))
    np.testing.assert_array_equal(got.astype(np.int64), ref_t)


def _noise_points(kind: str):
    rng = np.random.default_rng({"seeded": 3, "lattice": 4, "negative": 5,
                                 "far": 6, "tiny": 7}[kind])
    n = 1 << 12
    if kind == "seeded":
        return (rng.random((3, n), dtype=np.float32) - F32(0.5)) * F32(40.0)
    if kind == "lattice":
        # integers and their float32 neighbours, +-0, both signs
        base = rng.integers(-50, 50, size=(3, 1 << 11)).astype(np.float32)
        return np.concatenate([base, np.nextafter(base, F32(np.inf)),
                               np.nextafter(base, F32(-np.inf)),
                               np.zeros((3, 4), np.float32),
                               -np.zeros((3, 4), np.float32)],
                              axis=1).astype(np.float32)
    if kind == "negative":
        return -rng.random((3, n), dtype=np.float32) * F32(1000.0)
    if kind == "tiny":
        # coordinates near 0, subnormal among them, beside ordinary ones
        tiny = np.array([1.2345e-33, 2.0 ** -103, 2.0 ** -104, 1e-40, 1e-45,
                         3e-36, 0.0, 0.75], dtype=np.float32)
        pick = rng.integers(0, tiny.size, size=(3, n))
        pts = tiny[pick] * np.where(rng.random((3, n)) < 0.2, F32(-1.0),
                                    F32(1.0))
        return pts.astype(np.float32)
    # |p| up to 1e6: after 6 doublings |p| < 6.4e7 < 2^31
    mag = F32(10.0) ** rng.uniform(-3.0, 6.0, size=(3, n)).astype(np.float32)
    sign = np.where(rng.random((3, n)) < 0.5, F32(-1.0), F32(1.0))
    return (mag * sign).astype(np.float32)


@pytest.mark.parametrize("kind", ["seeded", "lattice", "negative", "far",
                                  "tiny"])
def test_octave_and_turbulence_rules_equal_both_packages(kind):
    """The restructured octave (fast_noise_c) and the 7-octave turbulence
    (fast_turb_c), bit for bit against the port and JAX. XLA's CPU flushes
    subnormals, which PyTorch and the kernels (built -ftz=false) keep, so
    JAX is held to them only on points whose coordinates are 0 or
    normal."""
    p = _noise_points(kind)
    tp = [torch.from_numpy(c) for c in p]
    got_n, got_t = noise_rule(*p), turb_rule(*p)
    assert np.isfinite(got_t).all()
    assert _bits(got_n) == _bits(tfp.fast_noise_c(*tp).numpy())
    assert _bits(got_t) == _bits(tfp.fast_turb_c(*tp).numpy())
    normal = ((np.abs(p) >= np.finfo(F32).tiny) | (p == 0)).all(axis=0)
    assert normal.sum() > p.shape[1] // 3
    jp = [jnp.asarray(c[normal]) for c in p]
    assert _bits(got_n[normal]) == _bits(jfp.fast_noise_c(*jp))
    assert _bits(got_t[normal]) == _bits(jfp.fast_turb_c(*jp))


def test_a_planted_fault_in_the_unit_rule_shows():
    """Converting all of h (rounded: 32 significant bits) and scaling by
    2^-31 instead of converting h >> 8 leaves the reference's bits where
    the low byte is set: the check tells the rule from a near miss."""
    h = (np.arange(0, 1 << 16, dtype=np.uint32) << U32(16)) | U32(0xFFFF)
    wrong = fma32(h.astype(F32), F32(2.0 ** -31), F32(-1.0))
    assert _bits(wrong) != _bits(np.asarray(jfp._hash_unit(jnp.asarray(h))))


@pytest.mark.parametrize("mis", [False, True])
def test_k2_yardsticks_count_noise_lanes_at_the_noise_instructions(mis):
    """``nearest_bench.k2_yardsticks`` on five warps: three whose every
    lane hits the noise row, one with a single such lane, one that misses
    (a miss's winner is row 0, the noise row, whose albedo only
    ``FLAG_EMIT_SCALE`` writes). The noise counts 243 instructions an
    octave and 7 for the marble; the ceiling is the larger of the
    operations at the issue rate and the bytes, here the operations."""
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.tools import nearest_bench as nb

    assert nb.NOISE_OPS == 7 * 243 + 7
    table = torch.zeros(2, 16)
    table[0, 3] = 2.0  # row 0: the noise texture
    idx = torch.zeros(160, dtype=torch.int32)
    idx[96:128] = 1
    idx[100] = 0
    t = torch.full((160,), 1.0)
    t[128:] = 1e30
    flags = k2.FLAG_NOISE | (k2.FLAG_EMIT_SCALE if mis else 0)
    ys = nb.k2_yardsticks(table, flags, idx, t)
    n_noise, warps = (129, 5) if mis else (97, 4)
    assert ys["noise_lanes"] == n_noise
    assert ys["noise_lane_share"] == n_noise / 160
    assert ys["noise_occupancy"] == n_noise / (32 * warps)
    ops = 160 * nb.K2_OPS + n_noise * nb.NOISE_OPS
    nbytes = 160 * (nb.K2_BYTES + (nb.K2_BYTES_EMIT if mis else 0)) + 4 * 32
    assert ops / nb.ISSUE_PER_S > nbytes / nb.HBM_BYTES_PER_S
    assert ys["issue_ceiling_ms"] == pytest.approx(
        ops / nb.ISSUE_PER_S * 1e3, rel=1e-12)
    # without the noise flag no lane takes the branch
    off = nb.k2_yardsticks(table, flags & ~k2.FLAG_NOISE, idx, t)
    assert off["noise_lanes"] == 0 and off["noise_occupancy"] is None


def test_shade_turns_alternates_trees_and_takes_quartiles(monkeypatch):
    """``nearest_bench.shade_turns`` runs each tree once a round forth and
    once back, a process each, and reports each tree's quartiles, its
    median's distance from the first tree's and whether its hashes equal
    the first tree's (a fake run stands in for the card's)."""
    from pathtrace_tpu_torch.tools import nearest_bench as nb

    order = []

    def fake_run(cmd, env, **kw):
        tree = os.path.basename(env["PYTHONPATH"])
        order.append(tree)
        assert cmd[2:] == ["--what", "shade", "--sets", "sphere,motion"]
        out = [{"bench": "shade", "flag_set": fs, "card": "x",
                "ms": {"p": 1.0, "c": 2.0}[tree] + len(order) * 1e-3,
                "sha256": {"primary": fs + ("!" if fs == "motion"
                                            and tree == "c" else "")}}
               for fs in ("sphere", "motion")]
        stdout = "a line that is not JSON\n" + "".join(
            json.dumps(ln) + "\n" for ln in out)
        return subprocess.CompletedProcess(cmd, 0, stdout, "")

    monkeypatch.setattr(nb.subprocess, "run", fake_run)
    lines = nb.shade_turns([("p", "/t/p"), ("c", "/t/c")],
                           ["sphere", "motion"], 3)
    assert order == ["p", "c", "c", "p"] * 3
    by_set = {ln["flag_set"]: ln for ln in lines}
    ms_p = [1.0 + k * 1e-3 for k in (1, 4, 5, 8, 9, 12)]
    ms_c = [2.0 + k * 1e-3 for k in (2, 3, 6, 7, 10, 11)]
    sphere = by_set["sphere"]
    assert sphere["ms"] == {"p": ms_p, "c": ms_c}
    assert sphere["spread_ms"]["c"] == [
        min(ms_c), *statistics.quantiles(ms_c, n=4), max(ms_c)]
    assert sphere["median_less_first_ms"]["c"] == pytest.approx(
        statistics.median(ms_c) - statistics.median(ms_p))
    assert sphere["sha256_equal_first"] == {"p": True, "c": True}
    assert by_set["motion"]["sha256_equal_first"] == {"p": True, "c": False}
