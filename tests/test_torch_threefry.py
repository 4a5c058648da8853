"""The port's Threefry twin (``pathtrace_tpu_torch.utils.threefry``) and its
primary rays against ``jax.random`` and the JAX package's
``render/frame.py``, value for value.

Keys, ``fold_in``, ``split``, 32-bit ``bits``, float32 ``uniform`` and
int32 ``randint`` must equal JAX's bit for bit (jax 0.9,
``jax_threefry_partitionable=True``, 64-bit types off), including seeds
outside the int32 range, odd flat sizes and every 23-bit mantissa of the
uniform map. ``pixel_jitter`` and the uniforms under
``generate_primary_rays`` (plain iid and Latin-hypercube ``stratify``)
must equal the reference's bit for bit; the rays are held to 1e-6
relative and absolute, as the camera test holds ``get_rays`` on shared
uniforms (the aperture's sin, cos and sqrt round a ULP apart in PyTorch
and XLA). The CUDA kernel of ``csrc/threefry.cu`` is held to the plain
twin in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.render import frame as jframe  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.render import frame  # noqa: E402
from pathtrace_tpu_torch.utils import threefry as tf  # noqa: E402

SEEDS = [0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**40 + 5, -1,
         -(2**63), 2**63 - 1]
# the frame's shapes at a small film, and flat sizes that are odd
SHAPES = [(5, 3, 4, 2), (5, 3, 4, 3), (5, 3, 4), (7,), (1,), (), (3, 5, 7)]


def _jkey(key: torch.Tensor):
    return jnp.asarray(key.numpy().astype(np.uint32))


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_values_measured_with_jax():
    k = tf.PRNGKey(0)
    assert k.tolist() == [0, 0]
    assert tf.fold_in(k, 1).tolist() == [928981903, 3453687069]
    assert tf.split(k).tolist() == [[1797259609, 2579123966],
                                    [928981903, 3453687069]]
    np.testing.assert_array_equal(
        tf.uniform(tf.split(k)[0], (5,)).numpy(),
        np.float32([0.8423141, 0.18237865, 0.2271781, 0.12072563,
                    0.19181347]))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    ref = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(tf.PRNGKey(seed).numpy(), ref)


@pytest.mark.parametrize("seed", [2**64, -(2**63) - 1])
def test_seeds_outside_int64_raise_as_in_jax(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        tf.PRNGKey(seed)


@pytest.mark.parametrize("data", [-1, 2**32])
def test_fold_in_outside_uint32_raises_as_in_jax(data):
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.PRNGKey(0), data)
    with pytest.raises(OverflowError):
        tf.fold_in(tf.PRNGKey(0), data)


def test_fold_in_and_split_chains_match_jax():
    """Random chains of fold_in (data 0, 1, 7, 0xffffffff or a random
    word) and split (into 1, 2, 3 or 5 keys, one of them taken) from
    several seeds: every key on the way equal to JAX's."""
    rng = np.random.default_rng(11)
    for seed in (0, 3, 2**31 + 9):
        k, jk = tf.PRNGKey(seed), jax.random.PRNGKey(seed)
        for _ in range(12):
            if rng.random() < 0.5:
                data = int(rng.choice([0, 1, 7, 0xFFFFFFFF,
                                       int(rng.integers(0, 2**32))]))
                k, jk = tf.fold_in(k, data), jax.random.fold_in(jk, data)
            else:
                num = int(rng.choice([1, 2, 3, 5]))
                ks, jks = tf.split(k, num), jax.random.split(jk, num)
                np.testing.assert_array_equal(
                    ks.numpy(), np.asarray(jks).astype(np.int64))
                pick = int(rng.integers(0, num))
                k, jk = ks[pick], jks[pick]
            np.testing.assert_array_equal(k.numpy(),
                                          np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax(shape):
    for key in (tf.PRNGKey(0), tf.fold_in(tf.PRNGKey(5), 3),
                tf.split(tf.PRNGKey(2**32 - 1))[1]):
        jk = _jkey(key)
        got = tf.bits(key, shape)
        assert got.shape == shape and got.dtype == torch.int64
        ref = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert _eq(tf.uniform(key, shape).numpy(),
                   jax.random.uniform(jk, shape))


def test_randint_seed_draw_matches_jax():
    """The trainer's bounce seed, ``randint(fold_in(key, 7), (), 0, 2^31 -
    1)``, over 64 keys; and other int32 ranges (a span of 1, an empty
    range, negative bounds, the whole int32 span) on a vector."""
    for s in range(64):
        key = tf.fold_in(tf.PRNGKey(s), 7)
        got = tf.randint(key, (), 0, 2**31 - 1)
        assert got.shape == () and got.dtype == torch.int32
        assert int(got) == int(jax.random.randint(_jkey(key), (), 0,
                                                  2**31 - 1))
    key = tf.split(tf.PRNGKey(9))[0]
    for lo, hi in ((0, 1000), (-5, 5), (3, 4), (5, 5), (7, 3),
                   (-(2**31), 2**31 - 1), (-1000, 2**30 + 7)):
        np.testing.assert_array_equal(
            tf.randint(key, (6, 5), lo, hi).numpy(),
            np.asarray(jax.random.randint(_jkey(key), (6, 5), lo, hi)))
    with pytest.raises(OverflowError):
        tf.randint(key, (), 0, 2**31)


def test_uniform_mantissa_map_is_jax_exhaustively(monkeypatch):
    """Every 23-bit mantissa (each with other low bits below it) through
    JAX's own ``uniform`` (its bit source replaced by these bits) and
    through the twin's map: equal bit for bit, 0 and 1 - 2^-23 included."""
    from jax._src import random as jrandom

    m = np.arange(1 << 23, dtype=np.uint32)
    words = (m << np.uint32(9)) | (m & np.uint32(0x1FF))
    monkeypatch.setattr(jrandom, "_random_bits",
                        lambda key, width, shape: jnp.asarray(words))
    jax.clear_caches()
    try:
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                            (1 << 23,)))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    got = tf.uniform_from_bits(torch.from_numpy(words.astype(np.int64)))
    assert _eq(got.numpy(), ref)
    assert ref[0] == 0.0 and ref[-1] == np.float32(1.0 - 2.0**-23)


def test_wrappers_count_plain_draws_on_cpu():
    calls = tf.PLAIN_CALLS
    tf.uniform(tf.PRNGKey(0), (4,))
    tf.bits(tf.PRNGKey(0), (4,))
    assert tf.PLAIN_CALLS == calls + 2 and tf.LAUNCHES == 0
    with pytest.raises(ValueError):
        tf.uniform(tf.PRNGKey(0), (4,), device="meta")
    with pytest.raises(ValueError):
        tf.split(torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("samples", [1, 4, 17])
@pytest.mark.parametrize("stratify", [False, True])
def test_pixel_jitter_matches_jax(stratify, samples):
    for key in (tf.PRNGKey(0), tf.fold_in(tf.PRNGKey(3), 2)):
        ref = jframe.pixel_jitter(_jkey(key), 5, 3, samples, stratify)
        got = frame.pixel_jitter(key, 5, 3, samples, stratify)
        assert _eq(got.numpy(), ref)


@pytest.mark.parametrize("preset", ["small", "random", "aras", "smallpt"])
@pytest.mark.parametrize("stratify", [False, True])
def test_generate_primary_rays_matches_jax(preset, stratify):
    """The uniforms under the rays equal JAX's bit for bit (checked
    through the jitter, the film coordinates and the rays' time, which
    is exact for ``time1 - time0 = 1``), and the rays agree to 1e-6."""
    W, H, S = 12, 8, 4
    _, jcam = jpresets.from_name(preset, W / H)
    _, cam = presets.from_name(preset, W / H)
    key = tf.fold_in(tf.PRNGKey(0), 5)
    ref = jframe.generate_primary_rays(jcam, W, H, S, _jkey(key), stratify)
    got = frame.generate_primary_rays(cam, W, H, S, key, stratify)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    kj, kc = tf.split(key)
    assert _eq(frame.pixel_jitter(kj, H, W, S, stratify).numpy(),
               jframe.pixel_jitter(_jkey(kj), H, W, S, stratify))
    cam_u = tf.uniform(kc, (H, W, S, 3))
    assert _eq(cam_u.numpy(), jax.random.uniform(_jkey(kc), (H, W, S, 3)))
    if float(cam.time1 - cam.time0) == 1.0:
        assert _eq(got[2].numpy(), ref[2])


@pytest.mark.parametrize("samples", [1, 2, 3, 4, 8, 16, 17])
def test_stable_argsort_is_torch_stable_argsort(samples):
    """The stratified jitter's order, ``torch.argsort(stable=True)`` along
    the samples, equals ``jnp.argsort``'s, ties included (values on a
    coarse grid tie often)."""
    g = torch.Generator().manual_seed(samples)
    for u in (torch.rand(40, 9, samples, generator=g),
              (torch.rand(40, 9, samples, generator=g) * 3).floor()):
        got = torch.argsort(u, dim=-1, stable=True)
        assert _eq(got.numpy().astype(np.int32),
                   jnp.argsort(jnp.asarray(u.numpy()), axis=-1))


def test_stratified_samples_fill_every_stratum():
    """Latin-hypercube jitter: in each pixel the S samples' strata
    floor(S * u) are a permutation of 0..S-1 on both axes."""
    S = 8
    j = frame.pixel_jitter(tf.PRNGKey(4), 6, 5, S, True)
    strata = torch.floor(j * S).long()
    want = torch.arange(S)
    for ax in range(2):
        assert torch.equal(strata[..., ax].sort(dim=-1).values,
                           want.expand(6, 5, S))
