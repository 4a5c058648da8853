"""A bit-exact twin of ``jax.random`` as the reference package uses it
(jax 0.9 with ``jax_threefry_partitionable=True``, 64-bit types off):
Threefry-2x32 keys, ``fold_in``, ``split``, 32-bit ``bits``, float32
``uniform`` in [0, 1) and int32 ``randint``.

A key is an int64 tensor [2] on the CPU holding two uint32 words, as
``jax.random.PRNGKey`` holds them; keys are derived on the host. The
plain twin does every add and shift in int64, masked to 32 bits. Its
counterparts in ``jax/_src/prng.py`` and ``jax/_src/random.py``:

- ``threefry_seed``: a seed in the int64 range gives [0, seed mod 2^32]
  (the high word is 0 with 64-bit types off);
- ``threefry_2x32``: 20 rounds, a key injection every 4;
- ``_threefry_fold_in``: ``threefry_2x32(key, [0, data])``;
- ``_threefry_split_foldlike``: new key ``i`` is Threefry of the 64-bit
  counter ``i`` split into its (high, low) words;
- ``_threefry_random_bits_partitionable``: a 32-bit draw at flat index
  ``i`` is ``b1 ^ b2`` of one Threefry of ``i``'s (high, low) words;
- ``_uniform``: ``bits >> 9 | 0x3f800000`` read as a float, minus 1;
- ``_randint``: two 32-bit draws from ``split(key)``, reduced modulo the
  span in uint32 arithmetic.

:func:`bits` and :func:`uniform` on a CUDA device launch the kernel of
``csrc/threefry.cu``: one thread per output value, native uint32
Threefry-2x32. It replaces no TPU kernel (the reference draws in XLA); it
exists because the plain twin issues ~140 int64 element-wise launches a
draw, ~18 ms for a 1280x720x4 frame's 18.4 M uniforms, where the kernel
writes 73.7 MB (a byte bound of 0.022 ms) at ~130 integer instructions a
draw. On the CPU the plain twin runs; a CUDA build or launch failure
raises.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

LAUNCHES = 0     # kernel launches (CUDA devices)
PLAIN_CALLS = 0  # draws served by the plain twin (CPU)

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT64 = (-(1 << 63), 1 << 63)

Shape = Union[int, Sequence[int]]
Word = Union[int, torch.Tensor]


# per key injection: the rotations of its 4 rounds, the key words added
# to each counter word and the injection's count
_SCHEDULE = tuple((_ROTATIONS[i % 2], (i + 1) % 3, (i + 2) % 3, i + 1)
                  for i in range(5))


def threefry_2x32(k1: int, k2: int, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x1, x2)`` under
    the key ``(k1, k2)``: uint32 values held in int64 tensors (or ints)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for rots, a, b, n in _SCHEDULE:
        for r in rots:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[a]) & MASK
        x2 = (x2 + ks[b] + n) & MASK
    return x1, x2


def _words(key: torch.Tensor) -> Tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key is a [2] tensor, got {tuple(key.shape)}")
    k1, k2 = (int(v) for v in key.tolist())
    if not (0 <= k1 <= MASK and 0 <= k2 <= MASK):
        raise ValueError(f"key words must be uint32, got {k1}, {k2}")
    return k1, k2


def _key(w1: Word, w2: Word) -> torch.Tensor:
    return torch.tensor([int(w1), int(w2)], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: [0, seed mod 2^32] for a seed in the
    int64 range (``OverflowError`` outside it, as in JAX)."""
    seed = int(seed)
    if not _INT64[0] <= seed < _INT64[1]:
        raise OverflowError(f"seed {seed} is outside the int64 range")
    return _key(0, seed & MASK)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2^32``."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    k1, k2 = _words(key)
    return _key(*threefry_2x32(k1, k2, 0, data))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] keys (in Python integers:
    a frame splits a few keys, and a tensor op a round would cost more)."""
    k1, k2 = _words(key)
    keys = [threefry_2x32(k1, k2, i >> 32, i & MASK) for i in range(num)]
    return torch.tensor(keys, dtype=torch.int64).reshape(num, 2)


def _shape(shape: Shape) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def bits_plain(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """The plain twin of 32-bit ``jax.random.bits``: int64 values in
    [0, 2^32) of ``shape``."""
    shape = _shape(shape)
    k1, k2 = _words(key)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry_2x32(k1, k2, i >> 32, i & MASK)
    return (b1 ^ b2).reshape(shape)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 map of 32 random bits: the top 23 as the mantissa
    of a float in [1, 2), minus 1."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one - 1.0


def uniform_plain(key: torch.Tensor, shape: Shape,
                  device="cpu") -> torch.Tensor:
    """The plain twin of ``jax.random.uniform(key, shape)`` (float32)."""
    return uniform_from_bits(bits_plain(key, shape, device))


def _draw(key: torch.Tensor, shape: Shape, device, as_float: bool):
    global LAUNCHES, PLAIN_CALLS
    device = torch.device(device)
    if device.type == "cpu":
        PLAIN_CALLS += 1
        return (uniform_plain if as_float else bits_plain)(key, shape, device)
    if device.type != "cuda":
        raise ValueError(f"threefry: unsupported device {device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    shape = _shape(shape)
    k1, k2 = _words(key)
    n = math.prod(shape)
    out = torch.empty(shape, dtype=torch.float32 if as_float else torch.int32,
                      device=device)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _cuda_build.library().pt_threefry(
            k1, k2, n, int(as_float), out.data_ptr(), stream)
        _cuda_build.check(code, "threefry launch")
        LAUNCHES += 1
    # the kernel writes uint32 words: as int64 values they read as the twin's
    return out if as_float else out.long() & MASK


def bits(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` drawn on ``device``: int64
    values in [0, 2^32) on every device (the plain twin on the CPU, the
    kernel on a CUDA device)."""
    return _draw(key, shape, device, as_float=False)


def uniform(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)) drawn on
    ``device``: the plain twin on the CPU, the kernel on a CUDA device."""
    return _draw(key, shape, device, as_float=True)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 (plain,
    on the CPU; bounds outside int32 raise ``OverflowError``, as JAX's do
    with 64-bit types off): ``minval`` plus ``(hi % span) * m + lo %
    span`` modulo the span, where ``m = (2^16 % span)^2 % span`` and every
    product and sum wraps in uint32 as JAX's does (so for the span
    2^31 - 1, ``m`` is 0 and the draw is ``lo % span``)."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    if not all(-(1 << 31) <= v < (1 << 31) for v in (minval, maxval)):
        raise OverflowError(f"randint bounds {minval}, {maxval} exceed int32")
    k_hi, k_lo = split(key)
    higher, lower = bits_plain(k_hi, shape), bits_plain(k_lo, shape)
    span = 1 if maxval <= minval else maxval - minval
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = ((((higher % span) * multiplier) & MASK) + lower % span) & MASK
    val = (minval + offset % span) & MASK
    return torch.where(val >= (1 << 31), val - (1 << 32), val).to(torch.int32)
