"""Threefry-2x32 keys and draws as ``jax.random`` makes them (64-bit types
off, ``jax_threefry_partitionable=True``), in plain PyTorch.

A frozen copy of the arithmetic the renderer's frames and train steps key
their primary rays and bounce seeds with: ``PRNGKey``, ``fold_in``,
``split``, 32-bit ``bits``, float32 ``uniform`` and int32 ``randint``. A
key is an int64 tensor [2] of two uint32 words on the CPU; a draw is made
on any device in int64, every add and shift masked to 32 bits.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# per key injection: its rounds' rotations, the key words it adds to the
# two counter words, and its count
_SCHEDULE = tuple((_ROTATIONS[i % 2], (i + 1) % 3, (i + 2) % 3, i + 1)
                  for i in range(5))

Shape = Union[int, Sequence[int]]


def threefry_2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32, 20 rounds, of the counter words ``(x1, x2)`` (ints
    or int64 tensors holding uint32 values) under the key ``(k1, k2)``."""
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


def words(key: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def PRNGKey(seed: int) -> torch.Tensor:
    """[0, seed mod 2^32]: JAX's key of an int64 seed."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k1, k2 = words(key)
    return torch.tensor(threefry_2x32(k1, k2, 0, int(data) & MASK),
                        dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    k1, k2 = words(key)
    return torch.tensor([threefry_2x32(k1, k2, i >> 32, i & MASK)
                         for i in range(num)], dtype=torch.int64)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)


def bits(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """32-bit draws, int64 values in [0, 2^32): the draw at flat index i
    is b1 ^ b2 of one Threefry of i's (high, low) words."""
    shape = _shape(shape)
    k1, k2 = words(key)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry_2x32(k1, k2, i >> 32, i & MASK)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of [1, 2), less 1."""
    b = bits(key, shape, device)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, minval: int, maxval: int) -> int:
    """One int32 draw of ``jax.random.randint(key, (), minval, maxval)``:
    two 32-bit draws from ``split(key)`` reduced modulo the span in
    uint32 arithmetic."""
    k_hi, k_lo = split(key)
    higher, lower = int(bits(k_hi, ())), int(bits(k_lo, ()))
    span = 1 if maxval <= minval else maxval - minval
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = ((((higher % span) * multiplier) & MASK) + lower % span) & MASK
    val = (minval + offset % span) & MASK
    return val - (1 << 32) if val >= (1 << 31) else val
