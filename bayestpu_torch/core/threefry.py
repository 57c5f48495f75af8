"""Threefry-2x32 masks: what ``jax.random.bits`` and ``jax.random.bernoulli``
draw for a key, in plain PyTorch on the tensor's device.

The JAX package draws the masks of its materialized MC-dropout sites
(``BayesianDropout``, ``BayesianDropout2D``: ``bayes.py:43-90``) with
``jax.random.bernoulli``, which is XLA's threefry, not a Pallas kernel. Under
``jax_threefry_partitionable`` (JAX's default, and the setting of the JAX
package's tests) word ``i`` of ``jax.random.bits(key, shape, uint32)``, for
the flat row-major index ``i`` of ``shape``, is the XOR of the two output
words of the standard 20-round Threefry-2x32 of the counter
``(i >> 32, i & 0xFFFFFFFF)`` under the key's two words, whose key schedule
adds ``k0 ^ k1 ^ 0x1BD11BDA``. ``jax.random.bernoulli(key, p, shape)`` is
``uniform < p`` with ``uniform = (bits >> 9) · 2⁻²³``, so it keeps where
``bits >> 9`` is below ``ceil(f32(p) · 2²³)``.

A key is the seed pair the port's sites take: ``key_data`` of the Flax
``make_rng`` key, cast to int32 as the fused sites cast it
(``fused.py:575,583``) and read back as uint32 here. The arithmetic runs on
int64 tensors that hold uint32 values (torch has few uint32 operations,
CUDA fewer); every sum is masked to 32 bits and every shift stays below
2³².
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
# the rotations of the even and odd groups of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x & ((1 << (32 - r)) - 1)) << r) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the
    key words (k0, k1): int64 tensors of uint32 values that broadcast
    against one another. Returns the two output words, int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits(seeds: torch.Tensor, shape: Sequence[int], row0: int = 0
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for the keys ``seeds`` of
    shape (..., 2) (int32, read as uint32): (..., *shape) int64 of uint32
    values on the seeds' device, the seeds' leading axes outermost (S keys,
    S masks in one pass). With ``row0`` the bits are rows ``row0 ..
    row0 + shape[0]`` along the first axis of a larger array of the same
    trailing shape: the flat indices, the counters, are the larger array's
    (one rank's slice of a data-sharded batch, whose global shape differs
    from ``shape`` only in its first axis)."""
    shape = tuple(int(d) for d in shape)
    lead = tuple(seeds.shape[:-1])
    words = seeds.to(torch.int64) & _M32
    k0, k1 = (words[..., j].reshape(lead + (1,) * len(shape))
              for j in range(2))
    n = math.prod(shape)
    first = int(row0) * math.prod(shape[1:])
    i = torch.arange(first, first + n, dtype=torch.int64,
                     device=seeds.device).view(shape)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    return y0 ^ y1


def keep_threshold(p: float) -> int:
    """The bound under which ``bits >> 9`` keeps: ``uniform < f32(p)`` with
    ``uniform = (bits >> 9) · 2⁻²³`` holds iff ``bits >> 9 <
    ceil(f32(p) · 2²³)`` (the product is exact in float64)."""
    return math.ceil(float(np.float32(p)) * 2.0 ** 23)


def bernoulli(seeds: torch.Tensor, p: float, shape: Sequence[int],
              row0: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for the keys ``seeds`` (...,
    2): a bool tensor (..., *shape), True with probability ``p``; with
    ``row0``, rows ``row0 ..`` of the mask of a larger first axis
    (``random_bits``)."""
    return (random_bits(seeds, shape, row0) >> 9) < keep_threshold(p)
