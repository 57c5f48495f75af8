"""Per-(seed, sample, site) MC seed pairs.

Counterpart of ``bayestpu/core/rng.py``. Every seed word is a pure counter
hash of ``(seed, sample, site, word)`` — the same hash the kernels use for
their masks — so sample *i*'s seeds do not depend on how many samples are
drawn, and the temporal and spatial mappings (and any split of the sample
axis) see the same masks for sample *i*. The numbers differ from the JAX
package's threefry keys; tests that compare the two packages feed the seeds
captured from JAX instead.
"""

from __future__ import annotations

import torch

from bayestpu_torch.kernels.masked_matmul import coord_bits, seed_stream


def sample_seeds(seed: int, num_samples: int, num_sites: int
                 ) -> torch.Tensor:
    """(num_samples, num_sites, 2) int32 seeds on the CPU."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    stream = seed_stream(s & 0xFFFFFFFF, s >> 32)
    sample = torch.arange(num_samples, dtype=torch.int64)[:, None, None]
    word = (2 * torch.arange(num_sites, dtype=torch.int64)[None, :, None]
            + torch.arange(2, dtype=torch.int64)[None, None, :])
    bits = coord_bits(sample, word, stream)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
