"""Per-(seed, sample, site) and per-(seed, step, site) MC seed pairs.

Counterpart of ``bayestpu/core/rng.py`` and of the key folding of the JAX
training loop. Every seed word is a pure counter hash of ``(seed, counter,
site, word)`` — the same hash the kernels use for their masks:

- ``sample_seeds``: the counter is the MC sample, so sample *i*'s seeds do
  not depend on how many samples are drawn, and the temporal and spatial
  mappings (and any split of the sample axis) see the same masks for
  sample *i*.
- ``step_seeds``: the counter is the training step (``fold_in(key, step)``
  then one ``make_rng`` per site, ``bayestpu/train/loop.py:92,150``), so a
  resumed run repeats the masks of an uninterrupted one. Its words lie in
  the upper half of the word axis, a stream distinct from
  ``sample_seeds``'s for every seed.

The numbers differ from the JAX package's threefry keys; tests that compare
the two packages feed the seeds captured from JAX instead.
"""

from __future__ import annotations

import torch

from bayestpu_torch.kernels.masked_matmul import coord_bits, seed_stream

# first word of the training stream: sample_seeds uses words [0, 2·sites)
_STEP_WORD0 = 1 << 31
# eval step i draws at step EVAL_STEP0 + i (``loop.py:214,447``)
EVAL_STEP0 = 10_000_000


def _seeds(seed: int, counter: torch.Tensor, num_sites: int, word0: int
           ) -> torch.Tensor:
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    stream = seed_stream(s & 0xFFFFFFFF, s >> 32)
    word = (word0 + 2 * torch.arange(num_sites, dtype=torch.int64)[:, None]
            + torch.arange(2, dtype=torch.int64)[None, :])
    bits = coord_bits(counter[..., None, None], word, stream)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def sample_seeds(seed: int, num_samples: int, num_sites: int
                 ) -> torch.Tensor:
    """(num_samples, num_sites, 2) int32 seeds on the CPU."""
    return _seeds(seed, torch.arange(num_samples, dtype=torch.int64),
                  num_sites, 0)


def step_seeds(seed: int, step, num_sites: int) -> torch.Tensor:
    """Seeds of training step ``step`` (an int, or a 1-D sequence of steps):
    (num_sites, 2) int32, or (len(step), num_sites, 2), on the CPU."""
    return _seeds(seed, torch.as_tensor(step, dtype=torch.int64), num_sites,
                  _STEP_WORD0)
