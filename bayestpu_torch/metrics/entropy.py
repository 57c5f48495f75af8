"""Predictive-entropy (aPE) metrics and the OOD noise probe (counterpart of
``bayestpu/metrics/entropy.py``).

The noise comes from a seeded ``torch.Generator`` on the CPU, so it is the
same on every device for a seed; its values differ from JAX's threefry
draws, with the same distribution.
"""

from __future__ import annotations

import torch

from bayestpu_torch.data.datasets import DATASET_STATS

_EPS = 1e-12

# Per-channel noise stats of the reference's OOD protocol
# (``bayestpu/metrics/entropy.py:38-44``), not the normalisation stats.
NOISE_STATS: dict[str, tuple[tuple[float, ...], tuple[float, ...]]] = {
    "mnist": ((0.0,), (1.0,)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "cifar100": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "svhn": ((129.3 / 255, 124.1 / 255, 112.4 / 255),
             (68.2 / 255, 65.4 / 255, 70.4 / 255)),
}


def predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Entropy of each predictive distribution; probs (..., C) → (...)."""
    return -torch.sum(probs * torch.log(probs + _EPS), dim=-1)


def mean_predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """aPE: average predictive entropy over a batch."""
    return predictive_entropy(probs).mean()


def random_noise_like(generator: torch.Generator, shape: tuple[int, ...],
                      mean: float = 0.0, std: float = 1.0) -> torch.Tensor:
    """Gaussian noise images of a given mean and std (f32, CPU)."""
    return mean + std * torch.randn(shape, generator=generator)


def random_noise_data(generator: torch.Generator, dataset: str,
                      shape: tuple[int, ...], normalized: bool = True
                      ) -> torch.Tensor:
    """Dataset-matched OOD noise (f32, CPU) with the reference's fixed
    per-channel stats ``NOISE_STATS``; ``shape`` is (..., C) channels-last.
    With ``normalized`` the raw-space noise is standardised by
    ``DATASET_STATS``, as the models' inputs are."""
    if dataset not in NOISE_STATS:
        raise KeyError(f"no noise stats for dataset {dataset!r}; "
                       f"known: {sorted(NOISE_STATS)}")
    mean, std = (torch.tensor(v, dtype=torch.float32)
                 for v in NOISE_STATS[dataset])
    if shape[-1] != mean.shape[0]:
        raise ValueError(f"shape {shape} has {shape[-1]} channels; "
                         f"{dataset} stats have {mean.shape[0]}")
    noise = mean + std * torch.randn(shape, generator=generator)
    if normalized:
        nm, ns = (torch.tensor(v, dtype=torch.float32)
                  for v in DATASET_STATS[dataset])
        noise = (noise - nm) / ns
    return noise
