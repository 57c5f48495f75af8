"""Predictive-entropy (aPE) metrics (counterpart of
``bayestpu/metrics/entropy.py``; the OOD noise generators come with the
engine's OOD check in a later slice)."""

from __future__ import annotations

import torch

_EPS = 1e-12


def predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Entropy of each predictive distribution; probs (..., C) → (...)."""
    return -torch.sum(probs * torch.log(probs + _EPS), dim=-1)


def mean_predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """aPE: average predictive entropy over a batch."""
    return predictive_entropy(probs).mean()
