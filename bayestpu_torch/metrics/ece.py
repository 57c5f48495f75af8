"""Calibration metrics: accuracy, NLL, Brier MSE, equal-mass and
equal-width ECE (counterpart of ``bayestpu/metrics/ece.py:31-127``).

All take probabilities (B, C) (the MC mean) and integer labels (B,).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(probs, dim=-1) == labels).float().mean()


def nll(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the true class."""
    p = torch.clamp(probs, _EPS, 1.0)
    return -torch.log(p).gather(-1, labels[:, None])[:, 0].mean()


def brier_mse(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean squared error against one-hot labels."""
    onehot = torch.nn.functional.one_hot(labels, probs.shape[-1]).to(
        probs.dtype)
    return torch.sum((probs - onehot) ** 2, dim=-1).mean()


def _confidence_correct(probs: torch.Tensor, labels: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    pred = torch.argmax(probs, dim=-1)
    conf = probs.gather(-1, pred[:, None])[:, 0]
    conf = conf / torch.clamp(probs.sum(dim=-1), min=_EPS)  # renormalize
    return conf, (pred == labels).float()


def ece_hist(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 15,
             order: int = 1) -> torch.Tensor:
    """Adaptive (equal-mass) binned ECE: bin edges at every
    ``len/n_bins``-th sorted confidence, bins half-open ``(lo, hi]``."""
    conf, correct = _confidence_correct(probs, labels)
    n = conf.shape[0]
    x = torch.sort(conf).values
    bin_count = n // n_bins
    idx = torch.clamp(torch.arange(1, n_bins + 1, device=conf.device)
                      * bin_count, max=n - 1)
    uppers = x[idx].clone()
    uppers[-1] = 1.0
    lowers = torch.cat([torch.zeros(1, dtype=conf.dtype, device=conf.device),
                        uppers[:-1]])
    in_bin = ((conf[None, :] > lowers[:, None])
              & (conf[None, :] <= uppers[:, None])).float()
    cnt = in_bin.sum(dim=1)
    prop = cnt / n
    mean_conf = (in_bin * conf[None, :]).sum(dim=1) / torch.clamp(cnt, min=1.0)
    mean_acc = (in_bin * correct[None, :]).sum(dim=1) / torch.clamp(cnt,
                                                                   min=1.0)
    gap = torch.abs(mean_conf - mean_acc) ** order
    return torch.where(cnt > 0, gap * prop, torch.zeros_like(gap)).sum()


def ece_bins(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 10
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Equal-width per-bin partial sums (count, conf_sum, acc_sum); bin i
    covers (i/n, (i+1)/n], confidence 0 lands in bin 0."""
    conf, correct = _confidence_correct(probs, labels)
    bin_idx = torch.clamp(torch.ceil(conf * n_bins).to(torch.int64) - 1, 0,
                          n_bins - 1)
    onehot = torch.nn.functional.one_hot(bin_idx, n_bins).float()
    return onehot.sum(dim=0), onehot.T @ conf, onehot.T @ correct


def ece_from_bins(cnt: torch.Tensor, conf_sum: torch.Tensor,
                  acc_sum: torch.Tensor) -> torch.Tensor:
    n = cnt.sum()
    gap = torch.abs(conf_sum / torch.clamp(cnt, min=1.0)
                    - acc_sum / torch.clamp(cnt, min=1.0))
    return torch.where(cnt > 0, gap * cnt / n, torch.zeros_like(gap)).sum()


def ece_equal_width(probs: torch.Tensor, labels: torch.Tensor,
                    n_bins: int = 10) -> torch.Tensor:
    return ece_from_bins(*ece_bins(probs, labels, n_bins))


def eval_metrics(probs: torch.Tensor, labels: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """acc / NLL / MSE / equal-mass ECE / equal-width ECE."""
    return {
        "acc": accuracy(probs, labels),
        "nll": nll(probs, labels),
        "mse": brier_mse(probs, labels),
        "ece_hist": ece_hist(probs, labels),
        "ece_ew10": ece_equal_width(probs, labels),
    }
