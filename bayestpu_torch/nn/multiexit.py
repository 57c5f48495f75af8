"""Multi-exit output protocol and exit-ensembling (counterpart of
``bayestpu/nn/multiexit.py``).

Exits are stacked on the axis just before (batch, classes), so a
single-sample forward gives logits (E, B, C) and a spatial forward over S
samples gives (S, E, B, C).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ExitOutputs(NamedTuple):
    """logits: (..., num_exits, batch, classes), final exit last.
    features: (num_exits, batch, feat) pre-logit features, or () when the
    exits' feature widths differ."""

    logits: torch.Tensor
    features: torch.Tensor | tuple = ()

    @property
    def num_exits(self) -> int:
        return self.logits.shape[-3]

    @property
    def final(self) -> torch.Tensor:
        return self.logits[..., -1, :, :]


def stack_exits(exit_list: list[torch.Tensor],
                feature_list: list[torch.Tensor] | None = None
                ) -> ExitOutputs:
    feats = (torch.stack(feature_list, dim=-3)
             if feature_list and len({f.shape for f in feature_list}) == 1
             else ())
    return ExitOutputs(logits=torch.stack(exit_list, dim=-3), features=feats)


def exit_ensemble_probs(logits: torch.Tensor) -> torch.Tensor:
    """Cumulative softmax-ensemble across exits: row k of the (E, B, C)
    result is the mean of softmax(logits[0..k])."""
    probs = torch.softmax(logits, dim=-1)
    csum = torch.cumsum(probs, dim=0)
    denom = torch.arange(1, logits.shape[0] + 1, dtype=probs.dtype,
                         device=probs.device)
    return csum / denom[:, None, None]


def ensemble_logit_mean(logits: torch.Tensor) -> torch.Tensor:
    """Mean of exit logits — the EED distillation target."""
    return torch.mean(logits, dim=0)
