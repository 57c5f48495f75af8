"""Multi-exit training losses: Exit-Ensemble Distillation (EED) and metrics.

Counterpart of ``bayestpu/train/losses.py:31-126``, on stacked exit logits
(E, B, C):

- classification term: CE on every exit, the final one included;
- distillation target: the detached mean of all exit logits when
  ``use_eed``, else the detached final exit's logits (``stop_gradient`` in
  the JAX package);
- output distillation: MSE between each exit's logits and the target, or KL
  at temperature T with the 0.1·T² weighting;
- optional feature distillation with the ReLU-support mask.

Single-exit models degenerate to plain CE.
"""

from __future__ import annotations

import dataclasses

import torch

from bayestpu_torch.nn.multiexit import exit_ensemble_probs


@dataclasses.dataclass(frozen=True)
class EEDConfig:
    use_eed: bool = True
    loss_output: str = "MSE"         # "MSE" | "KL"
    use_feature_dist: bool = False
    temperature: float = 3.0


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch; logits (..., B, C), labels (B,)
    → (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long()[:, None].expand(logp.shape[:-1] + (1,))
    return -torch.mean(torch.gather(logp, -1, idx)[..., 0], dim=-1)


def eed_loss(exit_logits: torch.Tensor, labels: torch.Tensor,
             features: torch.Tensor | None = None,
             cfg: EEDConfig = EEDConfig()) -> torch.Tensor:
    """EED training loss.

    exit_logits: (E, B, C), exit -1 is the final head; labels: (B,) int
    class ids; features: optional (E, B, F) for feature distillation.
    """
    n_exits = exit_logits.shape[0]
    l_c = torch.sum(_ce(exit_logits, labels))
    if n_exits == 1:
        return l_c

    final = exit_logits[-1]
    middles = exit_logits[:-1]
    if cfg.use_eed:
        target = torch.mean(exit_logits, dim=0).detach()
    else:
        target = final.detach()

    if cfg.loss_output == "MSE":
        l_o = torch.sum(torch.mean((middles - target) ** 2, dim=(1, 2)))
        if cfg.use_eed:
            l_o = l_o + torch.mean((final - target) ** 2)
    elif cfg.loss_output == "KL":
        t = cfg.temperature
        soft_target = torch.softmax(target / t, dim=-1)

        def kd(logits: torch.Tensor) -> torch.Tensor:
            logp = torch.log_softmax(logits / t, dim=-1)
            return -torch.mean(torch.sum(logp * soft_target, dim=-1), dim=-1)

        l_o = 0.1 * torch.sum(kd(middles)) * t * t
        if cfg.use_eed:
            l_o = l_o + 0.1 * kd(final) * t * t
    else:
        raise ValueError(f"unknown loss_output {cfg.loss_output!r}")

    total = l_c + l_o

    if (cfg.use_feature_dist and features is not None
            and features.shape[0] > 1):
        f_target = torch.mean(features, dim=0).detach()

        def fdist(f: torch.Tensor) -> torch.Tensor:
            support = ((f > 0) | (f_target > 0)).to(f.dtype)
            return torch.mean(torch.abs((f - f_target) ** 2 * support),
                              dim=(-2, -1))

        l_f = torch.sum(fdist(features[:-1]))
        if cfg.use_eed:
            l_f = l_f + fdist(features[-1])
        total = total + l_f
    return total


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int = 1
                 ) -> torch.Tensor:
    """Fraction of rows whose label is in the top-k predictions; logits
    (..., B, C) → (...)."""
    idx = torch.topk(logits, k, dim=-1).indices
    hit = torch.any(idx == labels.long()[:, None], dim=-1)
    return torch.mean(hit.float(), dim=-1)


def multi_exit_accuracy(exit_logits: torch.Tensor, labels: torch.Tensor,
                        tops: tuple[int, ...] = (1,)
                        ) -> dict[str, torch.Tensor]:
    """Per-exit top-k accuracies plus the cumulative exit-ensemble accuracy
    and the final exit's mean max-probability, as 0-dim tensors on the
    logits' device (nothing is fetched to the host)."""
    out: dict[str, torch.Tensor] = {}
    n_exits = exit_logits.shape[0]
    for k in tops:
        accs = topk_correct(exit_logits, labels, k)
        for e in range(n_exits):
            out[f"exit{e}_top{k}"] = accs[e]
    ens = topk_correct(exit_ensemble_probs(exit_logits), labels, 1)
    for e in range(n_exits):
        out[f"ens{e}_top1"] = ens[e]
    out["avg_maxprob"] = torch.mean(torch.max(
        torch.softmax(exit_logits[-1], dim=-1), dim=-1).values)
    return out
