"""Confidence-gated early exit on the device (counterpart of
``bayestpu/engine/inference.py``).

The reference simulates early exit on the host, one instance at a time
(``results_analyzer.py:606-630``): walk the exits from index 1 upward, take
the first whose confidence clears the threshold, else the final exit. Here,
as in the JAX package, every exit's probabilities come from one forward and
each row's earliest confident exit is gathered from them on whatever device
they lie on, with no copy to the host. The FLOPs that an early exit saves
are accounted as the reference does (``metrics.flops``).

Confidence rules (``results_analyzer.py:728-734``): ``max``, the top-1
probability above the threshold; ``margin``, top-1 minus top-2 above it
(the reference's ``diff=True``). Exit 0 is never an early-exit candidate in
the reference's loop, so ``first_exit`` is 1 by default.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bayestpu_torch.metrics.ece import eval_metrics


class EarlyExitResult(NamedTuple):
    probs: torch.Tensor      # (B, C) each instance's selected prediction
    exit_idx: torch.Tensor   # (B,) int64 chosen exit
    exit_frac: torch.Tensor  # (E,) share of the batch leaving at each exit


def _confidence(probs: torch.Tensor, rule: str) -> torch.Tensor:
    if rule == "max":
        return probs.amax(dim=-1)
    if rule == "margin":
        # values only: which of two tied entries top-k names does not matter
        top2 = torch.topk(probs, 2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]).abs()
    raise ValueError(f"unknown confidence rule {rule!r}")


def early_exit_select(probs: torch.Tensor, threshold: float,
                      rule: str = "max", first_exit: int = 1
                      ) -> EarlyExitResult:
    """Each instance's earliest confident exit from probs (E, B, C), the
    per-exit (MC-averaged) probabilities; the final exit always takes what
    is left."""
    n_exits, b, c = probs.shape
    confident = _confidence(probs, rule) > threshold          # (E, B), new
    idx = torch.arange(n_exits, device=probs.device)[:, None]
    confident = confident & (idx >= first_exit)
    confident[-1] = True
    # argmax returns the first maximal index: the earliest True
    exit_idx = torch.argmax(confident.to(torch.uint8), dim=0)
    sel = torch.gather(probs, 0, exit_idx[None, :, None].expand(1, b, c))[0]
    frac = torch.nn.functional.one_hot(exit_idx, n_exits).float().mean(0)
    return EarlyExitResult(sel, exit_idx, frac)


def confidence_exiting(probs: torch.Tensor, labels: torch.Tensor,
                       threshold: float, rule: str = "max",
                       first_exit: int = 1) -> dict[str, torch.Tensor]:
    """acc / NLL / MSE / ECE of the early-exit prediction at one threshold
    and the mean exit, as device scalars (``confidence_exiting``,
    ``results_analyzer.py:606-630``)."""
    res = early_exit_select(probs, threshold, rule, first_exit)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=probs.device)
    mets = eval_metrics(res.probs, labels)
    mets["mean_exit"] = res.exit_idx.float().mean()
    return mets


# the paper's threshold sweep (results_analyzer.py:551)
REFERENCE_THRESHOLDS = (0.1, 0.15, 0.25, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95,
                        0.99, 0.999)


def threshold_sweep(probs: torch.Tensor, labels: torch.Tensor,
                    thresholds=REFERENCE_THRESHOLDS, rule: str = "max",
                    first_exit: int = 1) -> list[dict]:
    """``confidence_exiting`` at each threshold, each row fetched to the
    host in one copy."""
    out = []
    for t in thresholds:
        m = confidence_exiting(probs, labels, t, rule, first_exit)
        vals = torch.stack([v.float() for v in m.values()]).tolist()
        out.append({"threshold": t, **dict(zip(m, vals))})
    return out
