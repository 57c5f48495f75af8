"""Plain reference of a training step of a multi-exit model: the EED loss
(arXiv:2308.06849's exit-ensemble distillation), the gradient, clipping by
the global norm, SGD with momentum under a cosine schedule.

- loss = Σ_exits CE(exit) + Σ_{middle exits} mean((exit − t)²)
  + mean((final − t)²), t the mean of all exits' logits, held constant;
- the gradients of every parameter, scaled by clip/‖g‖ when the global
  norm ‖g‖ reaches ``clip``;
- momentum m ← g + μ·m, parameter p ← p − lr(count)·m with
  lr(c) = lr₀·½(1 + cos(π·min(c, T)/T)), the count from 0.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.common import Numerics, step_pairs

BUFFERS = ("bn_mean", "bn_var")


def eed_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (E, B, C), labels (B,)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels[None, :, None].expand(
        logits.shape[0], -1, 1)).squeeze(-1).mean(-1)
    target = logits.mean(0).detach()
    sq = ((logits - target) ** 2).mean((1, 2))
    return ce.sum() + sq.sum()


def cosine_lr(lr: float, decay_steps: int, count: int) -> float:
    c = min(count, decay_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))


def trainable(specs: list) -> list[str]:
    return [name for name, _, kind, _ in specs if kind not in BUFFERS]


def follow(ref, cfg: dict, params: dict, xs, ys, seed: int, steps: int,
           hp: dict, num: Numerics = Numerics(), rows: int | None = None,
           frozen: bool = False) -> dict:
    """``steps`` steps from ``params`` on batches xs[t], ys[t] under step
    t's seed pairs; ``rows`` keeps only a batch's first rows (the
    half-batch fault), ``frozen`` leaves the parameters and the momentum
    as they were (a step that returns its state unchanged). Returns the
    losses, the first step's clipped gradient (the momentum after one
    step) and each parameter's change."""
    names = trainable(ref.param_specs(cfg))
    p = {k: v.detach().clone().requires_grad_(k in names)
         for k, v in params.items()}
    mom = {k: torch.zeros_like(p[k]) for k in names}
    sites = ref.num_sites(cfg)
    losses, first = [], None
    for t in range(steps):
        x, y = xs[t], ys[t]
        if rows is not None:
            x, y = x[:rows], y[:rows]
        logits = ref.forward(p, x, step_pairs(seed, t, sites).to(x.device),
                             cfg, num, train=True)
        loss = eed_loss(logits, y)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = 1.0 if norm < hp["clip"] else hp["clip"] / norm
            lr = cosine_lr(hp["lr"], hp["decay_steps"], t)
            for k, g in zip(names, grads):
                if frozen:
                    continue
                mom[k] = g * scale + hp["momentum"] * mom[k]
                p[k] -= lr * mom[k]
        losses.append(float(loss.detach()))
        if t == 0:
            first = {k: mom[k].clone() for k in names}
    return {"losses": losses, "first": first,
            "change": {k: (p[k] - params[k]).detach() for k in names}}
