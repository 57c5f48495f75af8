"""Optimizer / LR-schedule factory and the reference training recipes.

Counterpart of ``bayestpu/train/optim.py:27-112``. The JAX package builds
optax chains; the port carries the same chains in a few functional
transforms over dicts of tensors (name → tensor, the model's
``named_parameters`` order), each the torch twin of one optax transform, so
an update equals optax's update for update:

- ``clip_by_global_norm``: scales by ``max_norm/norm`` only when
  ``norm ≥ max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_``
  adds 1e-6 and is not used);
- ``add_decayed_weights`` sits between the clip and SGD (torch SGD's
  coupled weight decay);
- ``trace`` (momentum), ``scale_by_adam`` and ``scale_by_learning_rate``
  as in optax, the schedule's count starting at 0 on the first update;
- ``multi_steps``: ``optax.MultiSteps``, the running mean of k gradients,
  then one update of the inner chain (zero updates in between).

Schedules are evaluated on the host in numpy float32 with optax's order of
operations, so a step size is the f32 value optax computes (the cosine's
``cos`` may differ from XLA's in the last bit); a count lives on the host as
a Python int, so no update waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

Params = dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    """``init(params) → state`` and ``update(updates, state, params) →
    (updates, state)``, as ``optax.GradientTransformation``."""

    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params | None], tuple[Params, Any]]


def global_norm(tensors: Params) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every tensor, a
    0-dim tensor on their device."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors.values()))


def apply_updates(params: Params, updates: Params) -> None:
    """``optax.apply_updates`` in place: ``p += u`` for every parameter."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name])


# ------------------------------------------------------------- schedules


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(np.float32(value))


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax's with ``alpha=0``, ``exponent=1``: ``init·½(1 + cos(π·c/T))``
    with c capped at T."""
    if not decay_steps > 0:
        raise ValueError("the cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps=}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                             / f32(decay_steps)))
        return float(f32(init_value) * cosine)

    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict[int, float]
                                ) -> Schedule:
    if any(s < 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("piecewise_constant_schedule expects non-negative "
                         "scale factors")
    f32 = np.float32

    def schedule(count: int) -> float:
        v = f32(init_value)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            ind = f32(max(0.0, np.sign(threshold - count)))
            v = v * ind + (f32(1) - ind) * f32(scale) * v
        return float(v)

    return schedule


# ------------------------------------------------------------ transforms


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return {k: torch.where(trigger, t, (t / g_norm) * max_norm)
                for k, t in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return {k: g + weight_decay * params[k]
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def trace(decay: float) -> GradientTransformation:
    """Momentum without Nesterov: ``t ← g + decay·t``; the update is t."""
    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(updates, state, params=None):
        new = {k: g + decay * state[k] for k, g in updates.items()}
        return new, new

    return GradientTransformation(init, update)


def scale_by_adam() -> GradientTransformation:
    """optax's with its defaults b1 0.9, b2 0.999, eps 1e-8, eps_root 0."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params):
        return (0, {k: torch.zeros_like(p) for k, p in params.items()},
                {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates, state, params=None):
        count, mu, nu = state
        mu = {k: (1 - b1) * g + b1 * mu[k] for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * nu[k] for k, g in updates.items()}
        count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        out = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
               for k in updates}
        return out, (count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    """``−schedule(count)·g``, the count (the state) starting at 0."""
    def update(updates, count, params=None):
        step = -schedule(count)
        return {k: step * g for k, g in updates.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


def sgd(schedule: Schedule, momentum: float | None = None
        ) -> GradientTransformation:
    parts = ([trace(momentum)] if momentum is not None else [])
    return chain(*parts, scale_by_learning_rate(schedule))


def adam(schedule: Schedule) -> GradientTransformation:
    return chain(scale_by_adam(), scale_by_learning_rate(schedule))


def adamw(schedule: Schedule, weight_decay: float
          ) -> GradientTransformation:
    return chain(scale_by_adam(), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


def multi_steps(tx: GradientTransformation, every_k: int
                ) -> GradientTransformation:
    """``optax.MultiSteps(tx, every_k_schedule=every_k)``: the running mean
    ``acc + (g − acc)/(n + 1)`` of ``every_k`` gradients, one update of
    ``tx`` on it at the k-th, zero updates before it."""
    def init(params):
        return (0, tx.init(params),
                {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates, state, params=None):
        mini_step, inner, acc = state
        acc = {k: acc[k] + (g - acc[k]) / (mini_step + 1)
               for k, g in updates.items()}
        if mini_step < every_k - 1:
            return ({k: torch.zeros_like(g) for k, g in updates.items()},
                    (mini_step + 1, inner, acc))
        out, inner = tx.update(acc, inner, params)
        return out, (0, inner, {k: torch.zeros_like(a)
                                for k, a in acc.items()})

    return GradientTransformation(init, update)


# --------------------------------------------------------------- recipes


@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    optimizer: str = "sgd"
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    scheduler: str = "multistep"     # multistep | cosine | constant | plateau
    milestones: tuple[int, ...] = (75, 130, 180)
    gamma: float = 0.1
    t_max: int = 200                 # cosine period (epochs)
    plateau_factor: float = 0.1      # plateau: LR × factor after
    plateau_patience: int = 10       # ... this many non-improving epochs
    epochs: int = 200
    batch_size: int = 128
    test_batch_size: int = 250
    grad_clip: float = 10.0
    patience: int = 25
    accum_steps: int = 1             # gradient accumulation


RECIPES: dict[str, TrainRecipe] = {
    "resnet18": TrainRecipe(),
    "resnet20": TrainRecipe(),
    "vgg19": TrainRecipe(momentum=0.9, scheduler="cosine", t_max=200),
    "lenet": TrainRecipe(optimizer="adam", lr=1e-3, weight_decay=0.0,
                         scheduler="constant", epochs=30, batch_size=128),
    "vgg11": TrainRecipe(optimizer="adam", lr=1e-3, weight_decay=0.0,
                         scheduler="cosine", t_max=100, epochs=100),
}


def get_schedule(recipe: TrainRecipe, steps_per_epoch: int) -> Schedule:
    if recipe.scheduler == "multistep":
        boundaries = {m * steps_per_epoch: recipe.gamma
                      for m in recipe.milestones}
        return piecewise_constant_schedule(recipe.lr, boundaries)
    if recipe.scheduler == "cosine":
        return cosine_decay_schedule(recipe.lr,
                                     recipe.t_max * steps_per_epoch)
    if recipe.scheduler in ("constant", "plateau"):
        # plateau: the val-driven LR reduction lives in
        # ``train_loop(plateau_factor=..)``
        return constant_schedule(recipe.lr)
    raise ValueError(f"unknown scheduler {recipe.scheduler!r}")


def get_optimizer(recipe: TrainRecipe, steps_per_epoch: int = 1
                  ) -> GradientTransformation:
    """The chain clip → (wd) → optimizer(schedule), wrapped in
    ``multi_steps`` when ``recipe.accum_steps > 1``."""
    sched = get_schedule(recipe, steps_per_epoch)
    if recipe.optimizer == "sgd":
        opt = sgd(sched, momentum=recipe.momentum or None)
    elif recipe.optimizer == "adam":
        opt = adam(sched)
    elif recipe.optimizer == "adamw":
        opt = adamw(sched, weight_decay=recipe.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {recipe.optimizer!r}")
    parts = []
    if recipe.grad_clip:
        parts.append(clip_by_global_norm(recipe.grad_clip))
    if recipe.weight_decay and recipe.optimizer == "sgd":
        parts.append(add_decayed_weights(recipe.weight_decay))
    parts.append(opt)
    tx = chain(*parts)
    if recipe.accum_steps > 1:
        tx = multi_steps(tx, recipe.accum_steps)
    return tx


def get_recipe(backbone: str, **overrides) -> TrainRecipe:
    base = RECIPES.get(backbone.lower(), TrainRecipe())
    return dataclasses.replace(base, **overrides) if overrides else base
