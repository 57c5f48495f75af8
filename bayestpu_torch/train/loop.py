"""Training loop: the train step and the epoch loop with early stopping.

Counterpart of ``bayestpu/train/loop.py``. A step runs the model in train
mode (BatchNorm on batch statistics, the MC-dropout sites active through
the trainable ``dropout_matmul`` and ``dropout_conv``, the Masksembles sites
splitting the batch into one group per mask), the EED loss, the backward,
the optimizer chain of ``train.optim`` and the BatchNorm running averages.
The JAX
package jits a step (``make_train_step``) or a whole epoch (``lax.scan`` in
``make_train_epoch``); PyTorch runs eagerly, so a Python loop over batches
is the port's counterpart of both.

Randomness is a pure function of (seed, step): step ``i`` draws its masks
from ``core.rng.step_seeds(seed, i, n_sites)`` (the JAX ``fold_in(key, i)``)
and eval batch ``i`` from step ``EVAL_STEP0 + i``; an epoch's reshuffle is a
pure function of (seed, epoch). Metrics stay on the device and are fetched
once per epoch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from bayestpu_torch.core.rng import EVAL_STEP0, step_seeds
from bayestpu_torch.engine.engine import resolve_device
from bayestpu_torch.interop.from_flax import (buffers_by_collection,
                                              to_flax_variables)
from bayestpu_torch.train.losses import (EEDConfig, _ce, eed_loss,
                                         multi_exit_accuracy)
from bayestpu_torch.train.optim import (GradientTransformation,
                                        apply_updates, global_norm)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm buffers live in it), the
    optimizer state and the number of steps taken."""

    model: nn.Module
    opt_state: Any
    step: int = 0

    def variables(self) -> dict:
        """``{"params": …, "batch_stats": …}`` (and ``"masks"`` for a
        Masksembles model) as nested numpy dicts, what
        ``BayesEngine.attach`` takes."""
        return to_flax_variables(self.model)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_state(model: nn.Module, tx: GradientTransformation, seed: int,
                 sample_input: Any, device: str | torch.device = "cuda"
                 ) -> TrainState:
    """Fresh parameters from Flax's initializers drawn from ``seed``, the
    model moved to ``device`` (the card unless the caller asks for the CPU;
    no card raises) in train mode, and the optimizer's initial state."""
    dev = resolve_device(device)
    x = torch.as_tensor(sample_input)
    if tuple(x.shape[1:]) != model.input_shape:
        raise ValueError(f"sample_input {tuple(x.shape)} does not fit the "
                         f"model's input {model.input_shape}")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev).train()
    return TrainState(model, tx.init(dict(model.named_parameters())))


def make_train_step(model: nn.Module, tx: GradientTransformation,
                    eed_cfg: EEDConfig = EEDConfig()) -> Callable:
    """``step(state, x, y, seeds, lr_scale=1.0) → metrics``: one update of
    ``state`` in place (parameters, BN buffers, optimizer state, ``step``).

    x: (B, H, W, C) f32 and y: (B,) int labels on the model's device; seeds:
    (n_sites, 2) int32 there (``step_seeds(seed, state.step, n_sites)``).
    ``lr_scale`` multiplies the updates (the plateau LR reduction). Metrics
    are 0-dim device tensors: ``loss``, ``grad_norm`` (the global norm
    before the clip) and ``multi_exit_accuracy``.
    """

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   seeds: torch.Tensor, lr_scale: float = 1.0
                   ) -> dict[str, torch.Tensor]:
        model.train()
        params = dict(model.named_parameters())
        out = model(x, seeds)
        feats = (out.features if isinstance(out.features, torch.Tensor)
                 else None)
        loss = eed_loss(out.logits, y, feats, eed_cfg)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 params)
            if lr_scale != 1.0:
                updates = {k: u * lr_scale for k, u in updates.items()}
            apply_updates(params, updates)
            state.step += 1
            return {"loss": loss.detach(), "grad_norm": global_norm(grads),
                    **multi_exit_accuracy(out.logits, y)}

    return train_step


def make_eval_step(model: nn.Module, eed_cfg: EEDConfig = EEDConfig()
                   ) -> Callable:
    """``eval_step(x, y, seeds) → metrics``: one stochastic pass of the model
    in eval mode (running BN statistics, one MC sample), its
    ``multi_exit_accuracy``, the EED loss ``val_eed`` and the final exit's
    CE ``val_ce``. The model's mode is restored after."""

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor, seeds: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            out = model(x, seeds)
        finally:
            model.train(was_training)
        m = multi_exit_accuracy(out.logits, y)
        m["val_eed"] = eed_loss(out.logits, y, None, eed_cfg)
        m["val_ce"] = _ce(out.logits[-1], y)
        return m

    return eval_step


def _to_device(x: Any, y: Any, dev: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.int64, device=dev))


def _uniform(batches: list) -> bool:
    return (len({tuple(b[0].shape) for b in batches}) == 1
            and len({tuple(b[1].shape) for b in batches}) == 1)


def _last_exit(m: dict) -> str:
    """Key of the final exit's top-1 in a ``multi_exit_accuracy`` dict."""
    e = max(int(k[4:-5]) for k in m
            if k.startswith("exit") and k.endswith("_top1"))
    return f"exit{e}_top1"


def train_loop(model: nn.Module, state: TrainState,
               tx: GradientTransformation,
               train_batches: Callable[[], Iterable], seed: int,
               num_epochs: int,
               val_batches: Callable[[], Iterable] | None = None,
               eed_cfg: EEDConfig = EEDConfig(),
               patience: int = 10,
               val_mode: str = "acc",
               mesh=None,
               checkpoint_dir: str | None = None,
               plateau_factor: float | None = None,
               plateau_patience: int = 10,
               reshuffle: bool = False,
               history: dict | None = None,
               log_fn: Callable[[str], None] = print) -> TrainState:
    """The epoch loop with early stopping and best-snapshot keeping
    (``loop.py:241-487``). ``model`` is ``state.model``.

    ``train_batches``/``val_batches`` return fresh iterables of (x, y)
    batches (numpy or torch). Batches of one shape are uploaded to the
    device once and reused every epoch; with ``reshuffle`` the examples are
    permuted each epoch by a pure function of (seed, epoch). ``val_mode``
    selects the early-stop metric: ``acc`` (final-exit top-1), ``eed`` or
    ``ce``. When it has not improved for ``patience`` epochs the loop stops;
    with validation the best epoch's parameters are put back at the end
    (the BN statistics stay those of the last step, as in the JAX loop).
    ``plateau_factor`` multiplies the updates by that factor after
    ``plateau_patience`` non-improving epochs. ``history`` is filled in
    place with per-epoch ``train_loss`` and ``val_metric`` lists.

    Data-parallel training (``mesh``) and rolling checkpoints
    (``checkpoint_dir``) are not ported yet and raise.
    """
    if val_mode not in ("acc", "eed", "ce"):
        raise ValueError(f"unknown val_mode {val_mode!r}")
    if mesh is not None:
        raise NotImplementedError("data-parallel training is not ported yet: "
                                  "ROADMAP Queue 1 item 13")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoints are not ported yet: ROADMAP "
                                  "Queue 1 item 14")
    if model is not state.model:
        raise ValueError("model must be state.model")
    dev = _device_of(model)
    n_sites = model.num_sites
    train_step = make_train_step(model, tx, eed_cfg)
    eval_step = make_eval_step(model, eed_cfg)

    best_metric, since_best = -float("inf"), 0
    best_params = {k: p.detach().clone()
                   for k, p in model.named_parameters()}
    lr_scale, since_plateau = 1.0, 0
    cached: tuple[torch.Tensor, torch.Tensor] | None = None
    if history is not None:
        history.setdefault("train_loss", [])
        history.setdefault("val_metric", [])

    def epoch_batches(epoch: int) -> list:
        """This epoch's (x, y) device batches."""
        nonlocal cached
        if cached is None:
            batches = list(train_batches())
            pairs = [_to_device(x, y, dev) for x, y in batches]
            if not batches or not _uniform(batches):
                return pairs
            cached = (torch.stack([x for x, _ in pairs]),
                      torch.stack([y for _, y in pairs]))
        xs, ys = cached
        if reshuffle:
            nb, bsz = xs.shape[:2]
            gen = torch.Generator().manual_seed(
                ((int(seed) << 32) + epoch) & 0x7FFFFFFFFFFFFFFF)
            perm = torch.randperm(nb * bsz, generator=gen).to(dev)
            xs = xs.reshape((nb * bsz,) + xs.shape[2:])[perm].reshape(
                xs.shape)
            ys = ys.reshape(-1)[perm].reshape(ys.shape)
        return list(zip(xs, ys))

    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        batches = epoch_batches(epoch)
        seeds = step_seeds(seed, range(state.step, state.step + len(batches)),
                           n_sites).to(dev)
        loss_sum = None
        for i, (x, y) in enumerate(batches):
            m = train_step(state, x, y, seeds[i], lr_scale)
            loss_sum = m["loss"] if loss_sum is None else loss_sum + m["loss"]
        ep_loss = (float(loss_sum) / len(batches)) if batches else 0.0
        msg = f"epoch {epoch}: loss {ep_loss:.4f}"
        if history is not None:
            history["train_loss"].append(ep_loss)

        if val_batches is not None:
            vbatches = list(val_batches())
            vseeds = step_seeds(seed, range(EVAL_STEP0,
                                            EVAL_STEP0 + len(vbatches)),
                                n_sites).to(dev)
            vsum = None
            for i, (x, y) in enumerate(vbatches):
                xd, yd = _to_device(x, y, dev)
                m = eval_step(xd, yd, vseeds[i])
                v = (m[_last_exit(m)] if val_mode == "acc"
                     else -m[f"val_{val_mode}"])
                vsum = v if vsum is None else vsum + v
            val = float(vsum) / len(vbatches) if vbatches else 0.0
            msg += f" val_{val_mode} {abs(val):.4f}"
            if history is not None:
                history["val_metric"].append(abs(val))
            if val > best_metric:
                best_params = {k: p.detach().clone()
                               for k, p in model.named_parameters()}
                best_metric, since_best, since_plateau = val, 0, 0
            else:
                since_best += 1
                since_plateau += 1
                if (plateau_factor is not None
                        and since_plateau >= plateau_patience):
                    lr_scale = float(np.float32(lr_scale)
                                     * np.float32(plateau_factor))
                    since_plateau = 0
                    log_fn(f"  plateau: lr scale → {lr_scale:.2e}")
                if since_best >= patience:
                    log_fn(msg + "  (early stop)")
                    _load_params(model, best_params)
                    return state
        log_fn(msg + f"  ({time.perf_counter() - t0:.1f}s)")

    if val_batches is not None:
        _load_params(model, best_params)
    return state


def _load_params(model: nn.Module, params: dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])


def bn_reestimate(model: nn.Module, xs: Iterable, seeds: torch.Tensor,
                  passes: int = 3) -> dict[str, torch.Tensor]:
    """Re-estimate the BatchNorm running statistics with frozen parameters
    (``loop.py:490-523``): ``passes`` momentum-averaged sweeps of the model
    in train mode over the batches ``xs``, each with the same ``seeds``
    (n_sites, 2), as the JAX sweep reuses one key. Updates the model's
    BatchNorm statistics in place and returns them by name (the
    ``batch_stats`` collection; a Masksembles bank is not one); the model's
    mode is restored."""
    was_training = model.training
    dev = _device_of(model)
    model.train()
    try:
        with torch.no_grad():
            for _ in range(max(passes, 1)):
                for x in xs:
                    model(torch.as_tensor(x, dtype=torch.float32,
                                          device=dev), seeds)
    finally:
        model.train(was_training)
    return buffers_by_collection(model)["batch_stats"]
