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

Data-parallel training (``mesh``, an ``engine.sharding.Mesh``; its data
axis) follows the JAX package's sharded step (``loop.py:315-328``), which
computes what the step on the whole batch computes: every rank holds the
whole batch and takes its rows, the masks keyed on their global rows, the
BatchNorm statistics taken over the data axis; the gradients are summed
over it and divided by its size before the clip and the optimizer, and
the metrics are reduced so every rank sees the global ones. The replicas
stay bit-identical.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from bayestpu_torch.core.rng import EVAL_STEP0, fold_seed, step_seeds
from bayestpu_torch.engine.engine import resolve_device
from bayestpu_torch.engine.sharding import (DATA_AXIS, all_reduce, at_rows,
                                            data_rows, replicate)
from bayestpu_torch.interop.from_flax import (buffers_by_collection,
                                              to_flax_variables)
from bayestpu_torch.nn.rows import Rows
from bayestpu_torch.train.losses import (EEDConfig, _ce, eed_loss,
                                         multi_exit_accuracy)
from bayestpu_torch.train.optim import (GradientTransformation,
                                        apply_updates, global_norm)
from bayestpu_torch.utils.profiler import span


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


class _DataShard:
    """This rank's share of a data-parallel step: its rows of a batch, the
    row context of the model, and the sums of the data axis (no mesh: the
    whole batch and no collective)."""

    def __init__(self, model: nn.Module, mesh):
        self.model, self.mesh = model, mesh
        self.size = 1 if mesh is None else mesh.shape[DATA_AXIS]
        self.group = None if mesh is None else mesh.data_group

    def rows(self, x: torch.Tensor, y: torch.Tensor):
        """(x, y, the model's row context) of this rank's rows."""
        if self.mesh is None:
            return x, y, contextlib.nullcontext()
        row0, n = data_rows(x.shape[0], self.mesh)
        return (x[row0:row0 + n], y[row0:row0 + n],
                at_rows(self.model, Rows(row0, x.shape[0], self.group)))

    def mean(self, tensors: dict) -> dict:
        """The means over the data axis of per-rank means (one all_reduce
        of them all)."""
        if self.mesh is None:
            return tensors
        names = list(tensors)
        flat = torch.cat([tensors[k].reshape(-1).float() for k in names])
        flat = all_reduce(flat, self.group) / self.size
        out, i = {}, 0
        for k in names:
            n = tensors[k].numel()
            out[k] = flat[i:i + n].view(tensors[k].shape).to(tensors[k].dtype)
            i += n
        return out


def make_train_step(model: nn.Module, tx: GradientTransformation,
                    eed_cfg: EEDConfig = EEDConfig(), mesh=None) -> Callable:
    """``step(state, x, y, seeds, lr_scale=1.0) → metrics``: one update of
    ``state`` in place (parameters, BN buffers, optimizer state, ``step``).

    x: (B, H, W, C) f32 and y: (B,) int labels on the model's device; seeds:
    (n_sites, 2) int32 there (``step_seeds(seed, state.step, n_sites)``).
    ``lr_scale`` multiplies the updates (the plateau LR reduction). Metrics
    are 0-dim device tensors: ``loss``, ``grad_norm`` (the global norm
    before the clip) and ``multi_exit_accuracy``. With ``mesh`` x and y are
    the whole batch on every rank of the data axis, each rank runs its rows
    and the step is the whole batch's (see the module docstring).
    Spans (``utils.profiler``): ``train.step`` around ``train.forward``,
    ``train.backward`` (the EED loss and the gradients) and
    ``train.update`` (the optimizer chain and the update).
    """
    shard = _DataShard(model, mesh)

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   seeds: torch.Tensor, lr_scale: float = 1.0
                   ) -> dict[str, torch.Tensor]:
        dev = x.is_cuda
        with span("train.step", dev):
            model.train()
            params = dict(model.named_parameters())
            x, y, rows = shard.rows(x, y)
            with rows:
                with span("train.forward", dev):
                    out = model(x, seeds)
                with span("train.backward", dev):
                    feats = (out.features
                             if isinstance(out.features, torch.Tensor)
                             else None)
                    loss = eed_loss(out.logits, y, feats, eed_cfg)
                    grads = shard.mean(dict(zip(params, torch.autograd.grad(
                        loss, list(params.values())))))
            with torch.no_grad():
                with span("train.update", dev):
                    updates, state.opt_state = tx.update(
                        grads, state.opt_state, params)
                    if lr_scale != 1.0:
                        updates = {k: u * lr_scale
                                   for k, u in updates.items()}
                    apply_updates(params, updates)
                state.step += 1
                m = shard.mean({"loss": loss.detach(),
                                **multi_exit_accuracy(out.logits, y)})
                return {"loss": m.pop("loss"),
                        "grad_norm": global_norm(grads), **m}

    return train_step


def make_eval_step(model: nn.Module, eed_cfg: EEDConfig = EEDConfig(),
                   mesh=None) -> Callable:
    """``eval_step(x, y, seeds) → metrics``: one stochastic pass of the model
    in eval mode (running BN statistics, one MC sample), its
    ``multi_exit_accuracy``, the EED loss ``val_eed`` and the final exit's
    CE ``val_ce``. The model's mode is restored after. With ``mesh``, as
    ``make_train_step``: each rank its rows, the metrics the whole
    batch's."""
    shard = _DataShard(model, mesh)

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor, seeds: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        x, y, rows = shard.rows(x, y)
        try:
            with rows:
                out = model(x, seeds)
        finally:
            model.train(was_training)
        m = multi_exit_accuracy(out.logits, y)
        m["val_eed"] = eed_loss(out.logits, y, None, eed_cfg)
        m["val_ce"] = _ce(out.logits[-1], y)
        return shard.mean(m)

    return eval_step


def _mean_metrics(ms: list[dict]) -> dict[str, torch.Tensor]:
    """The per-step metrics averaged over the steps, on the device."""
    return {k: torch.stack([m[k].float() for m in ms]).mean() for k in ms[0]}


def make_train_epoch(model: nn.Module, tx: GradientTransformation,
                     eed_cfg: EEDConfig = EEDConfig(),
                     augment_fn: Callable | None = None, mesh=None
                     ) -> Callable:
    """``epoch(state, xs, ys, seed, lr_scale=1.0) → metrics``: one
    ``make_train_step`` per batch of the stacked ``xs`` (n, B, H, W, C) and
    ``ys`` (n, B) on the model's device, step ``state.step + i`` on the
    seeds of that step; returns JAX's epoch metrics (``loss``,
    ``grad_norm``, ``multi_exit_accuracy``) averaged over the steps, on
    the device. ``augment_fn(fold_seed(seed, step), x, i)`` transforms
    batch i first (``i`` the index in the epoch, as in the JAX scan)."""
    train_step = make_train_step(model, tx, eed_cfg, mesh)

    def train_epoch(state: TrainState, xs: torch.Tensor, ys: torch.Tensor,
                    seed: int, lr_scale: float = 1.0
                    ) -> dict[str, torch.Tensor]:
        n = len(xs)
        seeds = step_seeds(seed, range(state.step, state.step + n),
                           model.num_sites).to(_device_of(model))
        ms = []
        for i in range(n):
            x = xs[i]
            if augment_fn is not None:
                x = augment_fn(fold_seed(seed, state.step), x, i)
            ms.append(train_step(state, x, ys[i], seeds[i], lr_scale))
        return _mean_metrics(ms)

    return train_epoch


def make_eval_epoch(model: nn.Module, eed_cfg: EEDConfig = EEDConfig(),
                    mesh=None) -> Callable:
    """``eval_epoch(xs, ys, seed) → metrics``: ``make_eval_step`` on each
    stacked batch, batch i at step ``EVAL_STEP0 + i``, the metrics averaged
    over the batches on the device."""
    eval_step = make_eval_step(model, eed_cfg, mesh)

    def eval_epoch(xs: torch.Tensor, ys: torch.Tensor, seed: int
                   ) -> dict[str, torch.Tensor]:
        seeds = step_seeds(seed, range(EVAL_STEP0, EVAL_STEP0 + len(xs)),
                           model.num_sites).to(_device_of(model))
        return _mean_metrics([eval_step(xs[i], ys[i], seeds[i])
                              for i in range(len(xs))])

    return eval_epoch


def _tensors_of(tree: Any) -> list[torch.Tensor]:
    """Every tensor of a nest of dicts, tuples and lists (an optimizer
    state), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors_of(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


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
               augment_fn: Callable | None = None,
               mesh=None,
               checkpoint_dir: str | None = None,
               checkpoint_every: int = 1,
               start_epoch: int = 0,
               best0: tuple[float, Any, int] | None = None,
               plateau_factor: float | None = None,
               plateau_patience: int = 10,
               cache_data: bool = True,
               reshuffle: bool = False,
               history: dict | None = None,
               log_fn: Callable[[str], None] = print) -> TrainState:
    """The epoch loop with early stopping and best-snapshot keeping
    (``loop.py:241-487``). ``model`` is ``state.model``.

    ``train_batches``/``val_batches`` return fresh iterables of (x, y)
    batches (numpy or torch). Batches of one shape are stacked on the device
    and trained by ``make_train_epoch`` (JAX's epoch scan); with
    ``cache_data`` (the default) they are uploaded once and reused every
    epoch (``train_batches`` is then consumed once), and with ``reshuffle``
    the cached examples are permuted each epoch by a pure function of
    (seed, epoch); without ``cache_data`` ``train_batches`` is drawn and
    uploaded every epoch, unshuffled, as in JAX. Batches of mixed shapes
    run one ``make_train_step`` each (JAX's per-step path).
    ``augment_fn(seed_of_step, x, index)`` transforms each training batch
    on the device (``data.augment.random_crop_flip``); ``seed_of_step`` is
    ``fold_seed(seed, step)``, and ``index`` is the batch's index in the
    epoch on the stacked path and ``state.step`` on the per-step path, the
    indices JAX's two paths pass.

    ``val_mode`` selects the early-stop metric: ``acc`` (final-exit top-1),
    ``eed`` or ``ce``. When it has not improved for ``patience`` epochs the
    loop stops; with validation the best epoch's parameters are put back at
    the end (the BN statistics stay those of the last step, as in the JAX
    loop). ``plateau_factor`` multiplies the updates by that factor after
    ``plateau_patience`` non-improving epochs. ``history`` is filled in
    place with per-epoch ``train_loss`` and ``val_metric`` lists.

    ``checkpoint_dir``: every ``checkpoint_every`` epochs (0: never) a full
    checkpoint (``train.checkpoint.save_checkpoint``) is written there,
    with the epoch and the early-stopping state in its ``aux``; at an early
    stop it is written before the best parameters are put back. Without
    validation its ``best_params`` are the live parameters. ``start_epoch``
    and ``best0 = (best_metric, best_params, since_best)`` resume from such
    a checkpoint's ``aux`` (``restore_checkpoint(with_aux=True)``): the
    run then continues bit-identically to an uninterrupted one (the
    plateau scale is not carried, as in JAX).

    ``mesh`` (an ``engine.sharding.Mesh``) trains data-parallel over its
    data axis: the mesh's first rank's parameters, BN buffers and optimizer
    state are broadcast to every rank first; every rank then reads the same
    batches (and the same permutation of a reshuffled epoch), runs its rows
    of each (``make_train_step(mesh=...)``), and logs, and keeps the
    history of, the global metrics; only the first rank calls ``log_fn``
    and writes checkpoints, and the others wait for each write on a
    ``broadcast``.

    JAX's ``has_batch_stats`` (its pytree's BatchNorm collection) and
    ``epoch_scan`` (its jitted scan) have no counterpart here: a port model
    updates its own BatchNorm buffers, and an epoch is always the step
    loop.
    """
    if val_mode not in ("acc", "eed", "ce"):
        raise ValueError(f"unknown val_mode {val_mode!r}")
    if model is not state.model:
        raise ValueError("model must be state.model")
    dev = _device_of(model)
    n_sites = model.num_sites
    first = not (mesh is not None and dist.is_initialized()
                 and dist.get_rank() != mesh.first)
    if mesh is not None:
        replicate(model, mesh)
        replicate(_tensors_of(state.opt_state), mesh)
        if not first:
            log_fn = _silent
    train_step = make_train_step(model, tx, eed_cfg, mesh)
    train_epoch = make_train_epoch(model, tx, eed_cfg, augment_fn, mesh)
    eval_step = make_eval_step(model, eed_cfg, mesh)

    if best0 is not None:
        best_metric, best_params, since_best = best0
    else:
        best_metric, since_best = -float("inf"), 0
        best_params = _snapshot(model)
    lr_scale, since_plateau = 1.0, 0
    cached: tuple[torch.Tensor, torch.Tensor] | None = None
    if history is not None:
        history.setdefault("train_loss", [])
        history.setdefault("val_metric", [])

    def epoch_batches(epoch: int):
        """This epoch's stacked (xs, ys) on the device, or its list of
        (x, y) device batches when their shapes differ."""
        nonlocal cached
        if cached is None:
            batches = list(train_batches())
            pairs = [_to_device(x, y, dev) for x, y in batches]
            if not batches or not _uniform(batches):
                return pairs
            stacked = (torch.stack([x for x, _ in pairs]),
                       torch.stack([y for _, y in pairs]))
            if not cache_data:
                return stacked
            cached = stacked
        xs, ys = cached
        if reshuffle:
            nb, bsz = xs.shape[:2]
            # JAX: fold_in(fold_in(key, 0x51), epoch); the generator keeps
            # the seed's low 32 bits, which hash all of (seed, epoch)
            gen = torch.Generator().manual_seed(
                fold_seed(fold_seed(seed, 0x51), epoch))
            perm = torch.randperm(nb * bsz, generator=gen).to(dev)
            xs = xs.reshape((nb * bsz,) + xs.shape[2:])[perm].reshape(
                xs.shape)
            ys = ys.reshape(-1)[perm].reshape(ys.shape)
        return xs, ys

    def maybe_checkpoint(epoch: int) -> None:
        if (checkpoint_dir is None or checkpoint_every <= 0
                or (epoch + 1) % checkpoint_every):
            return
        if first:
            from bayestpu_torch.train.checkpoint import save_checkpoint
            save_checkpoint(checkpoint_dir, state, seed, aux={
                "epoch": epoch, "best_metric": best_metric,
                "since_best": since_best,
                "best_params": (best_params if val_batches is not None
                                else dict(model.named_parameters()))})
        if mesh is not None and dist.is_initialized():
            # the other ranks wait until the first has written
            dist.broadcast(torch.zeros(1, device=dev), src=mesh.first)

    for epoch in range(start_epoch, num_epochs):
        t0 = time.perf_counter()
        got = epoch_batches(epoch)
        if isinstance(got, tuple):
            ep_loss = float(train_epoch(state, *got, seed,
                                        lr_scale)["loss"])
        else:
            seeds = step_seeds(seed, range(state.step,
                                           state.step + len(got)),
                               n_sites).to(dev)
            loss_sum = None
            for i, (x, y) in enumerate(got):
                if augment_fn is not None:
                    x = augment_fn(fold_seed(seed, state.step), x,
                                   state.step)
                m = train_step(state, x, y, seeds[i], lr_scale)
                loss_sum = (m["loss"] if loss_sum is None
                            else loss_sum + m["loss"])
            ep_loss = (float(loss_sum) / len(got)) if got else 0.0
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
                best_params = _snapshot(model)
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
                    maybe_checkpoint(epoch)
                    _load_params(model, best_params)
                    return state
        log_fn(msg + f"  ({time.perf_counter() - t0:.1f}s)")
        maybe_checkpoint(epoch)

    if val_batches is not None:
        _load_params(model, best_params)
    return state


def _snapshot(model: nn.Module) -> dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _silent(msg: str) -> None:
    """The log of a rank that is not the mesh's first."""


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
