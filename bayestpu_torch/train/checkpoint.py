"""Checkpoint and resume: parameters, buffers, optimizer state, step and
seed (counterpart of ``bayestpu/train/checkpoint.py``).

A checkpoint is a directory, as the JAX package's orbax checkpoint is,
holding one ``torch.save`` file, ``checkpoint.pt``. It is written to a
temporary name in that directory and moved into place with ``os.replace``,
so a reader never sees half a file and a crash mid-write leaves the last
checkpoint whole. Every tensor is stored as a CPU copy, and the payload is
dicts, tuples, lists, ints, floats and tensors only, so it loads with
``torch.load(weights_only=True)``.

The payload: ``params`` and ``buffers`` (the model's by dotted name),
``opt_state`` (the optimizer chain's state as ``train.optim`` builds it),
``step``, the integer ``seed`` of the run (the JAX package stores its key),
and ``aux``, the loop's early-stopping state: ``epoch`` (the last
completed), ``best_metric``, ``since_best`` and ``best_params``. Like
JAX's, it does not hold the plateau scale (``lr_scale`` and the epochs
since the last plateau kick), so a run resumed after a kick continues at
the unscaled learning rate, as a resumed JAX run does.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from bayestpu_torch.interop.from_flax import flax_variables
from bayestpu_torch.train.loop import TrainState

FILE = "checkpoint.pt"


def _map(tree: Any, fn) -> Any:
    """``fn`` on every tensor of a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _cpu(tree: Any) -> Any:
    return _map(tree, lambda t: t.detach().to("cpu", copy=True))


def _write(path: str, payload: dict) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def _read(path: str) -> dict:
    return torch.load(os.path.join(os.path.abspath(path), FILE),
                      map_location="cpu", weights_only=True)


def _params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def save_checkpoint(path: str, state: TrainState, seed: int,
                    aux: dict | None = None) -> str:
    """Write a full training checkpoint of ``state`` and the run's
    ``seed``; returns the directory written. ``aux`` defaults to JAX's
    (epoch −1, best −inf, 0 epochs since the best, the live parameters)."""
    model = state.model
    if aux is None:
        aux = {"epoch": -1, "best_metric": -float("inf"), "since_best": 0,
               "best_params": _params(model)}
    return _write(path, {
        "params": _cpu(_params(model)),
        "buffers": _cpu(dict(model.named_buffers())),
        "opt_state": _cpu(state.opt_state),
        "step": int(state.step),
        "seed": int(seed),
        "aux": {"epoch": int(aux["epoch"]),
                "best_metric": float(aux["best_metric"]),
                "since_best": int(aux["since_best"]),
                "best_params": _cpu(dict(aux["best_params"]))}})


def _load_named(named: dict[str, torch.Tensor],
                saved: dict[str, torch.Tensor], what: str) -> None:
    if set(named) != set(saved):
        raise KeyError(f"checkpoint {what} differ from the model's: missing "
                       f"{sorted(set(named) - set(saved))}, extra "
                       f"{sorted(set(saved) - set(named))}")
    with torch.no_grad():
        for k, t in named.items():
            if saved[k].shape != t.shape or saved[k].dtype != t.dtype:
                raise ValueError(f"checkpoint {what} {k}: "
                                 f"{tuple(saved[k].shape)} {saved[k].dtype} "
                                 f"does not fit {tuple(t.shape)} {t.dtype}")
            t.copy_(saved[k])


def restore_checkpoint(path: str, template: TrainState,
                       with_aux: bool = False):
    """``(state, seed)``, or ``(state, seed, aux)`` with ``with_aux``: the
    template's model gets the saved parameters and buffers in place (names,
    shapes and dtypes must match), and the optimizer state and
    ``aux["best_params"]`` come back on the model's device."""
    payload = _read(path)
    model = template.model
    dev = next(model.parameters()).device
    _load_named(_params(model), payload["params"], "params")
    _load_named(dict(model.named_buffers()), payload["buffers"], "buffers")
    state = TrainState(model, _map(payload["opt_state"],
                                   lambda t: t.to(dev)), payload["step"])
    if not with_aux:
        return state, payload["seed"]
    aux = dict(payload["aux"])
    aux["best_params"] = _map(aux["best_params"], lambda t: t.to(dev))
    return state, payload["seed"], aux


def restore_variables(path: str) -> dict:
    """The model variables of a full checkpoint alone (``{"params",
    "batch_stats"}``, with ``"masks"`` for a Masksembles model, as nested
    numpy dicts): what ``BayesEngine.attach`` takes, for the inference CLIs
    that do not know the optimizer used in training."""
    payload = _read(path)
    return flax_variables(payload["params"], payload["buffers"])


def save_best(path: str, params: dict[str, torch.Tensor]) -> str:
    """A weights-only snapshot of ``params`` (name → tensor)."""
    _write(path, {"params": _cpu(dict(params))})
    return path


def load_best(path: str) -> dict[str, torch.Tensor]:
    """The parameters ``save_best`` wrote, on the CPU."""
    return _read(path)["params"]
