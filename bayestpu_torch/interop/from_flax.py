"""Load a JAX/Flax variables tree into a port model, by name.

``variables`` is the ``{"params": …, "batch_stats": …}`` tree of the JAX
package's ``model.init`` / training state — with ``"masks"`` for a model
with Masksembles sites — as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``). Each leaf fills the port's
parameter (``params``) or buffer whose dotted name is the leaf's path:
``params/block0/convbn0/conv/kernel`` → ``block0.convbn0.conv.kernel``,
``masks/exit1/linear/bank`` → ``exit1.linear.bank``, a conv site's
``masks/block1/convbn0/conv/bank`` → ``block1.convbn0.conv.bank``. A buffer
named ``bank`` (a Masksembles bank) belongs to ``masks``, every other
buffer (the BatchNorm statistics) to ``batch_stats``. Conv kernels go from HWIO to
OIHW; dense kernels stay ``(in, out)``. A missing or extra name, a shape
mismatch, or a collection the model does not hold (``masks`` for a model
without banks) raises. ``to_flax_variables`` goes the other way.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from bayestpu_torch.nn.bayes import MASKS_COLLECTION


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _fill(targets: dict[str, torch.Tensor], leaves: dict[str, Any],
          collection: str) -> None:
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise KeyError(f"{collection}: names differ from the model's — "
                       f"missing {missing}, extra {extra}")
    for name, t in targets.items():
        arr = np.array(leaves[name], dtype=np.float32)   # a writable copy
        if arr.ndim == 4:                      # HWIO → OIHW
            arr = arr.transpose(3, 2, 0, 1)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{collection}/{name}: shape {arr.shape} does "
                             f"not fit {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def buffers_by_collection(model: nn.Module
                          ) -> dict[str, dict[str, torch.Tensor]]:
    """The model's buffers by dotted name, under their Flax collection:
    ``batch_stats`` (always present) and, for a model with Masksembles
    banks, ``masks``."""
    out: dict[str, dict[str, torch.Tensor]] = {"batch_stats": {}}
    for name, t in model.named_buffers():
        coll = (MASKS_COLLECTION if name.rsplit(".", 1)[-1] == "bank"
                else "batch_stats")
        out.setdefault(coll, {})[name] = t
    return out


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters from ``variables["params"]`` and its
    buffers from their collections; returns ``model``."""
    buffers = buffers_by_collection(model)
    unknown = sorted(set(variables) - {"params"} - set(buffers))
    if unknown:
        raise KeyError(f"collections not held by this port model: {unknown}")
    _fill(dict(model.named_parameters()),
          _flatten(variables.get("params", {})), "params")
    for coll, named in buffers.items():
        _fill(named, _flatten(variables.get(coll, {})), coll)
    return model


def _nest(named: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        arr = t.detach().float().cpu().numpy()
        node[leaf] = arr.transpose(2, 3, 1, 0).copy() if arr.ndim == 4 \
            else arr.copy()                                # OIHW → HWIO
    return out


def to_flax_variables(model: nn.Module) -> dict[str, Any]:
    """The inverse of ``load_flax_variables``: ``{"params": …,
    "batch_stats": …}``, with ``"masks"`` when the model has banks, as
    nested dicts of f32 numpy arrays (copies), conv kernels back in HWIO —
    what ``BayesEngine.attach`` takes, as the JAX training state's
    ``variables()`` feeds the JAX engine."""
    out = {"params": _nest(dict(model.named_parameters()))}
    for coll, named in buffers_by_collection(model).items():
        out[coll] = _nest(named)
    return out
