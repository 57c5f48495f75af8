"""The multi-process runtime: bring-up, the pod mesh, and the linear metric
partials that reduce over a mesh.

Counterpart of ``bayestpu/engine/distributed.py``. ``initialize`` starts
``torch.distributed`` (NCCL for a card, gloo for the CPU) from explicit
arguments or the ``RANK``/``WORLD_SIZE`` environment of a launcher, and
does nothing for one process. ``distributed_evaluate`` is the sharded MC
evaluation: the probabilities averaged over the samples of the mesh's
sample axis, then the final exit's partials (n, correct, the NLL sum and
the equal-width ECE bins, all linear) summed over its data axis, so every
rank returns the metrics of the whole batch.
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

from bayestpu_torch.core.rng import sample_seeds
from bayestpu_torch.engine.sharding import (DATA_AXIS, SAMPLE_AXIS, Mesh,
                                            all_reduce, local_moments,
                                            make_mesh, padded_samples)
from bayestpu_torch.metrics.ece import ece_bins, ece_from_bins


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Start the default process group. With no argument and neither
    ``RANK`` nor ``WORLD_SIZE`` set there is nothing to coordinate and it
    returns. The backend is ``backend`` when given, else NCCL where a card
    is present and gloo where none is. ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``). A backend or rendezvous
    that fails raises; no other backend is tried."""
    if (init_method is None and world_size is None and rank is None
            and backend is None and "RANK" not in os.environ
            and "WORLD_SIZE" not in os.environ):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def pod_mesh(num_sample: int | None = None) -> Mesh:
    """The (data, sample) mesh over every rank: the sample axis defaults to
    the ranks of one host (``LOCAL_WORLD_SIZE``, halved until it divides
    the world), so sample traffic stays inside a host and the data axis
    crosses hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_sample is None:
        num_sample = max(int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
        while world % num_sample:
            num_sample //= 2
    return make_mesh(world // num_sample, num_sample)


def eval_step_metrics(probs: torch.Tensor, labels: torch.Tensor,
                      n_bins: int = 10) -> dict[str, torch.Tensor]:
    """Per-shard metric PARTIALS of (B, C) probabilities, all linear, so
    sums over shards are the whole batch's; ``finalize_metrics`` turns them
    into metrics."""
    labels = labels.long()
    pred = probs.argmax(dim=-1)
    cnt, conf_sum, acc_sum = ece_bins(probs, labels, n_bins)
    picked = torch.gather(probs, -1, labels[:, None])[:, 0]
    return {
        "n": torch.tensor(float(labels.shape[0]), device=probs.device),
        "correct": (pred == labels).float().sum(),
        "nll_sum": -torch.log(torch.clamp(picked, 1e-12, 1.0)).sum(),
        "ece_cnt": cnt, "ece_conf": conf_sum, "ece_acc": acc_sum,
    }


def finalize_metrics(parts: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    return {
        "acc": parts["correct"] / parts["n"],
        "nll": parts["nll_sum"] / parts["n"],
        "ece": ece_from_bins(parts["ece_cnt"], parts["ece_conf"],
                             parts["ece_acc"]),
        "n": parts["n"],
    }


def put_global(obj: Any, mesh: Mesh, spec: Any = None) -> Any:
    """This rank's part of host-resident data under ``spec``: ``"data"``
    (its rows along the leading axis, ``sharding.shard_batch``),
    ``"sample"`` (its block of the leading axis over the sample axis) or
    None (all of it, replicated). Every process must hold the same data, as
    in JAX, where workers derive everything from shared seeds; a dict,
    tuple or list maps over its members."""
    if isinstance(obj, dict):
        return {k: put_global(v, mesh, spec) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(put_global(v, mesh, spec) for v in obj)
    t = torch.as_tensor(obj)
    if spec is None:
        return t
    if spec not in (DATA_AXIS, SAMPLE_AXIS):
        raise ValueError(f"spec must be {DATA_AXIS!r}, {SAMPLE_AXIS!r} or "
                         f"None; got {spec!r}")
    n = mesh.shape[spec]
    if t.shape[0] % n:
        raise ValueError(f"leading axis {t.shape[0]} does not divide over "
                         f"the {spec} axis of {n}")
    if mesh.coords is None:
        raise ValueError(f"this rank is not in {mesh!r}")
    i = mesh.coords[0 if spec == DATA_AXIS else 1]
    per = t.shape[0] // n
    return t[i * per:(i + 1) * per]


@torch.inference_mode()
def distributed_evaluate(model: torch.nn.Module, x, y, num_samples: int,
                         mesh: Mesh, seed: int = 0,
                         seeds: torch.Tensor | None = None
                         ) -> dict[str, float]:
    """Sharded MC evaluation (``distributed.py:95-127``): the batch over the
    data axis, ``num_samples`` (padded to the sample axis) over the sample
    axis, the final exit's metric partials reduced over the mesh. ``seeds``
    (padded, n_sites, 2) replaces ``sample_seeds(seed, padded, n_sites)``
    (to feed captured seeds). x and y are the whole batch, on the model's
    device. Returns acc, nll, ece and n, the same on every rank."""
    dev = next(model.parameters()).device
    if seeds is None:
        seeds = sample_seeds(seed, padded_samples(num_samples, mesh),
                             model.num_sites)
    elif seeds.shape[0] % mesh.shape[SAMPLE_AXIS]:
        raise ValueError("the seeds' samples must divide over the sample "
                         "axis")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int64, device=dev)
    mean, _, row0, rows = local_moments(model, x, seeds.to(dev), mesh)
    parts = eval_step_metrics(mean[-1], y[row0:row0 + rows])
    names = list(parts)
    flat = torch.cat([parts[k].reshape(-1) for k in names])
    flat = all_reduce(flat, mesh.data_group)
    out, i = {}, 0
    for k in names:
        n = parts[k].numel()
        out[k] = flat[i:i + n].reshape(parts[k].shape)
        i += n
    mets = finalize_metrics(out)
    values = torch.stack([v.float() for v in mets.values()]).tolist()
    return dict(zip(mets, values))
