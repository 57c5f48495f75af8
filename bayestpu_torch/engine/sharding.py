"""A (data, sample) mesh over the ranks of ``torch.distributed``, and the
sharded MC predictive.

Counterpart of ``bayestpu/engine/sharding.py``. The JAX package puts the
batch over the mesh's ``data`` axis and the per-sample keys over its
``sample`` axis and lets XLA's partitioner insert the collectives; here
each rank runs its own block of samples on its own rows, and the
reductions are explicit collectives over the mesh's two process groups.
Only ``all_reduce`` and ``broadcast`` are used: gloo runs both on CPU and
CUDA tensors, so two gloo ranks may share one card, and NCCL runs them
across cards.

A sharded computation computes what the unsharded one does, as a sharded
``jax.jit`` does: a rank's rows carry their global row into every MC mask
(``nn.rows``; the kernels' ``row0``), a train-mode BatchNorm takes its
statistics over the data axis, and the Masksembles training split is the
global batch's. Sample i runs on seeds[i] and index i whatever the mesh,
so a sample-only mesh gives each sample's logits bit-equal to the local
spatial predict's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from bayestpu_torch.engine.sampler import Predictive, _entropy
from bayestpu_torch.nn.rows import WHOLE, RowAware, Rows

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


class Mesh:
    """``ranks`` laid out as a (data, sample) grid, row-major as JAX's
    ``devices.reshape(num_data, num_sample)``. ``shape`` is ``{"data": d,
    "sample": s}``; ``coords`` this rank's (data, sample) index (None when
    it is not in the mesh); ``data_group`` the ranks that share this rank's
    sample index (its data axis), ``sample_group`` those that share its
    data index (its sample axis). Without a process group the mesh is 1×1
    and has no groups: its collectives are no-ops."""

    def __init__(self, num_data: int, num_sample: int, ranks: list[int]):
        self.shape = {DATA_AXIS: num_data, SAMPLE_AXIS: num_sample}
        self.ranks = list(ranks)
        self.data_group = self.sample_group = None
        self.coords: tuple[int, int] | None = (0, 0)
        if not dist.is_initialized():
            return
        me = dist.get_rank()
        self.coords = None
        if me in self.ranks:
            i = self.ranks.index(me)
            self.coords = (i // num_sample, i % num_sample)
        # new_group is collective: every rank makes every group, in order
        for d in range(num_data):
            g = dist.new_group(self.ranks[d * num_sample:(d + 1) * num_sample])
            if self.coords is not None and self.coords[0] == d:
                self.sample_group = g
        for s in range(num_sample):
            g = dist.new_group(self.ranks[s::num_sample])
            if self.coords is not None and self.coords[1] == s:
                self.data_group = g

    @property
    def first(self) -> int:
        """The mesh's first rank: the source of ``replicate``."""
        return self.ranks[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks})"


def make_mesh(num_data: int | None = None, num_sample: int | None = None,
              ranks=None) -> Mesh:
    """A (data, sample) mesh over ``ranks`` (default: every rank of the
    default process group, or the one process when there is none). With
    neither size given every rank goes to the sample axis, the cheap one:
    samples exchange nothing until the final moments. Raises ``ValueError``
    when the sizes do not multiply to the rank count."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    n = len(ranks)
    if num_data is None and num_sample is None:
        num_data, num_sample = 1, n
    elif num_data is None:
        num_data = n // num_sample
    elif num_sample is None:
        num_sample = n // num_data
    if num_data * num_sample != n:
        raise ValueError(f"mesh {num_data}x{num_sample} != {n} ranks")
    return Mesh(num_data, num_sample, ranks)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (no group: t as it is)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _check_member(mesh: Mesh) -> tuple[int, int]:
    if mesh.coords is None:
        raise ValueError(f"this rank is not in {mesh!r}")
    return mesh.coords


def data_rows(batch: int, mesh: Mesh) -> tuple[int, int]:
    """(row0, rows): this rank's block of a batch of ``batch`` rows split
    over the data axis; a batch that does not divide raises
    ``ValueError``."""
    d = mesh.shape[DATA_AXIS]
    if batch % d:
        raise ValueError(f"batch {batch} does not divide over the data axis "
                         f"of {d}")
    rows = batch // d
    return _check_member(mesh)[0] * rows, rows


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows (along the leading axis) of a tensor, or of each
    tensor of a tuple or list."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    row0, rows = data_rows(batch.shape[0], mesh)
    return batch[row0:row0 + rows]


def replicate(obj, mesh: Mesh):
    """The mesh's first rank's parameters and buffers (a module) or tensors
    (a tensor, or a dict, tuple or list of them) on every rank, by
    ``broadcast`` in place. Returns ``obj``."""
    if not dist.is_initialized():
        return obj
    if isinstance(obj, nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    elif isinstance(obj, torch.Tensor):
        tensors = [obj]
    elif isinstance(obj, dict):
        tensors = [t for t in obj.values() if isinstance(t, torch.Tensor)]
    else:
        tensors = [t for t in obj if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=mesh.first)
    return obj


@contextlib.contextmanager
def at_rows(model: nn.Module, rows: Rows):
    """Run ``model`` on the rows ``rows`` describes for the ``with`` body:
    every ``RowAware`` module of it (the MC sites, the Masksembles sites,
    the BatchNorms) reads ``rows`` instead of ``WHOLE``."""
    mods = [m for m in model.modules() if isinstance(m, RowAware)]
    for m in mods:
        m.rows = rows
    try:
        yield model
    finally:
        for m in mods:
            m.rows = WHOLE


def shard_logits(model: nn.Module, x: torch.Tensor, seeds: torch.Tensor,
                 mesh: Mesh) -> tuple[torch.Tensor, int, int]:
    """This rank's per-sample logits (S / s, E, rows, C): samples ``[a, a +
    S / s)`` (seeds[a:…], indices ``arange(a, …)``) of its sample index on
    the rows ``[row0, row0 + rows)`` of its data index, keyed on their
    global rows. Returns (logits, a, row0). ``seeds`` (S, n_sites, 2) holds
    every sample; S must divide over the sample axis."""
    _, si = _check_member(mesh)
    s = mesh.shape[SAMPLE_AXIS]
    total = seeds.shape[0]
    if total % s:
        raise ValueError(f"{total} samples do not divide over the sample "
                         f"axis of {s}")
    per = total // s
    a = si * per
    row0, rows = data_rows(x.shape[0], mesh)
    idx = torch.arange(a, a + per, dtype=torch.int32, device=x.device)
    with at_rows(model, Rows(row0, x.shape[0])):
        logits = model(x[row0:row0 + rows], seeds[a:a + per].contiguous(),
                       idx).logits
    return logits, a, row0


def local_moments(model: nn.Module, x: torch.Tensor, seeds: torch.Tensor,
                  mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """The predictive mean and variance (E, rows, C) of this rank's rows
    over all the samples, and (row0, rows) (``shard_logits``)."""
    logits, _, row0 = shard_logits(model, x, seeds, mesh)
    total = seeds.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)
    mean = all_reduce(probs.sum(dim=0), mesh.sample_group) / total
    # the two-pass variance of jnp.var, its squares summed the same way
    var = all_reduce(((probs - mean) ** 2).sum(dim=0),
                     mesh.sample_group) / total
    return mean, var, row0, logits.shape[-2]


def gather_rows(t: torch.Tensor, batch: int, row0: int, mesh: Mesh
                ) -> torch.Tensor:
    """The (…, batch, …) tensor whose rows (axis -2) ``row0 ..`` are this
    rank's ``t`` and the others' theirs: a sum into a zeroed buffer over the
    data axis (``all_reduce``, which gloo runs on CUDA tensors where it may
    not run ``all_gather``)."""
    shape = list(t.shape)
    shape[-2] = batch
    full = t.new_zeros(shape)
    full[..., row0:row0 + t.shape[-2], :] = t
    return all_reduce(full, mesh.data_group)


def padded_samples(num_samples: int, mesh: Mesh) -> int:
    """``num_samples`` rounded up to a multiple of the sample axis (the
    extra samples only sharpen the estimate)."""
    n = mesh.shape[SAMPLE_AXIS]
    return math.ceil(num_samples / n) * n


@torch.inference_mode()
def sharded_predictive(model: nn.Module, x: torch.Tensor,
                       seeds: torch.Tensor, mesh: Mesh) -> Predictive:
    """MC predictive moments with the samples sharded over the mesh's
    sample axis and the batch over its data axis (``sharding.py:60-89``).

    ``seeds`` (S, n_sites, 2) holds every sample, S already padded to a
    multiple of the sample axis (``padded_samples``; a Masksembles model
    has no sites: (S, 0, 2)); x the whole batch, which must divide over the
    data axis. Each rank runs samples ``[a, b)`` (seeds[a:b], indices
    ``arange(a, b)``) on its rows; the mean is one sum over the sample
    axis, the variance a second one of ``Σ(p − mean)²``, and the batch is
    rebuilt over the data axis. Returns the same ``Predictive`` on every
    rank, ``num_samples`` = S."""
    mean, var, row0, _ = local_moments(model, x, seeds, mesh)
    batch = x.shape[0]
    mean = gather_rows(mean, batch, row0, mesh)
    var = gather_rows(var, batch, row0, mesh)
    return Predictive(mean, var, _entropy(mean), seeds.shape[0])
