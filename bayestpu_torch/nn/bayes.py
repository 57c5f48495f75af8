"""Bayesian sites: ``Masksembles`` and the config-dispatched ``BayesSite``.

Counterpart of ``bayestpu/nn/bayes.py:91-159``. A Masksembles site holds a
fixed bank of ``num_masks`` binary channel masks, generated in the
constructor from the channel count by ``kernels.mask_bank`` with
``np.random.default_rng(BANK_SEED)`` — the bank the Flax ``init`` draws —
and kept as the buffer ``bank`` (the Flax ``masks`` collection, never a
parameter). Channels are the last axis, (B, C) or NHWC inputs, unless a
caller names another (``channel_dim``: ``BayesConv`` masks NCHW tensors).

- train mode: the batch splits into ``num_masks`` equal groups and group g
  is multiplied by bank row g; a batch not divisible by ``num_masks``
  raises ``ValueError``.
- eval mode: x is multiplied by ``bank[sample_idx % num_masks]``; a 1-D
  tensor of S indices gives every sample at once on a new leading axis.

A bf16 x times the f32 bank is f32, as JAX promotes it. The materialized
MC-dropout sites (``BayesianDropout``, ``BayesianDropout2D``) draw their
masks from ``jax.random.bernoulli`` (threefry), which the port does not
reproduce; they wait for ROADMAP Queue 1 item 11, and ``BayesSite``'s MC
branch raises. MC sites fused into the next conv or dense kernel
(``nn.fused``) are ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind
from bayestpu_torch.kernels import mask_bank
from bayestpu_torch.kernels.masked_matmul import bank_index

# The Flax collection of the banks; ``interop.from_flax`` routes every
# buffer named ``bank`` to it.
MASKS_COLLECTION = "masks"

# The seed of every bank: the default ``bank_seed`` of the Flax sites
# (``bayes.py:111``, ``fused.py:513``), which no configuration changes.
BANK_SEED = 0


@functools.lru_cache(maxsize=None)
def _bank_array(channels: int, num_masks: int, scale: float) -> np.ndarray:
    _, bank = mask_bank.generation_wrapper(
        channels, num_masks, scale, rng=np.random.default_rng(BANK_SEED))
    bank.setflags(write=False)
    return bank


def make_bank(channels: int, num_masks: int, scale: float) -> torch.Tensor:
    """The (num_masks, channels) f32 bank the Flax init draws for a site of
    ``channels`` channels (``bayes.py:118-124``, ``fused.py:542-548``)."""
    return torch.from_numpy(_bank_array(channels, num_masks, scale).copy())


def _channel_shape(ndim: int, channel_dim: int, lead: int, c: int
                   ) -> tuple[int, ...]:
    """The shape that broadcasts a (lead, C) block of bank rows against a
    tensor of ``ndim`` dims with one more leading axis, C at
    ``channel_dim`` of the tensor."""
    shape = [lead] + [1] * ndim
    shape[channel_dim % ndim + 1] = c
    return tuple(shape)


def batch_split(x: torch.Tensor, bank: torch.Tensor, channel_dim: int = -1
                ) -> torch.Tensor:
    """The train-mode Masksembles mask: group g of the batch (split into
    ``num_masks`` equal groups) times bank row g, along the channel axis
    (the last one by default; dim 1 of an NCHW tensor)."""
    n, c = bank.shape
    b = x.shape[0]
    if b % n != 0:
        raise ValueError(f"batch size {b} not divisible by num_masks {n}")
    gx = x.reshape((n, b // n) + tuple(x.shape[1:]))
    return (gx * bank.view(_channel_shape(x.dim(), channel_dim, n, c))
            ).reshape(x.shape)


def apply_row(x: torch.Tensor, bank: torch.Tensor, sample_idx,
              channel_dim: int = -1, carries_samples: bool = False
              ) -> torch.Tensor:
    """The eval-mode Masksembles mask: ``x * bank[sample_idx % num_masks]``
    along the channel axis for an int index; for a 1-D tensor of S indices,
    the S products stacked on a new leading axis, or, when x already
    carries the sample axis first (``carries_samples``), sample s of x times
    row s (S indices: a 1-D tensor, or a list of ints)."""
    if isinstance(sample_idx, (list, tuple)):
        sample_idx = torch.tensor(sample_idx, device=x.device)
    if isinstance(sample_idx, torch.Tensor) and sample_idx.dim() == 1:
        rows = bank[torch.remainder(sample_idx, bank.shape[0]).long()]
        xs = x if carries_samples else x.unsqueeze(0)
        dim = channel_dim % x.dim() - (1 if carries_samples else 0)
        return xs * rows.view(_channel_shape(xs.dim() - 1, dim,
                                             rows.shape[0], rows.shape[1]))
    row = bank[bank_index(sample_idx, bank.shape[0])]
    return x * row.view(_channel_shape(x.dim(), channel_dim, 1, -1)[1:])


class Masksembles(nn.Module):
    """Fixed-mask-bank site over the channel (last) axis."""

    def __init__(self, channels: int, num_masks: int = 4, scale: float = 2.0):
        super().__init__()
        self.register_buffer("bank", make_bank(channels, num_masks, scale))

    def forward(self, x: torch.Tensor, sample_idx=0) -> torch.Tensor:
        if self.training:
            return batch_split(x, self.bank)
        return apply_row(x, self.bank, sample_idx)


class BayesSite(nn.Module):
    """Config-dispatched site (``Get_Bayesian_Layer``): Masksembles for
    ``kind=MASK``, the identity for ``NONE``; MC dropout raises. The
    Masksembles child is named ``Masksembles_0``, as Flax names it, so the
    bank loads as ``masks/<site>/Masksembles_0/bank``."""

    def __init__(self, cfg: BayesConfig, channels: int):
        super().__init__()
        if cfg.kind is DropoutKind.MC:
            raise NotImplementedError(
                "materialized MC-dropout sites (BayesianDropout and "
                "BayesianDropout2D on threefry masks) are not ported yet; "
                "MC sites are ported fused into the next conv or dense "
                "kernel: ROADMAP Queue 1 item 11")
        self.Masksembles_0 = (Masksembles(channels, cfg.num_masks, cfg.scale)
                              if cfg.kind is DropoutKind.MASK else None)

    def forward(self, x: torch.Tensor, sample_idx=0) -> torch.Tensor:
        if self.Masksembles_0 is None:
            return x
        return self.Masksembles_0(x, sample_idx)
