"""Bayesian sites: ``BayesianDropout``, ``BayesianDropout2D``,
``Masksembles`` and the config-dispatched ``BayesSite``.

Counterpart of ``bayestpu/nn/bayes.py:43-159``. A Masksembles site holds a
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

A bf16 x times the f32 bank is f32, as JAX promotes it.

The materialized MC-dropout sites (``bayes.py:43-90``): ``BayesianDropout``
keeps each element of x, ``BayesianDropout2D`` each channel of each example,
with the mask of ``jax.random.bernoulli(key, 1 - rate, shape)``
(``core.threefry``, bit for bit) drawn over the NHWC shape, so the counter
is the flat NHWC index: an NCHW tensor (``channels_last`` or not) gets the
NHWC mask permuted to its view. The kept values are ``x · f32(1/keep)`` in
x's dtype, keep rounded to x's dtype first: the form XLA-CPU compiles
``jnp.where(mask, x / keep, 0)`` to under ``jax.jit``, where the JAX
package's served and trained paths run it (an eager JAX call divides,
which differs in the last bit of about a third of the f32 elements). A bf16
x is widened, multiplied and rounded back. Rate 0 is the identity.

A site takes its ``seeds``: (2,) for one sample; (S, 2) for S samples on a
new leading axis; or with ``carries_samples`` an x whose leading axis
already holds the S samples, sample s under ``seeds[s]`` on its own
coordinates.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind
from bayestpu_torch.core.threefry import bernoulli
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
    """Fixed-mask-bank site over the channel axis ``channel_dim`` (the last
    by default, as in JAX; ``BayesSite`` names dim 1 of an NCHW image)."""

    def __init__(self, channels: int, num_masks: int = 4, scale: float = 2.0):
        super().__init__()
        self.register_buffer("bank", make_bank(channels, num_masks, scale))

    def forward(self, x: torch.Tensor, sample_idx=0, channel_dim: int = -1,
                carries_samples: bool = False) -> torch.Tensor:
        if self.training:
            return batch_split(x, self.bank, channel_dim)
        return apply_row(x, self.bank, sample_idx, channel_dim,
                         carries_samples)


@functools.lru_cache(maxsize=None)
def dropout_scale(rate: float, dtype: torch.dtype) -> float:
    """``f32(1 / keep)`` with keep = 1 - rate rounded to ``dtype`` first:
    the multiplier of the jitted ``x / keep`` (an f32 value, so an f32 x
    times it is the f32 product)."""
    keep = torch.tensor(1.0 - rate, dtype=dtype).float()
    return float(torch.tensor(1.0, dtype=torch.float32) / keep)


def _nhwc(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The JAX shape of a port tensor: (B, H, W, C) for an NCHW one."""
    if len(shape) == 4:
        return (shape[0],) + tuple(shape[2:]) + (shape[1],)
    return tuple(shape)


class BayesianDropout(nn.Module):
    """Always-on dropout on threefry masks (``bayes.py:43-64``): the mask
    has x's own shape (of each sample, with ``carries_samples``)."""

    def __init__(self, rate: float = 0.25):
        super().__init__()
        self.rate = rate

    def mask_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return _nhwc(shape)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor,
                carries_samples: bool = False) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        if seeds is None:
            raise ValueError("an MC-dropout site needs its seeds")
        base = tuple(x.shape[1:] if carries_samples else x.shape)
        if carries_samples and tuple(seeds.shape) != (x.shape[0], 2):
            raise ValueError(f"x carries {x.shape[0]} samples; seeds must "
                             f"be ({x.shape[0]}, 2), got {tuple(seeds.shape)}")
        keep = bernoulli(seeds, 1.0 - self.rate, self.mask_shape(base))
        if len(base) == 4:                 # NHWC mask → the NCHW view
            keep = keep.movedim(-1, -3)
        y = (x.float() * dropout_scale(self.rate, x.dtype)).to(x.dtype)
        return torch.where(keep, y, 0.0)


class BayesianDropout2D(BayesianDropout):
    """Always-on channel dropout (``bayes.py:67-88``): the mask is (B, 1, 1,
    C) in NHWC, whole channels of each example, broadcast over space."""

    def mask_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return (shape[0],) + (1,) * (len(shape) - 2) + (_nhwc(shape)[-1],)


class BayesSite(nn.Module):
    """Config-dispatched site (``Get_Bayesian_Layer``, ``bayes.py:140-
    159``): ``BayesianDropout`` for MC (``stochastic`` at rate > 0),
    Masksembles for ``kind=MASK``, the identity for ``NONE``. The children
    are named ``BayesianDropout_0`` and ``Masksembles_0``, as Flax names
    them, so a bank loads as ``masks/<site>/Masksembles_0/bank``.
    ``forward(x, sample_idx, seeds, carries_samples)``: a Masksembles site
    takes ``sample_idx`` (see ``apply_row``), an MC one its seeds."""

    def __init__(self, cfg: BayesConfig, channels: int):
        super().__init__()
        self.stochastic = cfg.kind is DropoutKind.MC and cfg.rate > 0.0
        self.masked = cfg.kind is DropoutKind.MASK
        self.site = None
        self.BayesianDropout_0 = (BayesianDropout(cfg.rate)
                                  if cfg.kind is DropoutKind.MC else None)
        self.Masksembles_0 = (Masksembles(channels, cfg.num_masks, cfg.scale)
                              if self.masked else None)

    def forward(self, x: torch.Tensor, sample_idx=0,
                seeds: torch.Tensor | None = None,
                carries_samples: bool = False) -> torch.Tensor:
        if self.BayesianDropout_0 is not None:
            return self.BayesianDropout_0(x, seeds, carries_samples)
        if self.Masksembles_0 is not None:
            # dim 1 of an NCHW image (of each sample), else the last
            dim = -3 if x.dim() - carries_samples == 4 else -1
            return self.Masksembles_0(x, sample_idx, dim, carries_samples)
        return x
