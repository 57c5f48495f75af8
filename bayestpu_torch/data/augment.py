"""Training augmentation on the device: zero padding by ``pad``, a random
crop back to size, a random horizontal flip (counterpart of
``bayestpu/data/augment.py``).

The JAX function pads with zeros (``jnp.pad``'s default, although its
docstring says reflect); so does this one. ``crop_flip`` is the arithmetic
on given offsets and flips, one gather on the device for the whole batch;
``random_crop_flip`` draws them, one crop offset in [0, 2·pad] on each
axis and one flip with p = 0.5 per image, from a ``torch.Generator`` seeded
by ``core.rng.fold_seed(seed, index)`` on the host (so the CPU and the card
see the same draws). JAX draws from ``fold_in(key, index)``: the two agree
in distribution only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bayestpu_torch.core.rng import fold_seed


def crop_flip(x: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor,
              pad: int = 4) -> torch.Tensor:
    """x (B, H, W, C) zero-padded by ``pad`` on H and W, image b cropped
    back to (H, W) at (offsets[b, 0], offsets[b, 1]) and mirrored along W
    where flips[b]. offsets (B, 2) integers in [0, 2·pad] and flips (B,)
    bool (checked where they are, then moved to x's device: host draws
    cost the card no synchronise)."""
    b, h, w, _ = x.shape
    offsets, flips = torch.as_tensor(offsets), torch.as_tensor(flips)
    if tuple(offsets.shape) != (b, 2) or tuple(flips.shape) != (b,):
        raise ValueError(f"offsets {tuple(offsets.shape)} and flips "
                         f"{tuple(flips.shape)} do not fit x {tuple(x.shape)}")
    if b and (offsets.min() < 0 or offsets.max() > 2 * pad):
        raise ValueError(f"offsets outside [0, {2 * pad}]")
    offsets = offsets.to(x.device, torch.int64)
    flips = flips.to(x.device, torch.bool)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, :1] + torch.arange(h, device=x.device)
    cols = offsets[:, 1:] + torch.arange(w, device=x.device)
    cols = torch.where(flips[:, None], cols.flip(-1), cols)
    return xp[torch.arange(b, device=x.device)[:, None, None],
              rows[:, :, None], cols[:, None, :]]


def random_crop_flip(seed: int, x: torch.Tensor, pad: int = 4,
                     index: int = 0) -> torch.Tensor:
    """``crop_flip`` of x (B, H, W, C) at draws from ``fold_seed(seed,
    index)`` (``index``: the batch counter; see ``train.loop.train_loop``
    for the one each path passes)."""
    gen = torch.Generator().manual_seed(fold_seed(seed, index))
    b = x.shape[0]
    offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=gen)
    flips = torch.rand(b, generator=gen) < 0.5
    return crop_flip(x, offsets, flips, pad)
