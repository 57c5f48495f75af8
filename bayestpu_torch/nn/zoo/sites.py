"""What the zoo's models share: the Bayesian sites in JAX call order, and
the ``seeds`` and ``sample_idx`` arguments of ``forward``.

A model numbers its MC sites in the JAX model's call order
(``number_sites``): each site that draws masks (``stochastic``: MC at
rate > 0) gets the index of its seed pair in ``seeds[..., n_sites, 2]``;
``masked`` says whether any site is a Masksembles one. ``prepare`` checks
the seeds and turns ``sample_idx`` into what the heads and conv sites take
(see ``vgg.py``'s module docstring for the two call forms).
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from bayestpu_torch.nn.fused import BayesDense
from bayestpu_torch.nn.layers import BatchNorm, Dense, _Conv


class SiteModel(nn.Module):
    num_sites: int = 0
    masked: bool = False
    conv_sites: bool = False     # a conv input site that masks

    def number_sites(self, sites: Iterable[nn.Module]) -> None:
        """``site.site`` = the MC seed index of each site in JAX call order
        (None: no MC mask); sites that share one index (a block's conv and
        its projection) are given once, as a list."""
        self.num_sites = 0
        masked = False
        for group in sites:
            group = group if isinstance(group, list) else [group]
            stochastic = group[0].stochastic
            for site in group:
                site.site = self.num_sites if stochastic else None
                masked |= site.masked
            self.num_sites += stochastic
        self.masked = masked

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initializers, drawn in module order from ``generator``."""
        for m in self.modules():
            if isinstance(m, (_Conv, BatchNorm, Dense, BayesDense)):
                m.reset_parameters(generator)

    @staticmethod
    def site_seeds(site: nn.Module, seeds: torch.Tensor
                   ) -> torch.Tensor | None:
        return (None if site.site is None
                else seeds[..., site.site, :].contiguous())

    def _sample_idx(self, seeds: torch.Tensor, sample_idx, device):
        """The Masksembles index argument of the heads; None for a model
        without Masksembles sites."""
        if not self.masked or self.training:
            return None
        if seeds.dim() == 3:
            num = seeds.shape[0]
            if sample_idx is None:
                return torch.arange(num, dtype=torch.int32, device=device)
            if (not isinstance(sample_idx, torch.Tensor)
                    or tuple(sample_idx.shape) != (num,)):
                raise ValueError(f"with (S, n_sites, 2) seeds sample_idx "
                                 f"must be a tensor of S={num} indices")
            return sample_idx
        if isinstance(sample_idx, torch.Tensor) and sample_idx.dim() != 0:
            raise ValueError("with (n_sites, 2) seeds sample_idx must be an "
                             "int")
        return 0 if sample_idx is None else sample_idx

    def prepare(self, x: torch.Tensor, seeds: torch.Tensor, sample_idx):
        """Check ``seeds``; return ``(idx, idx_host, sample_shape)``: the
        index argument of the sites, the same as host ints for the sites
        after the activations carry the sample axis (copied once, before
        any launch, rather than at every later site), and () or (S,)."""
        dims = (2,) if self.training else (2, 3)
        if seeds.dim() not in dims or seeds.shape[-2:] != (self.num_sites,
                                                           2):
            want = ("(n_sites, 2) in train mode" if self.training
                    else "(n_sites, 2) or (S, n_sites, 2)")
            raise ValueError(f"seeds must be {want} with n_sites="
                             f"{self.num_sites}; got {tuple(seeds.shape)}")
        idx = self._sample_idx(seeds, sample_idx, x.device)
        idx_host = idx
        if isinstance(idx, torch.Tensor) and self.conv_sites:
            idx_host = (list(range(idx.shape[0])) if sample_idx is None
                        else idx.tolist())
        return idx, idx_host, tuple(seeds.shape[:-2])


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the JAX package's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
