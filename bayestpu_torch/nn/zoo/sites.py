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

from bayestpu_torch.nn.bayes import BayesSite
from bayestpu_torch.nn.fused import BayesDense
from bayestpu_torch.nn.layers import BatchNorm, Dense, _Conv


class SiteModel(nn.Module):
    num_sites: int = 0
    masked: bool = False
    # a site that masks before a head (``number_sites``): the activations
    # after it carry the sample axis
    conv_sites: bool = False

    def number_sites(self, sites: Iterable, heads: Iterable[nn.Module]
                     ) -> None:
        """``site.site`` = the MC seed index of each site in JAX call order
        (None: no MC mask); sites that share one index (a block's conv and
        its projection) are given once, as a list. ``heads`` are the sites
        whose output is logits (each exit head and the last one): any other
        site that masks makes the activations after it carry the sample
        axis (``conv_sites``)."""
        heads = list(heads)
        self.num_sites = 0
        masked = carries = False
        for group in sites:
            group = group if isinstance(group, list) else [group]
            stochastic = group[0].stochastic
            for site in group:
                site.site = self.num_sites if stochastic else None
                masked |= site.masked
            self.num_sites += stochastic
            if not any(group[0] is h for h in heads):
                carries |= stochastic or group[0].masked
        self.masked, self.conv_sites = masked, carries

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

    def run_site(self, site: nn.Module, y: torch.Tensor, carry: int | None,
                 seeds: torch.Tensor, idx
                 ) -> tuple[torch.Tensor, int | None]:
        """Run a site (a materialized ``BayesSite``, or a fused
        ``BayesConv`` or ``BayesDense`` that is the site) on y, whose
        leading axis holds S·N rows when ``carry`` = S (the activations
        carry the sample axis): the site gets them as (S, N, …), never S
        folded into the batch, which would shift the rows of its mask. A
        site that returns S samples of an x without them starts the carry.
        Returns the output with S folded into the batch, and the carry."""
        y_in = y.unflatten(0, (carry, -1)) if carry else y
        kw = dict(seeds=self.site_seeds(site, seeds),
                  sample_idx=idx)
        if isinstance(site, BayesSite):
            kw["carries_samples"] = carry is not None
        out = site(y_in, **kw)
        if out.dim() > y_in.dim():
            carry = out.shape[0]
        elif carry is None:
            return out, None
        return out.flatten(0, 1), carry

    def prepare(self, x: torch.Tensor, seeds: torch.Tensor, sample_idx):
        """Check ``seeds``; return ``(idx, sample_shape)``: the index
        argument of the sites (None, an int, or a 1-D tensor on x's device
        that the kernels read there, so that a predict copies nothing
        between host and card) and () or (S,)."""
        dims = (2,) if self.training else (2, 3)
        if seeds.dim() not in dims or seeds.shape[-2:] != (self.num_sites,
                                                           2):
            want = ("(n_sites, 2) in train mode" if self.training
                    else "(n_sites, 2) or (S, n_sites, 2)")
            raise ValueError(f"seeds must be {want} with n_sites="
                             f"{self.num_sites}; got {tuple(seeds.shape)}")
        return (self._sample_idx(seeds, sample_idx, x.device),
                tuple(seeds.shape[:-2]))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the JAX package's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
