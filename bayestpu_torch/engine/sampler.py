"""Monte-Carlo sampling: temporal and spatial mapping of the MC samples.

Counterpart of ``bayestpu/engine/sampler.py:52-130``, on explicit seeds:
``seeds`` is the (S, n_sites, 2) int32 tensor of ``core.rng.sample_seeds``
(or seeds captured from the JAX package), on the model's device. Sample *i*
also gets the index *i*, which a Masksembles model uses as its mask index
(``i % num_masks``) and an MC model ignores (``sampler.py:61-72,115-127``);
a Masksembles model has no MC sites, so its seeds are (S, 0, 2).

- temporal: the whole network runs once per sample; every Bayesian site
  launches the single-sample kernel.
- spatial: the model runs once with all S seeds: the deterministic layers
  before the first Bayesian site run once, and that site makes all S
  samples at once (a fused site in one samples launch, a materialized one,
  ``BayesianDropout`` on threefry masks or a Masksembles row, with S masks
  drawn in one pass). When every site is a head (``vgg11_me``,
  ``lenet_me``) the backbone runs once and each head launches one samples
  kernel. After a site that is not a head (a fused conv site, as in
  ``vgg11`` with ``dropout="block"``, or a materialized one, as in
  ``lenet(num_bayes_layers=3)``) the activations carry S: the later
  deterministic layers run on S·N rows, and each later site takes them as
  (S, N, …), sample s under its own seeds (a fused one in one ``_xs``
  launch, as JAX's ``lax.map`` fallback runs one single kernel per
  sample).

Sample *i* sees the same masks in both mappings, so their per-sample logits
agree bit for bit on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bayestpu_torch.core.config import BayesConfig, DropoutKind, SamplingMode


class Predictive(NamedTuple):
    """probs (E, B, C): MC mean of the softmax; var (E, B, C): per-class
    variance over samples; entropy (E, B): entropy of the mean."""

    probs: torch.Tensor
    var: torch.Tensor
    entropy: torch.Tensor
    num_samples: int


def _entropy(p: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return -torch.sum(p * torch.log(p + eps), dim=-1)


def mc_logits(model, x: torch.Tensor, seeds: torch.Tensor,
              mode: SamplingMode = SamplingMode.SPATIAL) -> torch.Tensor:
    """All per-sample, per-exit logits: (S, E, B, C). ``SHARDED`` (and an
    untuned ``AUTO``) runs as spatial, as in JAX (``sampler.py:70-72``):
    on one process the sharded mapping is the spatial one, and the mesh's
    split is ``engine.sharding``'s."""
    if mode is SamplingMode.TEMPORAL:
        return torch.stack([model(x, seeds[s], s).logits
                            for s in range(seeds.shape[0])])
    return model(x, seeds).logits    # sample_idx defaults to arange(S)


def predictive(model, x: torch.Tensor, seeds: torch.Tensor,
               mode: SamplingMode = SamplingMode.SPATIAL) -> Predictive:
    """MC-averaged predictive distribution (materializes all samples)."""
    probs = torch.softmax(mc_logits(model, x, seeds, mode), dim=-1)
    mean = probs.mean(dim=0)
    var = probs.var(dim=0, correction=0)
    return Predictive(mean, var, _entropy(mean), seeds.shape[0])


def mc_moments(model, x: torch.Tensor, seeds: torch.Tensor) -> Predictive:
    """Streaming predictive moments, one sample at a time (the temporal
    mapping): sum and sum of squares of the softmax, never all samples."""
    num_samples = seeds.shape[0]
    s1 = s2 = None
    for s in range(num_samples):
        p = torch.softmax(model(x, seeds[s], s).logits, dim=-1)
        s1 = p if s1 is None else s1 + p
        s2 = p * p if s2 is None else s2 + p * p
    mean = s1 / num_samples
    var = torch.clamp(s2 / num_samples - mean * mean, min=0.0)
    return Predictive(mean, var, _entropy(mean), num_samples)


def num_effective_samples(bayes: BayesConfig, num_samples: int | None = None
                          ) -> int:
    """Masksembles enumerates its masks; MC dropout draws ``num_samples``."""
    if bayes.kind is DropoutKind.MASK:
        return bayes.num_masks
    return num_samples if num_samples is not None else bayes.num_samples


def split_apply(backbone_fn, head_fn, x: torch.Tensor, seed: int,
                num_samples: int, num_sites: int = 1) -> torch.Tensor:
    """Run the deterministic ``backbone_fn(x)`` once and the stochastic
    ``head_fn(cached, seeds_i, i)`` once per sample, stacked on a leading
    sample axis (``sampler.py:143-155``, where the JAX package vmaps the
    head over per-sample keys). ``seeds_i`` is sample i's (num_sites, 2)
    int32 seeds of ``core.rng.sample_seeds(seed, …)`` on x's device, in
    place of JAX's key."""
    from bayestpu_torch.core.rng import sample_seeds
    cached = backbone_fn(x)
    seeds = sample_seeds(seed, num_samples, num_sites).to(x.device)
    return torch.stack([head_fn(cached, seeds[i], i)
                        for i in range(num_samples)])
