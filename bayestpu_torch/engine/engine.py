"""BayesEngine — the init/predict/evaluate facade of the port.

Counterpart of ``bayestpu/engine/engine.py``. The engine owns the model on
one device, which is ``"cuda"`` unless the caller asks for the CPU; it
raises when asked for a card that is not there, and never falls back.
Inputs are NHWC images (numpy or torch); seeds are integers from which
``core.rng.sample_seeds`` derives every MC mask. ``evaluate`` can add the
OOD check (aPE on gaussian noise images). ``autotune``, ``compile``,
``evaluate_repeated`` and sample-axis sharding come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from bayestpu_torch.core.config import BayesConfig, EngineConfig, SamplingMode
from bayestpu_torch.core.rng import sample_seeds
from bayestpu_torch.engine import sampler
from bayestpu_torch.engine.sampler import Predictive
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.metrics.ece import eval_metrics
from bayestpu_torch.metrics.entropy import (mean_predictive_entropy,
                                            random_noise_data,
                                            random_noise_like)

# the seed of the OOD noise generator (the JAX engine's jax.random.key(99))
NOISE_SEED = 99


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class BayesEngine:
    """Executable wrapper around a port model for MC inference."""

    def __init__(self, model: torch.nn.Module,
                 bayes: BayesConfig | None = None,
                 config: EngineConfig = EngineConfig(),
                 device: str | torch.device = "cuda"):
        if config.mode is SamplingMode.SHARDED:
            raise NotImplementedError("sample-axis sharding is not ported "
                                      "yet: ROADMAP Queue 1 item 13")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.bayes = bayes if bayes is not None else getattr(
            model, "bayes", BayesConfig())
        self.config = config
        self.ready = False

    # ------------------------------------------------------------ lifecycle

    def init(self, seed: int, sample_input: Any) -> "BayesEngine":
        """Fresh parameters from Flax's initializers, drawn from ``seed``."""
        x = self._input(sample_input)
        if tuple(x.shape[1:]) != self.model.input_shape:
            raise ValueError(f"sample_input {tuple(x.shape)} does not fit "
                             f"the model's input {self.model.input_shape}")
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.ready = True
        return self

    def attach(self, variables: Any) -> "BayesEngine":
        """Weights from a JAX variables tree (nested dicts of numpy
        arrays); see ``interop.from_flax``."""
        load_flax_variables(self.model, variables)
        self.ready = True
        return self

    def _mode(self) -> SamplingMode:
        # an untuned AUTO runs spatial, as the JAX engine does
        return (SamplingMode.SPATIAL if self.config.mode is SamplingMode.AUTO
                else self.config.mode)

    def _input(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def seeds(self, seed: int, num_samples: int) -> torch.Tensor:
        """(S, n_sites, 2) int32 MC seeds on the engine's device."""
        return sample_seeds(seed, num_samples, self.model.num_sites).to(
            self.device)

    # ------------------------------------------------------------ inference

    @torch.inference_mode()
    def predict(self, x: Any, seed: int = 0, num_samples: int | None = None,
                sample_idx: int | None = None
                ) -> Predictive | torch.Tensor:
        """MC-averaged predictive distribution over ``num_samples`` samples,
        or with ``sample_idx`` the per-exit softmax (E, B, C) of that one
        sample, which equals sample ``sample_idx`` of the MC average."""
        if not self.ready:
            raise RuntimeError("engine not initialized: call init()/attach()")
        x = self._input(x)
        if sample_idx is not None:
            seeds = self.seeds(seed, sample_idx + 1)[sample_idx]
            return torch.softmax(self.model(x, seeds).logits, dim=-1)
        seeds = self.seeds(seed, sampler.num_effective_samples(
            self.bayes, num_samples))
        if self._mode() is SamplingMode.TEMPORAL:
            return sampler.mc_moments(self.model, x, seeds)
        return sampler.predictive(self.model, x, seeds, SamplingMode.SPATIAL)

    def _noise_for(self, x: torch.Tensor, dataset: str | None
                   ) -> torch.Tensor:
        """OOD probe inputs of x's shape: with ``dataset``, the reference's
        fixed per-dataset stats; without, x's own mean and std."""
        gen = torch.Generator().manual_seed(NOISE_SEED)
        if dataset is not None:
            return random_noise_data(gen, dataset, tuple(x.shape)).to(
                self.device)
        noise = random_noise_like(gen, tuple(x.shape)).to(self.device)
        return x.mean() + x.std(correction=0) * noise

    @torch.inference_mode()
    def evaluate(self, x: Any, y: Any, seed: int = 0,
                 num_samples: int | None = None, ood_check: bool = False,
                 dataset: str | None = None) -> dict[str, float]:
        """acc / NLL / MSE / ECE / aPE of the final exit's MC predictive,
        fetched from the device in one transfer. ``ood_check`` adds
        ``aPE_ood``, the aPE on gaussian noise images of x's shape drawn
        with the same seed's masks (``engine.py:221-260``); ``dataset``
        names the benchmark whose fixed noise stats to use."""
        x = self._input(x)
        probs = self.predict(x, seed, num_samples).probs[-1]
        labels = torch.as_tensor(y, dtype=torch.int64, device=self.device)
        mets = eval_metrics(probs, labels)
        mets["aPE"] = mean_predictive_entropy(probs)
        if ood_check:
            noise = self._noise_for(x, dataset)
            mets["aPE_ood"] = mean_predictive_entropy(
                self.predict(noise, seed, num_samples).probs[-1])
        values = torch.stack([v.float() for v in mets.values()]).tolist()
        return dict(zip(mets, values))
