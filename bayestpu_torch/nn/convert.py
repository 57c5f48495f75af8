"""NN→BNN conversion: layer specs, insertion strategies, ``Sequential`` and
the Bayesian wrapper models (counterpart of ``bayestpu/nn/convert.py``).

- The spec dataclasses ``D``, ``C``, ``Act``, ``Pool``, ``Flatten`` and
  ``Bayes``, the strategies ``strategy_default``/``strategy_last``/
  ``strategy_full`` (``STRATEGIES``), ``convert_to_bayesian`` and
  ``lenet_specs`` are copies of the JAX module's pure-Python part
  (``convert.py:45-140,296-306``); a test pins each to the original.
- ``Sequential`` is the ``nn.Module`` built from a spec tuple. Flax infers
  the Dense widths from the first input; here ``input_shape`` ((H, W, C)
  or (F,)) fixes them. Children carry the Flax names (``conv_{i}``,
  ``dense_{i}``, ``act_{i}``, ``bayes_{i}`` with ``BayesianDropout_0`` or
  ``Masksembles_0``), so ``interop.from_flax`` loads a JAX tree by name.
  ``forward(x, seeds, sample_idx=None)`` takes NHWC images (or (B, F)
  vectors) and returns ``ExitOutputs`` with one exit, the features being
  the input of the last Dense; seeds and ``sample_idx`` take the forms of
  ``SiteModel`` (``nn/zoo/vgg.py``'s docstring), the MC sites numbered in
  spec order.
- With ``fused=True`` a ``Bayes`` spec directly before a ``C`` or ``D``
  defers into that layer (``BayesConv`` or ``BayesDense``, the masked
  kernels), never into the last Dense (its input is the exit feature:
  ``convert.py:200-216``), and into a conv only at stride (1, 1) with
  string padding; ``BayesConv``'s own rule routes a conv of fewer than
  ``MASKED_CONV_FUSE_MIN_CH`` input channels unfused (its threefry
  ``drop``). Every other ``Bayes`` is a materialized ``BayesSite``.
- In the spatial mapping the layers before the first site run once; after
  a site the activations carry the sample axis (S folded into the batch
  for the plain layers, (S, N, …) for every later site: a fused one makes
  one ``_xs`` launch on the card).
- ``MCDropoutModel`` and ``MasksemblesModel`` (``convert.py:225-294``)
  convert a spec list and build the unfused ``Sequential``, as JAX does;
  ``__call__(x, seed, train=False)`` is a plain stochastic forward in
  training and the MC-averaged final-exit probabilities otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
from torch import nn

from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                        InsertStrategy, QuantConfig)
from bayestpu_torch.core.rng import sample_seeds
from bayestpu_torch.engine import sampler
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.kernels.masked_conv import conv_geometry
from bayestpu_torch.metrics.ece import eval_metrics
from bayestpu_torch.nn.bayes import BayesSite
from bayestpu_torch.nn.fused import BayesConv, BayesDense
from bayestpu_torch.nn.layers import Conv, Dense, QuantAct, avg_pool, max_pool
from bayestpu_torch.nn.multiexit import ExitOutputs, stack_exits

# ----------------------------------------------------------- layer specs


@dataclasses.dataclass(frozen=True)
class D:
    """Dense layer spec."""
    features: int


@dataclasses.dataclass(frozen=True)
class C:
    """Conv layer spec."""
    features: int
    kernel: tuple[int, int] = (3, 3)
    strides: tuple[int, int] = (1, 1)
    padding: str = "SAME"


@dataclasses.dataclass(frozen=True)
class Act:
    fn: str = "relu"


@dataclasses.dataclass(frozen=True)
class Pool:
    kind: str = "max"          # "max" | "avg"
    window: int = 2
    strides: int | None = None


@dataclasses.dataclass(frozen=True)
class Flatten:
    pass


@dataclasses.dataclass(frozen=True)
class Bayes:
    """An inserted Bayesian site (carries its own config)."""
    cfg: BayesConfig


Spec = object
_COMPUTE = (D, C)


def _is_compute(s: Spec) -> bool:
    return isinstance(s, _COMPUTE)


# ------------------------------------------------------ insertion strategies


def strategy_default(specs: Sequence[Spec], num: int) -> list[int]:
    """Indices BEFORE which to insert: the last ``num`` Dense/Conv layers
    (``nn2bnn.py:9-28``)."""
    idx = [i for i, s in enumerate(specs) if _is_compute(s)]
    return idx[-num:] if num > 0 else []


def strategy_last(specs: Sequence[Spec], num: int = 1) -> list[int]:
    """Index of the first Dense after the last Conv (``nn2bnn.py:30-58``)."""
    del num
    last_conv = max((i for i, s in enumerate(specs) if isinstance(s, C)),
                    default=-1)
    for i in range(last_conv + 1, len(specs)):
        if isinstance(specs[i], D):
            return [i]
    return []


def strategy_full(specs: Sequence[Spec], num: int = 0) -> list[int]:
    """AFTER every Dense/Conv, returned as before-indices (compute index +
    1; ``nn2bnn.py:60-72``)."""
    del num
    return [i + 1 for i, s in enumerate(specs) if _is_compute(s)]


STRATEGIES: dict[InsertStrategy, Callable] = {
    InsertStrategy.DEFAULT: strategy_default,
    InsertStrategy.LAST: strategy_last,
    InsertStrategy.FULL: strategy_full,
}


def convert_to_bayesian(specs: Sequence[Spec], bayes: BayesConfig
                        ) -> list[Spec]:
    """Insert ``Bayes`` sites per ``bayes.strategy``/``num_bayes_layers``
    (≙ ``_convert_model``, ``nn2bnn.py:74-146``)."""
    positions = STRATEGIES[bayes.strategy](list(specs),
                                           bayes.num_bayes_layers)
    out: list[Spec] = []
    pos = set(positions)
    for i, s in enumerate(list(specs) + [None]):
        if i in pos:
            out.append(Bayes(bayes))
        if s is not None:
            out.append(s)
    return out


def lenet_specs(num_classes: int = 10) -> list[Spec]:
    """The float LeNet of the autobayes zoo as specs, the converter's
    canonical test subject (``convert.py:296-306``)."""
    return [
        C(20, (5, 5)), Act(), Pool("max", 2),
        C(20, (5, 5)), Act(), Pool("max", 7),
        Flatten(),
        D(100), Act(),
        D(num_classes),
    ]


# --------------------------------------------------------------- Sequential

# imported here, after the specs: ``nn.zoo`` registers the autobayes models,
# whose module imports the specs above from this one
from bayestpu_torch.nn.zoo.sites import SiteModel, flatten_nhwc  # noqa: E402


def _defers(specs: Sequence[Spec], i: int, fused: bool) -> bool:
    """Whether the ``Bayes`` spec at i defers into the layer after it
    (``convert.py:200-216``)."""
    nxt = specs[i + 1] if i + 1 < len(specs) else None
    last_d = max((j for j, t in enumerate(specs) if isinstance(t, D)),
                 default=-1)
    return (fused and isinstance(nxt, (C, D)) and i + 1 != last_d
            and (isinstance(nxt, D)
                 or (tuple(nxt.strides) == (1, 1)
                     and isinstance(nxt.padding, str))))


class Sequential(SiteModel):
    """The port model of a spec tuple (see the module docstring)."""

    def __init__(self, specs: Sequence[Spec], input_shape: Sequence[int],
                 quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        self.specs = tuple(specs)
        self.input_shape = tuple(int(d) for d in input_shape)
        self.quant, self.dtype, self.fused = quant, dtype, fused
        q, dt = quant, dtype
        shape = self.input_shape          # NHWC, or (F,)
        pending: BayesConfig | None = None
        # (kind, module name or spec) in spec order; a site is run by
        # ``run_site``
        self._steps: list[tuple[str, Any]] = []
        sites = []
        for i, s in enumerate(self.specs):
            if isinstance(s, C):
                if len(shape) != 3:
                    raise ValueError(f"spec {i} {s}: a conv needs an image; "
                                     f"the activations are {shape}")
                h, w, c = shape
                name = f"conv_{i}"
                if pending is not None:
                    m = BayesConv(c, s.features, tuple(s.kernel),
                                  tuple(s.strides), s.padding, bayes=pending,
                                  quant=q, dtype=dt, use_bias=True)
                    sites.append(m)
                    self._steps.append(("site", name))
                    pending = None
                else:
                    m = Conv(c, s.features, tuple(s.kernel), tuple(s.strides),
                             s.padding, quant=q, dtype=dt)
                    self._steps.append(("layer", name))
                self.add_module(name, m)
                g = conv_geometry(h, w, *s.kernel, s.padding, m.stride)
                shape = (g.ho, g.wo, s.features)
            elif isinstance(s, D):
                name = f"dense_{i}"
                width = math.prod(shape)
                if pending is not None:
                    m = BayesDense(width, s.features, bayes=pending,
                                   fused=True, quant=q, dtype=dt)
                    sites.append(m)
                    pending = None
                else:
                    m = Dense(width, s.features, quant=q, dtype=dt)
                self.add_module(name, m)
                self._steps.append(("dense", name))
                shape = (s.features,)
            elif isinstance(s, Act):
                if s.fn != "relu":
                    raise ValueError(f"spec {i} {s}: the port's QuantAct "
                                     "is relu, as every spec list's Act")
                self.add_module(f"act_{i}", QuantAct(q))
                self._steps.append(("layer", f"act_{i}"))
            elif isinstance(s, Pool):
                if s.kind not in ("max", "avg"):
                    raise ValueError(f"spec {i} {s}: pool kind must be max "
                                     f"or avg")
                stride = s.strides or s.window
                shape = ((shape[0] - s.window) // stride + 1,
                         (shape[1] - s.window) // stride + 1, shape[2])
                self._steps.append(("pool", s))
            elif isinstance(s, Flatten):
                shape = (math.prod(shape),)
                self._steps.append(("flatten", None))
            elif isinstance(s, Bayes):
                if _defers(self.specs, i, fused):
                    pending = s.cfg    # consumed by the next layer's kernel
                else:
                    site = BayesSite(s.cfg, shape[-1])
                    self.add_module(f"bayes_{i}", site)
                    sites.append(site)
                    self._steps.append(("site", f"bayes_{i}"))
            else:
                raise TypeError(f"unknown spec {s!r}")
        self.output_shape = shape
        self.number_sites(sites, [])
        self.eval()

    def forward(self, x: torch.Tensor, seeds: torch.Tensor,
                sample_idx=None) -> ExitOutputs:
        idx, sample_shape = self.prepare(x, seeds, sample_idx)
        y = x.permute(0, 3, 1, 2) if x.dim() == 4 else x   # NCHW view
        carry = feat = None
        for kind, arg in self._steps:
            if kind == "pool":
                pool = max_pool if arg.kind == "max" else avg_pool
                y = pool(y, arg.window, arg.strides)
            elif kind == "flatten":
                y = flatten_nhwc(y) if y.dim() == 4 else y
            elif kind == "dense":
                y = feat = flatten_nhwc(y) if y.dim() == 4 else y
                m = getattr(self, arg)
                if isinstance(m, BayesDense):
                    y, carry = self.run_site(m, y, carry, seeds, idx)
                else:
                    y = m(y)
            elif kind == "site":
                m = getattr(self, arg)
                if isinstance(m, BayesConv):
                    # the masked conv kernels read NHWC
                    y = y.contiguous(memory_format=torch.channels_last)
                y, carry = self.run_site(m, y, carry, seeds, idx)
            else:
                y = getattr(self, arg)(y)
        if y.dim() == 4:
            y = flatten_nhwc(y)
        if carry:
            y = y.unflatten(0, (carry, -1))
            feat = feat.unflatten(0, (carry, -1)) if feat is not None \
                else None
        logits = y.expand(sample_shape + tuple(y.shape[-2:]))
        return stack_exits([logits], [feat] if feat is not None else None)


# ------------------------------------------------------------- BNN wrappers


class _BayesianWrapper:
    """What the converter wrappers share (``convert.py:225-269``): the
    unfused ``Sequential`` of the converted specs on ``device`` ("cuda"
    unless the caller asks for the CPU), trained plain and served
    MC-averaged. ``input_shape`` fixes the Dense widths; without it
    ``init`` takes them from its sample input. A seed is an int (the MC
    seeds derived by ``core.rng.sample_seeds``) or the seed tensor itself:
    (n_sites, 2) for a training forward, (S, n_sites, 2) for a predict."""

    def __init__(self, specs: Sequence[Spec], bayes: BayesConfig,
                 quant: QuantConfig | None,
                 input_shape: Sequence[int] | None, device):
        from bayestpu_torch.engine.engine import resolve_device

        self.specs, self.bayes, self.quant = tuple(specs), bayes, quant
        self.device = resolve_device(device)
        self.model: Sequential | None = None
        if input_shape is not None:
            self._build(input_shape)

    def _build(self, input_shape: Sequence[int]) -> None:
        self.model = Sequential(self.specs, input_shape, self.quant).to(
            self.device)

    def _built(self) -> Sequential:
        if self.model is None:
            raise RuntimeError("no model yet: pass input_shape or call "
                               "init()")
        return self.model

    def init(self, seed: int, x: Any) -> None:
        """Fresh parameters from Flax's initializers, drawn from ``seed``,
        for inputs shaped as ``x``."""
        shape = tuple(torch.as_tensor(x).shape[1:])
        if self.model is None or self.model.input_shape != shape:
            self._build(shape)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))

    def attach(self, variables: Any) -> None:
        """Weights from a JAX variables tree (``interop.from_flax``)."""
        load_flax_variables(self._built(), variables)

    def _seeds(self, seed, lead: tuple[int, ...]) -> torch.Tensor:
        if isinstance(seed, torch.Tensor):
            return seed.to(self.device)
        n = self._built().num_sites
        s = sample_seeds(seed, lead[0] if lead else 1, n)
        return (s if lead else s[0]).to(self.device)

    def __call__(self, x: Any, seed=0, *, train: bool = False
                 ) -> torch.Tensor:
        model = self._built()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if train:
            model.train()
            try:
                return model(x, self._seeds(seed, ())).logits[-1]
            finally:
                model.eval()
        with torch.inference_mode():
            seeds = self._seeds(
                seed, (sampler.num_effective_samples(self.bayes),))
            return sampler.predictive(model, x, seeds).probs[-1]

    def predict(self, x: Any, seed=0) -> torch.Tensor:
        """MC-averaged class probabilities (≙ ``predict_hls`` averaging,
        ``nn2bnn.py:187-191``)."""
        return self(x, seed)

    def evaluate(self, x: Any, y: Any, seed=0) -> dict[str, float]:
        """acc / NLL / MSE / ECE of the MC-averaged prediction (≙
        ``evaluate_hls``, ``nn2bnn.py:193-195``), fetched in one
        transfer."""
        probs = self.predict(x, seed)
        mets = eval_metrics(probs, torch.as_tensor(
            y, dtype=torch.int64, device=self.device))
        return dict(zip(mets, torch.stack(
            [v.float() for v in mets.values()]).tolist()))


class MCDropoutModel(_BayesianWrapper):
    """≙ ``MCDropout(model, nSamples, p, num, strategy)``
    (``converter/keras/MCDropout.py:40-55``)."""

    def __init__(self, specs: Sequence[Spec], num_samples: int = 10,
                 rate: float = 0.25, num: int = 1,
                 strategy: InsertStrategy | str = InsertStrategy.DEFAULT,
                 quant: QuantConfig | None = None,
                 input_shape: Sequence[int] | None = None, device="cuda"):
        bayes = BayesConfig(kind=DropoutKind.MC, rate=rate,
                            num_samples=num_samples, num_bayes_layers=num,
                            strategy=InsertStrategy(strategy))
        converted = convert_to_bayesian(specs, bayes) if num > 0 else specs
        super().__init__(converted, bayes, quant, input_shape, device)


class MasksemblesModel(_BayesianWrapper):
    """≙ ``MasksemblesModel(model, num_masks, scale, num, strategy)``
    (``converter/keras/Masksembles.py:193-214``): a predict enumerates the
    ``num_masks`` masks, so the seed does not matter."""

    def __init__(self, specs: Sequence[Spec], num_masks: int = 4,
                 scale: float = 2.0, num: int = 1,
                 strategy: InsertStrategy | str = InsertStrategy.DEFAULT,
                 quant: QuantConfig | None = None,
                 input_shape: Sequence[int] | None = None, device="cuda"):
        bayes = BayesConfig(kind=DropoutKind.MASK, num_masks=num_masks,
                            scale=scale, num_bayes_layers=num,
                            strategy=InsertStrategy(strategy))
        converted = convert_to_bayesian(specs, bayes) if num > 0 else specs
        super().__init__(converted, bayes, quant, input_shape, device)
