"""The LeNet family (counterpart of ``bayestpu/nn/zoo/lenet.py``):
``lenet`` and ``lenet_me`` on MNIST shapes, 28×28×1.

``forward(x, seeds, sample_idx=None)`` takes NHWC images and returns
``ExitOutputs`` as ``VGG`` does (see ``vgg.py``'s docstring for the seeds
and ``sample_idx`` forms), the MC sites numbered in the JAX model's call
order.

- ``LeNet`` (``lenet.py:51-114``): conv(20, 5×5, SAME) + relu + max pool 2
  → conv(20, 5×5, SAME) + relu + max pool 7 → flatten (2×2×20 = 80
  features, in NHWC order) → dense(100) + relu → dense(10). Its three
  insertion points (before ``conv2d_2``, before ``fc_1``, before ``fc_2``)
  take a Bayesian site back to front: ``num_bayes_layers`` = n puts one on
  the last n (``_site_on``, ``lenet.py:46-48``). With ``fused=True`` site 0
  is ``conv2d_2`` itself (``BayesConv``; at 20 input channels it routes
  unfused, the threefry ``drop`` inside the conv, as JAX routes it) and
  site 1 ``fc_1`` (a fused ``BayesDense``); with ``fused=False`` they are
  the materialized ``bayes_0`` and ``bayes_1`` (``BayesSite``) before the
  plain layers. Site 2 is the head ``fc_2``.
- ``LeNetME`` (``lenet.py:117-160``): the same stem, then an early exit (a
  stride-7 SAME conv collapsing the 14×14 map to 2×2, flatten, dense(100),
  relu, the head ``fc_2nd_exit``) and the main exit (``conv2d_2``, max
  pool 7, ``fc_1``, the head ``fc_exit_1st``); both heads carry a site.

In the spatial mapping the layers before the first site run once; after a
site that is not the last, the activations carry the sample axis (folded
into the batch for the plain layers, (S, N, …) for each later site, whose
head makes one ``_xs`` launch). The int8 model (``quant.int8_infer``) runs
the convs on the float path (20 input channels stay below
``_int8_conv_on_mxu``), ``fc_1`` as int8 × int8 and the fused heads on the
int8 kernels. Parameter names follow the Flax tree (``conv2d_1.kernel`` ≙
``params/conv2d_1/kernel``, ``masks/bayes_0/Masksembles_0/bank``), so
``interop.from_flax`` loads a JAX tree by name.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.nn.bayes import BayesSite
from bayestpu_torch.nn.fused import BayesConv, BayesDense
from bayestpu_torch.nn.layers import Conv, Dense, QuantAct, max_pool
from bayestpu_torch.nn.multiexit import ExitOutputs, stack_exits
from bayestpu_torch.nn.zoo.registry import register_model
from bayestpu_torch.nn.zoo.sites import SiteModel, flatten_nhwc

_NUM_SITES = 3
_WIDTH, _HIDDEN = 20, 100


def _site_on(site_idx: int, num_bayes_layers: int) -> bool:
    """Back-to-front countdown insertion (``lenet.py:46-48``)."""
    return site_idx >= _NUM_SITES - num_bayes_layers


class _LeNetBase(SiteModel):
    """The stem both models share: ``conv2d_1`` (on the raw image,
    ``quant_input=False``), relu, max pool 2."""

    def __init__(self, bayes: BayesConfig, num_classes: int,
                 quant: QuantConfig | None, dtype: torch.dtype,
                 input_shape: tuple[int, int, int]):
        super().__init__()
        self.bayes, self.quant = bayes, quant
        self.input_shape = tuple(input_shape)
        self.conv2d_1 = Conv(input_shape[2], _WIDTH, (5, 5), quant=quant,
                             dtype=dtype, quant_input=False)
        self.relu1 = QuantAct(quant)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → the pooled (N, 20, H/2, W/2), channels_last."""
        return max_pool(self.relu1(self.conv2d_1(x.permute(0, 3, 1, 2))), 2)


class LeNet(_LeNetBase):
    """Single-exit LeNet with ``bayes.num_bayes_layers`` sites."""

    def __init__(self, bayes: BayesConfig = BayesConfig(),
                 num_classes: int = 10, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 input_shape: tuple[int, int, int] = (28, 28, 1)):
        super().__init__(bayes, num_classes, quant, dtype, input_shape)
        nb = bayes.num_bayes_layers
        q, dt = quant, dtype
        # the module of each of sites 0 and 1 (None: no site there)
        self._sites: list[str | None] = [None, None]
        if _site_on(0, nb) and fused:
            self.conv2d_2 = BayesConv(_WIDTH, _WIDTH, (5, 5), bayes=bayes,
                                      quant=q, dtype=dt, use_bias=True)
            self._sites[0] = "conv2d_2"
        else:
            if _site_on(0, nb):
                self.bayes_0 = BayesSite(bayes, _WIDTH)
                self._sites[0] = "bayes_0"
            self.conv2d_2 = Conv(_WIDTH, _WIDTH, (5, 5), quant=q, dtype=dt)
        self.relu2 = QuantAct(q)
        h, w = input_shape[0] // 2 // 7, input_shape[1] // 2 // 7
        width = _WIDTH * h * w
        if _site_on(1, nb) and fused:
            self.fc_1 = BayesDense(width, _HIDDEN, bayes=bayes, fused=True,
                                   quant=q, dtype=dt)
            self._sites[1] = "fc_1"
        else:
            if _site_on(1, nb):
                self.bayes_1 = BayesSite(bayes, width)
                self._sites[1] = "bayes_1"
            self.fc_1 = Dense(width, _HIDDEN, quant=q, dtype=dt)
        self.relu3 = QuantAct(q)
        head_bayes = bayes if _site_on(2, nb) else dataclasses.replace(
            bayes, kind=DropoutKind.NONE)
        self.fc_2 = BayesDense(_HIDDEN, num_classes, bayes=head_bayes,
                               fused=fused, quant=q, dtype=dt)
        self.number_sites([getattr(self, n) for n in self._sites
                           if n is not None] + [self.fc_2], [self.fc_2])
        self.eval()

    def forward(self, x: torch.Tensor, seeds: torch.Tensor,
                sample_idx=None) -> ExitOutputs:
        idx, sample_shape = self.prepare(x, seeds, sample_idx)

        def layer(i: int, plain: nn.Module, y: torch.Tensor, carry):
            """Site i, then the plain layer it precedes unless the site is
            that layer (fused)."""
            if self._sites[i] is None:
                return plain(y), carry
            site = getattr(self, self._sites[i])
            y, carry = self.run_site(site, y, carry, seeds, idx)
            return (y if site is plain else plain(y)), carry

        out, carry = layer(0, self.conv2d_2, self.stem(x), None)
        out = flatten_nhwc(max_pool(self.relu2(out), 7))
        out, carry = layer(1, self.fc_1, out, carry)
        feat = self.relu3(out)
        if carry:
            feat = feat.unflatten(0, (carry, -1))
        logits = self.fc_2(feat, self.site_seeds(self.fc_2, seeds), idx)
        logits = logits.expand(sample_shape + tuple(logits.shape[-2:]))
        return stack_exits([logits], [feat])


class LeNetME(_LeNetBase):
    """Two-exit Bayesian LeNet: exit 0 the early branch, exit 1 the main
    one, each with a site before its head."""

    def __init__(self, bayes: BayesConfig = BayesConfig(),
                 num_classes: int = 10, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 input_shape: tuple[int, int, int] = (28, 28, 1)):
        super().__init__(bayes, num_classes, quant, dtype, input_shape)
        q, dt = quant, dtype
        h, w = input_shape[0] // 2, input_shape[1] // 2
        self.conv2d_2_2nd_exit = Conv(_WIDTH, _WIDTH, (5, 5), (7, 7),
                                      quant=q, dtype=dt)
        self.relu2_2nd_exit = QuantAct(q)
        width_e = _WIDTH * (-(-h // 7)) * (-(-w // 7))   # SAME, stride 7
        self.fc_1_2nd_exit = Dense(width_e, _HIDDEN, quant=q, dtype=dt)
        self.relu3_2nd_exit = QuantAct(q)
        self.fc_2nd_exit = BayesDense(_HIDDEN, num_classes, bayes=bayes,
                                      fused=fused, quant=q, dtype=dt)
        self.conv2d_2 = Conv(_WIDTH, _WIDTH, (5, 5), quant=q, dtype=dt)
        self.relu2 = QuantAct(q)
        self.fc_1 = Dense(_WIDTH * (h // 7) * (w // 7), _HIDDEN, quant=q,
                          dtype=dt)
        self.relu3 = QuantAct(q)
        self.fc_exit_1st = BayesDense(_HIDDEN, num_classes, bayes=bayes,
                                      fused=fused, quant=q, dtype=dt)
        heads = [self.fc_2nd_exit, self.fc_exit_1st]
        self.number_sites(heads, heads)
        self.eval()

    def forward(self, x: torch.Tensor, seeds: torch.Tensor,
                sample_idx=None) -> ExitOutputs:
        idx, sample_shape = self.prepare(x, seeds, sample_idx)
        out = self.stem(x)
        e = flatten_nhwc(self.relu2_2nd_exit(self.conv2d_2_2nd_exit(out)))
        feat_e = self.relu3_2nd_exit(self.fc_1_2nd_exit(e))
        m = flatten_nhwc(max_pool(self.relu2(self.conv2d_2(out)), 7))
        feat_m = self.relu3(self.fc_1(m))
        exits = [head(feat, self.site_seeds(head, seeds), idx)
                 for head, feat in ((self.fc_2nd_exit, feat_e),
                                    (self.fc_exit_1st, feat_m))]
        return stack_exits([y.expand(sample_shape + tuple(y.shape[-2:]))
                            for y in exits], [feat_e, feat_m])


@register_model("lenet")
def build_lenet(**kw) -> LeNet:
    return LeNet(**kw)


@register_model("lenet_me")
def build_lenet_me(**kw) -> LeNetME:
    return LeNetME(**kw)
