"""VGG-11 with Bayesian multi-exit heads (counterpart of
``bayestpu/nn/zoo/vgg.py``; ``vgg11`` and ``vgg11_me`` are ported).

``VGG.forward(x, seeds)`` takes NHWC images and the MC seeds of every
Bayesian site, numbered in the JAX model's call order (exit1 … exit4, then
the classifier):

- seeds (n_sites, 2): one sample; logits (E, B, C).
- seeds (S, n_sites, 2): the spatial mapping. The deterministic backbone and
  exit cascades run once; only the stochastic heads see S, each in one
  multi-sample kernel launch; logits (S, E, B, C).

A model is built in eval mode, as the JAX model's ``train=False`` default.
In train mode (``model.train()``, the JAX ``train=True``) seeds are
(n_sites, 2): BatchNorm uses batch statistics and updates its running
averages, activations stay f32 between layers, and every stochastic head
goes through the trainable ``dropout_matmul``.

With ``quant`` (a ``QuantConfig``) the model is the JAX package's quantized
VGG (``vgg.py:69-292``): QAT in train mode and the fake-quant model in eval
mode, or with ``quant.int8_infer`` the int8 model, whose activations stay
int8 on the ap_fixed grid from block to block (each block's last conv
defers the cast past its max pool, then the block re-quantizes), whose exit
heads dequantize before their average pool, and whose five MC heads run
the int8 dropout-matmul kernels. ``QuantConfig`` adds no parameters.

Parameter names follow the Flax tree (``block0.convbn0.conv.kernel`` ≙
``params/block0/convbn0/conv/kernel``), so ``interop.from_flax`` loads JAX
variables by name.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.core.quant import dequantize_int8, quantize_int8
from bayestpu_torch.nn.fused import BayesDense
from bayestpu_torch.nn.layers import (BatchNorm, ConvBN, Dense, QuantAct,
                                      _Conv, avg_pool, max_pool)
from bayestpu_torch.nn.multiexit import ExitOutputs, stack_exits
from bayestpu_torch.nn.zoo.registry import register_model

CFGS: dict[str, list] = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _blocks_of(cfg: list) -> list[list[int]]:
    blocks, cur = [], []
    for v in cfg:
        if v == "M":
            blocks.append(cur)
            cur = []
        else:
            cur.append(v)
    if cur:
        blocks.append(cur)
    return blocks


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the JAX package's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _VGGBlock(nn.Module):
    """ConvBN+relu(+QuantAct) per channel width, then a 2×2 max pool; the
    int8 model re-quantizes after the pool. ``quant_input`` is False on
    block 0, whose first conv takes the raw image."""

    def __init__(self, in_ch: int, channels: Sequence[int],
                 dtype: torch.dtype, quant: QuantConfig | None = None,
                 quant_input: bool = True):
        super().__init__()
        self.quant = quant
        for i, ch in enumerate(channels):
            self.add_module(f"convbn{i}", ConvBN(
                in_ch, ch, (3, 3), dtype=dtype, quant=quant,
                quant_input=quant_input if i == 0 else True))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.children())
        for i, conv in enumerate(convs):
            x = conv(x, act="relu", act_quant=True,
                     defer_int8=i == len(convs) - 1)
        x = max_pool(x, 2, 2)
        q = self.quant
        if (not self.training and q is not None and q.int8_infer
                and x.dtype != torch.int8):
            x = quantize_int8(x, q)[0]    # exact: pooled grid values
        return x


class _VGGExitHead(nn.Module):
    """relu, stride-2 ConvBN cascade, avgpool(2), then the ``BayesDense``
    classifier ``linear``."""

    def __init__(self, in_ch: int, spatial: int, channels: Sequence[int],
                 num_classes: int, bayes: BayesConfig, dtype: torch.dtype,
                 fused: bool, quant: QuantConfig | None = None):
        super().__init__()
        self.quant = quant
        for i, ch in enumerate(channels):
            self.add_module(f"convbn{i + 1}", ConvBN(
                in_ch, ch, (3, 3), (2, 2), padding=((1, 1), (1, 1)),
                dtype=dtype, quant=quant))
            in_ch, spatial = ch, (spatial + 1) // 2
        self.pool = spatial > 1
        if self.pool:
            spatial //= 2
        self.linear = BayesDense(in_ch * spatial * spatial, num_classes,
                                 bayes=bayes, fused=fused, quant=quant,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        y = torch.relu(x)
        for name, conv in self.named_children():
            if name != "linear":
                y = conv(y, act="relu", act_quant=True)
        if y.dtype == torch.int8:
            y = dequantize_int8(y, self.quant)   # avg_pool leaves the grid
        if self.pool:
            y = avg_pool(y, 2)
        feat = _flatten_nhwc(y)
        return self.linear(feat, seeds), feat


class VGG(nn.Module):
    """Multi-exit Bayesian VGG over a block config.

    The JAX model's masked-conv sites (``dropout="block"``), hidden-layer
    sites (``head_sites``) and per-layer ``quant_overrides`` are not ported
    yet and raise.
    ``input_shape`` (H, W, C) fixes the dense widths, which Flax infers from
    the first input.
    """

    def __init__(self, cfg_name: str = "vgg19",
                 bayes: BayesConfig = BayesConfig(), num_classes: int = 100,
                 n_exits: int = 1, dropout_exit: bool = False,
                 dropout: str | None = None, head_dims: Sequence[int] = (),
                 head_sites: bool = False, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 input_shape: tuple[int, int, int] = (32, 32, 3),
                 quant_overrides: dict | None = None):
        super().__init__()
        if dropout is not None or head_sites:
            raise NotImplementedError(
                "masked-conv and hidden-layer Bayesian sites are not ported "
                "yet: ROADMAP Queue 1 item 11")
        if quant_overrides:
            raise NotImplementedError(
                "per-layer quant_overrides (and mixed_head) are not ported "
                "yet: ROADMAP Queue 1 item 8")
        self.bayes = bayes
        self.quant = quant
        self.input_shape = tuple(input_shape)
        head_bayes = bayes if dropout_exit else dataclasses.replace(
            bayes, kind=DropoutKind.NONE)
        blocks = _blocks_of(CFGS[cfg_name])
        h, _, c = input_shape
        heads: list[BayesDense] = []
        self._exits: list[tuple[str, str | None]] = []  # (block, exit head)
        for i, chans in enumerate(blocks):
            self.add_module(f"block{i}", _VGGBlock(c, chans, dtype, quant,
                                                   quant_input=i != 0))
            c, h = chans[-1], h // 2
            exit_name = None
            if n_exits > 1 and i < len(blocks) - 1:
                chain, w = [], c
                while w < 512:
                    w *= 2
                    chain.append(min(w, 512))
                exit_name = f"exit{i + 1}"
                head = _VGGExitHead(c, h, chain, num_classes, head_bayes,
                                    dtype, fused, quant)
                self.add_module(exit_name, head)
                heads.append(head.linear)
            self._exits.append((f"block{i}", exit_name))
        width = c * h * h
        self.n_fc = len(head_dims)
        for j, d in enumerate(head_dims):
            self.add_module(f"fc_{j}", Dense(width, d, quant=quant,
                                             dtype=dtype))
            if j == 0:
                self.add_module(f"fc_bn_{j}", BatchNorm(d))
            self.add_module(f"fc_relu_{j}", QuantAct(quant))
            width = d
        self.classifier = BayesDense(width, num_classes, bayes=head_bayes,
                                     fused=fused, quant=quant, dtype=dtype)
        heads.append(self.classifier)
        # MC site index of every head in JAX call order (None: deterministic)
        self.num_sites = 0
        for head in heads:
            head.site = self.num_sites if head.stochastic else None
            self.num_sites += head.stochastic
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initializers, drawn in module order from ``generator``."""
        for m in self.modules():
            if isinstance(m, (_Conv, BatchNorm, Dense, BayesDense)):
                m.reset_parameters(generator)

    @staticmethod
    def _head_seeds(head: BayesDense, seeds: torch.Tensor
                    ) -> torch.Tensor | None:
        return (None if head.site is None
                else seeds[..., head.site, :].contiguous())

    def forward(self, x: torch.Tensor, seeds: torch.Tensor) -> ExitOutputs:
        dims = (2,) if self.training else (2, 3)
        if seeds.dim() not in dims or seeds.shape[-2:] != (self.num_sites,
                                                           2):
            want = ("(n_sites, 2) in train mode" if self.training
                    else "(n_sites, 2) or (S, n_sites, 2)")
            raise ValueError(f"seeds must be {want} with n_sites="
                             f"{self.num_sites}; got {tuple(seeds.shape)}")
        sample_shape = tuple(seeds.shape[:-2])
        exits, feats = [], []

        def head_out(y: torch.Tensor) -> torch.Tensor:
            # a deterministic head broadcasts over the sample axis
            return y.expand(sample_shape + tuple(y.shape[-2:]))

        out = x.permute(0, 3, 1, 2)          # NHWC → NCHW (channels_last)
        for block_name, exit_name in self._exits:
            out = getattr(self, block_name)(out)
            if exit_name is not None:
                head = getattr(self, exit_name)
                logit, feat = head(out, self._head_seeds(head.linear, seeds))
                exits.append(head_out(logit))
                feats.append(feat)
        out = _flatten_nhwc(out)
        # the metrics take f32 features; fc_0 keeps the int8 view
        feats.append(dequantize_int8(out, self.quant)
                     if out.dtype == torch.int8 else out)
        for j in range(self.n_fc):
            out = getattr(self, f"fc_{j}")(out)
            if j == 0:
                out = getattr(self, f"fc_bn_{j}")(out)
            out = getattr(self, f"fc_relu_{j}")(out)
        exits.append(head_out(self.classifier(
            out, self._head_seeds(self.classifier, seeds))))
        return stack_exits(exits, feats)


def _mixed_head(kw: dict) -> None:
    """``mixed_head`` of the JAX ``build_vgg*`` functions (a 2×-bits fc_0
    bias and relu, ``vgg.py:295-310``) rides on ``quant_overrides``, which
    are not ported yet."""
    if kw.pop("mixed_head", False):
        raise NotImplementedError(
            "mixed_head (per-layer quant_overrides) is not ported yet: "
            "ROADMAP Queue 1 item 8")


@register_model("vgg11")
def build_vgg11(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg11")
    kw.setdefault("num_classes", 10)
    kw.setdefault("head_dims", (512, 512))
    kw.setdefault("dropout_exit", True)
    _mixed_head(kw)
    return VGG(**kw)


@register_model("vgg11_me")
def build_vgg11_me(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg11")
    kw.setdefault("num_classes", 10)
    kw.setdefault("head_dims", (512, 512))
    kw.setdefault("n_exits", 5)
    kw.setdefault("dropout_exit", True)
    _mixed_head(kw)
    return VGG(**kw)
