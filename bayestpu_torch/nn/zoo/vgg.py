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
    """ConvBN+relu per channel width, then a 2×2 max pool."""

    def __init__(self, in_ch: int, channels: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        for i, ch in enumerate(channels):
            self.add_module(f"convbn{i}", ConvBN(in_ch, ch, (3, 3),
                                                 dtype=dtype))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(x, act="relu")
        return max_pool(x, 2, 2)


class _VGGExitHead(nn.Module):
    """relu, stride-2 ConvBN cascade, avgpool(2), then the ``BayesDense``
    classifier ``linear``."""

    def __init__(self, in_ch: int, spatial: int, channels: Sequence[int],
                 num_classes: int, bayes: BayesConfig, dtype: torch.dtype,
                 fused: bool):
        super().__init__()
        for i, ch in enumerate(channels):
            self.add_module(f"convbn{i + 1}", ConvBN(
                in_ch, ch, (3, 3), (2, 2), padding=((1, 1), (1, 1)),
                dtype=dtype))
            in_ch, spatial = ch, (spatial + 1) // 2
        self.pool = spatial > 1
        if self.pool:
            spatial //= 2
        self.linear = BayesDense(in_ch * spatial * spatial, num_classes,
                                 bayes=bayes, fused=fused, dtype=dtype)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        y = torch.relu(x)
        for name, conv in self.named_children():
            if name != "linear":
                y = conv(y, act="relu")
        if self.pool:
            y = avg_pool(y, 2)
        feat = _flatten_nhwc(y)
        return self.linear(feat, seeds), feat


class VGG(nn.Module):
    """Multi-exit Bayesian VGG over a block config.

    The JAX model's masked-conv sites (``dropout="block"``), hidden-layer
    sites (``head_sites``) and quantization are not ported yet and raise.
    ``input_shape`` (H, W, C) fixes the dense widths, which Flax infers from
    the first input.
    """

    def __init__(self, cfg_name: str = "vgg19",
                 bayes: BayesConfig = BayesConfig(), num_classes: int = 100,
                 n_exits: int = 1, dropout_exit: bool = False,
                 dropout: str | None = None, head_dims: Sequence[int] = (),
                 head_sites: bool = False, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 input_shape: tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        if dropout is not None or head_sites:
            raise NotImplementedError(
                "masked-conv and hidden-layer Bayesian sites are not ported "
                "yet: ROADMAP Queue 1 item 11")
        if quant is not None:
            raise NotImplementedError(
                "quantized VGG is not ported yet: ROADMAP Queue 1 item 8")
        self.bayes = bayes
        self.input_shape = tuple(input_shape)
        head_bayes = bayes if dropout_exit else dataclasses.replace(
            bayes, kind=DropoutKind.NONE)
        blocks = _blocks_of(CFGS[cfg_name])
        h, _, c = input_shape
        heads: list[BayesDense] = []
        self._exits: list[tuple[str, str | None]] = []  # (block, exit head)
        for i, chans in enumerate(blocks):
            self.add_module(f"block{i}", _VGGBlock(c, chans, dtype))
            c, h = chans[-1], h // 2
            exit_name = None
            if n_exits > 1 and i < len(blocks) - 1:
                chain, w = [], c
                while w < 512:
                    w *= 2
                    chain.append(min(w, 512))
                exit_name = f"exit{i + 1}"
                head = _VGGExitHead(c, h, chain, num_classes, head_bayes,
                                    dtype, fused)
                self.add_module(exit_name, head)
                heads.append(head.linear)
            self._exits.append((f"block{i}", exit_name))
        width = c * h * h
        self.n_fc = len(head_dims)
        for j, d in enumerate(head_dims):
            self.add_module(f"fc_{j}", Dense(width, d, dtype=dtype))
            if j == 0:
                self.add_module(f"fc_bn_{j}", BatchNorm(d))
            self.add_module(f"fc_relu_{j}", QuantAct())
            width = d
        self.classifier = BayesDense(width, num_classes, bayes=head_bayes,
                                     fused=fused, dtype=dtype)
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
        feats.append(out)
        for j in range(self.n_fc):
            out = getattr(self, f"fc_{j}")(out)
            if j == 0:
                out = getattr(self, f"fc_bn_{j}")(out)
            out = getattr(self, f"fc_relu_{j}")(out)
        exits.append(head_out(self.classifier(
            out, self._head_seeds(self.classifier, seeds))))
        return stack_exits(exits, feats)


@register_model("vgg11")
def build_vgg11(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg11")
    kw.setdefault("num_classes", 10)
    kw.setdefault("head_dims", (512, 512))
    kw.setdefault("dropout_exit", True)
    return VGG(**kw)


@register_model("vgg11_me")
def build_vgg11_me(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg11")
    kw.setdefault("num_classes", 10)
    kw.setdefault("head_dims", (512, 512))
    kw.setdefault("n_exits", 5)
    kw.setdefault("dropout_exit", True)
    return VGG(**kw)
