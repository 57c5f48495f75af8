"""VGG-11/16/19 with Bayesian multi-exit heads (counterpart of
``bayestpu/nn/zoo/vgg.py``: ``vgg11``, ``vgg11_me``, ``vgg16``, ``vgg19``
and ``vgg19_me``, with JAX's defaults).

``VGG.forward(x, seeds, sample_idx=None)`` takes NHWC images, the MC seeds
of every MC-dropout site, numbered in the JAX model's call order (with
``dropout="block"`` the block sites block1 … block4; then exit1 … exit4;
then the classifier), and for a Masksembles model the mask index of each
sample:

- seeds (n_sites, 2): one sample; logits (E, B, C). ``sample_idx`` is an
  int, 0 by default.
- seeds (S, n_sites, 2): the spatial mapping, logits (S, E, B, C).
  ``sample_idx`` is a 1-D integer tensor of S indices on the model's
  device, ``arange(S)`` by default. The deterministic layers run once up
  to the first Bayesian site, which runs all S samples in one samples
  launch. Without conv sites (``vgg11_me``) that is each head, so the
  backbone and exit cascades run once. With conv sites (``dropout="block"``)
  the activations carry S from the first site on: the deterministic layers
  take S folded into the batch, and each later site and the classifier
  take x as (S, N, …) and launch once per sample (JAX's ``lax.map``
  fallback), never with S folded into the batch, which would shift the
  rows of the mask.

S comes from the seeds' leading axis in both cases, so a Masksembles model
(``BayesConfig(kind=MASK)``: its sites are Masksembles sites and
``num_sites`` is 0) takes seeds of shape (0, 2) or (S, 0, 2), and an MC
model ignores ``sample_idx``, as the JAX layers do.

``dropout="block"`` (``vgg.py:215-238``) puts a Bayesian site after each
block but the last. With ``fused=True`` and one exit the site fuses into
the next block's first conv (``ConvBN(bayes=…)`` → ``BayesConv``, the
masked-conv kernels), as in JAX; with ``fused=False`` or exits it stays
materialized (``BayesSite`` ``bayes_b{i}`` after block i, which the exit
head reads too; the int8 model dequantizes before it, as its 1/keep
leaves the grid). ``head_sites`` puts a ``BayesSite`` ``bayes_fc_{j}``
after each hidden dense (``vgg.py:278-280``). After a materialized site
the activations carry S as after a fused conv site, and every later site
and head takes x as (S, N, …).

A model is built in eval mode, as the JAX model's ``train=False`` default.
In train mode (``model.train()``, the JAX ``train=True``) seeds are
(n_sites, 2): BatchNorm uses batch statistics and updates its running
averages, activations stay f32 between layers, every MC site goes through
the trainable ``dropout_conv`` or ``dropout_matmul`` and every Masksembles
site splits the batch into ``num_masks`` groups, one mask each.

With ``quant`` (a ``QuantConfig``) the model is the JAX package's quantized
VGG (``vgg.py:69-292``): QAT in train mode and the fake-quant model in eval
mode, or with ``quant.int8_infer`` the int8 model, whose activations stay
int8 on the ap_fixed grid from block to block (each block's last conv
defers the cast past its max pool unless a fused site emits int8 itself,
then the block re-quantizes), whose exit heads dequantize before their
average pool, and whose Bayesian heads and sites run the int8 kernels.
``QuantConfig`` adds no parameters.

``quant_overrides`` (``vgg.py:186-203``) gives a layer a ``QuantConfig`` (or
None: float) of its own in place of ``quant``, keyed by the names JAX
consults and no others: ``block{i}`` (a whole conv block), ``fc_{j}``,
``fc_{j}/bias`` (the bias grid alone), ``fc_relu_{j}`` and ``classifier``;
other keys are ignored, as in JAX. The exit heads keep ``quant``. Int8
residency follows each block's own config: a float block never re-enters
int8, and the first int8 block quantizes its float input. ``mixed_head=
True`` on every builder is the reference's fc_0 head: its bias and relu at
twice the bits (``_mixed_head_overrides``).

Parameter names follow the Flax tree (``block0.convbn0.conv.kernel`` ≙
``params/block0/convbn0/conv/kernel``, ``exit1.linear.bank`` ≙
``masks/exit1/linear/bank``, ``block1.convbn0.conv.bank`` ≙
``masks/block1/convbn0/conv/bank``), so ``interop.from_flax`` loads JAX
variables by name.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.core.quant import dequantize_int8, quantize_int8
from bayestpu_torch.nn.bayes import BayesSite
from bayestpu_torch.nn.fused import BayesDense
from bayestpu_torch.nn.layers import (BatchNorm, ConvBN, Dense, QuantAct,
                                      avg_pool, max_pool)
from bayestpu_torch.nn.multiexit import ExitOutputs, stack_exits
from bayestpu_torch.nn.zoo.registry import register_model
from bayestpu_torch.nn.zoo.sites import SiteModel, flatten_nhwc
from bayestpu_torch.utils.profiler import count

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


class _VGGBlock(nn.Module):
    """ConvBN+relu(+QuantAct) per channel width, then a 2×2 max pool; the
    int8 model re-quantizes after the pool. ``quant_input`` is False on
    block 0, whose first conv takes the raw image. ``bayes_in``: a Bayesian
    site on the block input, fused into the first conv (``conv_site``)."""

    def __init__(self, in_ch: int, channels: Sequence[int],
                 dtype: torch.dtype, quant: QuantConfig | None = None,
                 quant_input: bool = True,
                 bayes_in: BayesConfig | None = None):
        super().__init__()
        self.quant = quant
        for i, ch in enumerate(channels):
            self.add_module(f"convbn{i}", ConvBN(
                in_ch, ch, (3, 3), dtype=dtype, quant=quant,
                quant_input=quant_input if i == 0 else True,
                bayes=bayes_in if i == 0 else None))
            in_ch = ch
        # a site that masks: it returns S samples for S seeds or indices
        self.has_site = self.conv_site.masked or self.conv_site.stochastic

    @property
    def conv_site(self) -> nn.Module:
        """The first conv, which carries the block's input site."""
        return self.convbn0.conv

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None = None,
                sample_idx=0, carry: int | None = None) -> torch.Tensor:
        """x (B, C, H, W), where B is S·N when ``carry`` = S (the
        activations carry the sample axis, folded into the batch). A site
        fed S seeds or indices returns S samples, folded the same way."""
        convs = list(self.children())
        for i, conv in enumerate(convs):
            kw = dict(act="relu", act_quant=True,
                      defer_int8=i == len(convs) - 1)
            if i == 0 and self.has_site:
                # the kernels read NHWC; unfold for the site, which masks
                # each sample's own rows
                x = x.contiguous(memory_format=torch.channels_last)
                xin = x.unflatten(0, (carry, -1)) if carry else x
                x = conv(xin, seeds=seeds, sample_idx=sample_idx, **kw)
                if x.dim() == 5:
                    x = x.flatten(0, 1)
            else:
                x = conv(x, **kw)
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

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None,
                sample_idx=None, carry: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, H, W), B = S·N when ``carry`` = S: the features and
        logits then come out as (S, N, …)."""
        y = torch.relu(x)
        for name, conv in self.named_children():
            if name != "linear":
                y = conv(y, act="relu", act_quant=True)
        if y.dtype == torch.int8:
            y = dequantize_int8(y, self.quant)   # avg_pool leaves the grid
        if self.pool:
            y = avg_pool(y, 2)
        feat = flatten_nhwc(y)
        if carry:
            feat = feat.unflatten(0, (carry, -1))
        return self.linear(feat, seeds, sample_idx), feat


class VGG(SiteModel):
    """Multi-exit Bayesian VGG over a block config.

    ``quant_overrides``: per-layer precision (see the module docstring).
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
        if dropout not in (None, "block"):
            raise ValueError(f"dropout must be None or 'block'; got "
                             f"{dropout!r}")
        self.bayes = bayes
        self.quant = quant
        self.quant_overrides = quant_overrides
        self.input_shape = tuple(input_shape)
        head_bayes = bayes if dropout_exit else dataclasses.replace(
            bayes, kind=DropoutKind.NONE)
        # a block site fuses into the next block's first conv only when
        # that conv is its sole consumer
        fuse_block = dropout == "block" and fused and n_exits == 1
        blocks = _blocks_of(CFGS[cfg_name])
        h, _, c = input_shape
        # the Bayesian sites in JAX call order: each block's input site,
        # then its exit head, …, then the classifier
        sites: list[nn.Module] = []
        # (block, materialized site after it, exit head)
        self._exits: list[tuple[str, str | None, str | None]] = []
        for i, chans in enumerate(blocks):
            block = _VGGBlock(c, chans, dtype, self._q(f"block{i}"),
                              quant_input=i != 0,
                              bayes_in=bayes if fuse_block and i > 0
                              else None)
            self.add_module(f"block{i}", block)
            sites.append(block.conv_site)
            c, h = chans[-1], h // 2
            site_name = None
            if dropout and not fuse_block and i < len(blocks) - 1:
                site_name = f"bayes_b{i}"
                self.add_module(site_name, BayesSite(bayes, c))
                sites.append(getattr(self, site_name))
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
                sites.append(head.linear)
            self._exits.append((f"block{i}", site_name, exit_name))
        width = c * h * h
        self.n_fc = len(head_dims)
        self.head_sites = head_sites
        for j, d in enumerate(head_dims):
            # the bias grid only where named: Dense reads ``bias_quant or
            # quant``, so the model-wide fallback here would override a
            # whole-layer ``fc_{j}`` entry for the bias (``vgg.py:262-266``)
            self.add_module(f"fc_{j}", Dense(
                width, d, quant=self._q(f"fc_{j}"), dtype=dtype,
                bias_quant=(quant_overrides or {}).get(f"fc_{j}/bias")))
            if j == 0:
                self.add_module(f"fc_bn_{j}", BatchNorm(d))
            self.add_module(f"fc_relu_{j}", QuantAct(self._q(f"fc_relu_{j}")))
            if head_sites:
                self.add_module(f"bayes_fc_{j}", BayesSite(bayes, d))
                sites.append(getattr(self, f"bayes_fc_{j}"))
            width = d
        self.classifier = BayesDense(width, num_classes, bayes=head_bayes,
                                     fused=fused, quant=self._q("classifier"),
                                     dtype=dtype)
        sites.append(self.classifier)
        self.number_sites(sites, [s for s in sites
                                  if isinstance(s, BayesDense)])
        self.eval()

    def _q(self, name: str) -> QuantConfig | None:
        """The config of layer ``name``: its override, else ``quant``."""
        return (self.quant_overrides or {}).get(name, self.quant)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor,
                sample_idx=None) -> ExitOutputs:
        idx, sample_shape = self.prepare(x, seeds, sample_idx)
        exits, feats = [], []

        def head_out(y: torch.Tensor) -> torch.Tensor:
            # a deterministic head broadcasts over the sample axis
            return y.expand(sample_shape + tuple(y.shape[-2:]))

        def unfold(y: torch.Tensor) -> torch.Tensor:
            return y.unflatten(0, (carry, -1)) if carry else y

        out = x.permute(0, 3, 1, 2)          # NHWC → NCHW (channels_last)
        carry = None    # S once the activations carry the sample axis
        for block_name, site_name, exit_name in self._exits:
            block = getattr(self, block_name)
            out = block(out, self.site_seeds(block.conv_site, seeds),
                        idx, carry)
            if block.has_site and sample_shape:
                if carry is None:
                    count("sites.rows", out.shape[0])
                carry = sample_shape[0]   # the site returned S samples
            if site_name is not None:
                if out.dtype == torch.int8:
                    # 1/keep leaves the grid: an exact dequantize first
                    out = dequantize_int8(out, self.quant)
                out, carry = self.run_site(getattr(self, site_name), out,
                                           carry, seeds, idx)
            if exit_name is not None:
                head = getattr(self, exit_name)
                logit, feat = head(out, self.site_seeds(head.linear, seeds),
                                   idx, carry)
                exits.append(head_out(logit))
                feats.append(feat)
        out = flatten_nhwc(out)
        # the metrics take f32 features; fc_0 keeps the int8 view
        feats.append(unfold(dequantize_int8(out, self.quant)
                            if out.dtype == torch.int8 else out))
        for j in range(self.n_fc):
            out = getattr(self, f"fc_{j}")(out)
            if j == 0:
                out = getattr(self, f"fc_bn_{j}")(out)
            out = getattr(self, f"fc_relu_{j}")(out)
            if self.head_sites:
                out, carry = self.run_site(getattr(self, f"bayes_fc_{j}"),
                                           out, carry, seeds, idx)
        exits.append(head_out(self.classifier(
            unfold(out), self.site_seeds(self.classifier, seeds),
            idx)))
        return stack_exits(exits, feats)


def _mixed_head_overrides(kw: dict) -> None:
    """``mixed_head=True``: the reference's fc_0 head (``vgg.py:295-310``,
    ``s_qmodels_bayes.py:294-298``): the bias at twice the bits and the
    following relu at twice the bits, the kernel at the base bits. Entries
    the caller set win; nothing happens on a float model."""
    if not kw.pop("mixed_head", False):
        return
    q = kw.get("quant")
    if q is None:
        return
    q2 = dataclasses.replace(q, total_bits=2 * q.total_bits,
                             int8_infer=False)
    ov = dict(kw.get("quant_overrides") or {})
    ov.setdefault("fc_0/bias", q2)
    ov.setdefault("fc_relu_0", q2)
    kw["quant_overrides"] = ov


@register_model("vgg11")
def build_vgg11(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg11")
    kw.setdefault("num_classes", 10)
    kw.setdefault("head_dims", (512, 512))
    kw.setdefault("dropout_exit", True)
    _mixed_head_overrides(kw)
    return VGG(**kw)


@register_model("vgg11_me")
def build_vgg11_me(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg11")
    kw.setdefault("num_classes", 10)
    kw.setdefault("head_dims", (512, 512))
    kw.setdefault("n_exits", 5)
    kw.setdefault("dropout_exit", True)
    _mixed_head_overrides(kw)
    return VGG(**kw)


@register_model("vgg16")
def build_vgg16(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg16")
    _mixed_head_overrides(kw)
    return VGG(**kw)


@register_model("vgg19")
def build_vgg19(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg19")
    _mixed_head_overrides(kw)
    return VGG(**kw)


@register_model("vgg19_me")
def build_vgg19_me(**kw) -> VGG:
    kw.setdefault("cfg_name", "vgg19")
    kw.setdefault("n_exits", 5)
    kw.setdefault("dropout_exit", True)
    _mixed_head_overrides(kw)
    return VGG(**kw)
