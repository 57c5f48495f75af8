"""The ResNet family with Bayesian multi-exit heads (counterpart of
``bayestpu/nn/zoo/resnet.py``): ``resnet18``, ``resnet18_me``, ``resnet50``
and ``resnet20``.

``ResNet18.forward(x, seeds, sample_idx=None)`` takes NHWC images and
returns ``ExitOutputs`` as ``VGG`` does (see ``vgg.py``'s docstring for
the seeds and ``sample_idx`` forms): seeds (n_sites, 2) for one sample or
(S, n_sites, 2) for the spatial mapping, the MC sites numbered in the JAX
model's call order.

- The CIFAR stem is a 3×3 ``ConvBN`` on the raw image (``quant_input=
  False``) with no relu; stages of ``BasicBlock`` (or ``Bottleneck``), the
  first block of every stage but the first at stride 2, the 3×3 convs
  padded ((1, 1), (1, 1)) as torch's ``padding=1`` (``_P3``), a 1×1
  ``downsample`` ``ConvBN`` where the stride or the width changes, then
  ``relu(y + residual)``.
- ``n_exits > 1``: an exit head after each stage but the last (relu, a
  cascade of stride-2 ``ConvBN(act="relu", act_quant=True)`` up to the
  last stage's width, an exact dequantize when the cascade ends in int8,
  ``avg_pool(min(4, H))``, ``BayesDense``); then the final
  ``avg_pool(relu(out))`` and ``linear``. ``dropout_exit`` puts the site
  before each exit's and the final linear.
- ``dropout="block"`` puts a site after stages 1 … n-1,
  ``dropout="layer"`` after every block but the very last
  (``resnet.py:205-248``). With ``fused=True`` and one exit
  (``can_defer``) a site at a stage boundary is deferred into the next
  stage's first block, whose ``convbn1`` (3×3 stride 2) and ``downsample``
  (1×1 stride 2) both mask their input with the same seeds or the same
  bank, so the site never reaches device memory; below
  ``MASKED_CONV_FUSE_MIN_CH`` input channels (resnet20's 16-channel
  boundary) each conv routes unfused and draws its own threefry mask on a
  seed pair of its own, as JAX's two ``BayesianDropout`` do. Every other
  site is materialized (``BayesSite`` ``bayes_s{s}`` or ``bayes_l{s}_{b}``):
  the in-stage ones of ``"layer"``, and all of them with exits or
  ``fused=False``. With S samples the first site runs all S at once, and
  the activations carry S from there (folded into the batch for the
  deterministic layers; each later site takes x as (S, N, …), a masked
  conv in one ``_xs`` launch, never S folded into the batch, which would
  shift the rows of the mask). ``fused=False`` (the JAX default) makes the
  MC heads unfused too (``BayesianDropout`` then the dense).

Not ported, and raising with the ROADMAP Queue 1 item: ``quant_overrides``
(item 8).

Parameter names follow the Flax tree (``stem.conv.kernel``,
``layer2_0.convbn1.conv.kernel``, ``layer2_0.downsample.bn.scale``,
``exit1.convbn1.conv.kernel``, ``exit1.linear.kernel``, ``linear.kernel``;
``masks/layer2_0/convbn1/conv/bank`` ≙ ``layer2_0.convbn1.conv.bank``), so
``interop.from_flax`` loads a JAX tree unchanged. A model is built in eval
mode; in train mode seeds are (n_sites, 2), as ``VGG``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.core.quant import dequantize_int8
from bayestpu_torch.nn.bayes import BayesSite
from bayestpu_torch.nn.fused import BayesDense
from bayestpu_torch.nn.layers import ConvBN, avg_pool
from bayestpu_torch.nn.multiexit import ExitOutputs, stack_exits
from bayestpu_torch.nn.zoo.registry import register_model
from bayestpu_torch.nn.zoo.sites import SiteModel, flatten_nhwc

# torch's Conv2d(k=3, padding=1): symmetric, also at stride 2
# (``bayestpu/nn/zoo/resnet.py:36-40``)
_P3 = ((1, 1), (1, 1))


def _down(size: int) -> int:
    """The output size of a 3×3 stride-2 conv padded by ``_P3`` (and of the
    1×1 stride-2 projection): ceil(size / 2)."""
    return (size + 1) // 2


class _Block(nn.Module):
    """A residual block: its convs (``convbn1`` first) and, where the
    stride or the width changes, the 1×1 ``downsample`` projection, which
    takes ``bayes_in`` too: one site on the block input, the same seeds or
    bank in both convs (``resnet.py:46-92``)."""

    def __init__(self, convs: list[ConvBN], in_ch: int, out_ch: int,
                 stride: int, dtype: torch.dtype, quant: QuantConfig | None,
                 bayes_in: BayesConfig | None, kind: str):
        super().__init__()
        for i, conv in enumerate(convs):
            self.add_module(f"convbn{i + 1}", conv)
        has_projection = stride != 1 or in_ch != out_ch
        if (bayes_in is not None and bayes_in.kind is not DropoutKind.NONE
                and not has_projection):
            raise ValueError(
                f"bayes_in on an identity {kind}: the residual path would "
                "bypass the Bayesian mask; only projection blocks (stride!=1 "
                "or channel change) accept a fused input site")
        self.downsample = (ConvBN(in_ch, out_ch, (1, 1), (stride, stride),
                                  dtype=dtype, quant=quant, bayes=bayes_in)
                           if has_projection else None)
        site = self.convbn1.conv
        self.has_site = site.masked or site.stochastic

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None = None,
                sample_idx=0, carry: int | None = None,
                proj_seeds: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, C, H, W), B = S·N when ``carry`` = S. A site fed S seeds or
        indices returns S samples from both convs, folded the same way;
        ``proj_seeds`` are the downsample's when they are not ``seeds``
        (an unfused site draws one mask a conv)."""
        convs = [m for name, m in self.named_children()
                 if name != "downsample"]
        if self.has_site:
            # the kernels read NHWC; unfold for the site, which masks each
            # sample's own rows
            x = x.contiguous(memory_format=torch.channels_last)
            xin = x.unflatten(0, (carry, -1)) if carry else x
            y = convs[0](xin, act="relu", seeds=seeds,
                         sample_idx=sample_idx)
            residual = self.downsample(
                xin, seeds=seeds if proj_seeds is None else proj_seeds,
                sample_idx=sample_idx)
            if y.dim() == 5:
                y, residual = y.flatten(0, 1), residual.flatten(0, 1)
        else:
            y = convs[0](x, act="relu")
            residual = (self.downsample(x) if self.downsample is not None
                        else x)
        for i, conv in enumerate(convs[1:], 1):
            y = conv(y, act="relu" if i < len(convs) - 1 else None)
        return torch.relu(y + residual)


def basic_block(in_ch: int, planes: int, stride: int, dtype: torch.dtype,
                quant: QuantConfig | None,
                bayes_in: BayesConfig | None = None) -> _Block:
    """3×3 (stride, site, relu) → 3×3 (``resnet.py:46-92``)."""
    convs = [ConvBN(in_ch, planes, (3, 3), (stride, stride), padding=_P3,
                    dtype=dtype, quant=quant, bayes=bayes_in),
             ConvBN(planes, planes, (3, 3), padding=_P3, dtype=dtype,
                    quant=quant)]
    return _Block(convs, in_ch, planes, stride, dtype, quant, bayes_in,
                  "BasicBlock")


def bottleneck(in_ch: int, planes: int, stride: int, dtype: torch.dtype,
               quant: QuantConfig | None,
               bayes_in: BayesConfig | None = None) -> _Block:
    """1×1 (site, relu) → 3×3 (stride, relu) → 1×1 at 4× planes
    (``resnet.py:95-134``)."""
    out_ch = planes * 4
    convs = [ConvBN(in_ch, planes, (1, 1), dtype=dtype, quant=quant,
                    bayes=bayes_in),
             ConvBN(planes, planes, (3, 3), (stride, stride), padding=_P3,
                    dtype=dtype, quant=quant),
             ConvBN(planes, out_ch, (1, 1), dtype=dtype, quant=quant)]
    return _Block(convs, in_ch, out_ch, stride, dtype, quant, bayes_in,
                  "Bottleneck")


class _ExitHead(nn.Module):
    """relu, the stride-2 cascade to ``channels[-1]``, avg_pool(min(4, H)),
    then the ``BayesDense`` head ``linear`` (``resnet.py:137-173``)."""

    def __init__(self, in_ch: int, spatial: int, channels: Sequence[int],
                 num_classes: int, bayes: BayesConfig | None,
                 dtype: torch.dtype, fused: bool,
                 quant: QuantConfig | None = None):
        super().__init__()
        self.quant = quant
        for i, ch in enumerate(channels):
            self.add_module(f"convbn{i + 1}", ConvBN(
                in_ch, ch, (3, 3), (2, 2), padding=_P3, dtype=dtype,
                quant=quant))
            in_ch, spatial = ch, _down(spatial)
        self.pool = min(4, spatial)
        width = in_ch * (spatial // self.pool) ** 2
        self.linear = BayesDense(
            width, num_classes,
            bayes=bayes or BayesConfig(kind=DropoutKind.NONE), fused=fused,
            quant=quant, dtype=dtype)

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
        feat = flatten_nhwc(avg_pool(y, self.pool))
        if carry:
            feat = feat.unflatten(0, (carry, -1))
        return self.linear(feat, seeds, sample_idx), feat


class ResNet18(SiteModel):
    """ResNet-18 with {1, 4} exits and configurable Bayesian sites
    (``resnet.py:176-272``); ``input_shape`` (H, W, C) fixes the dense
    widths, which Flax infers from the first input."""

    def __init__(self, bayes: BayesConfig = BayesConfig(),
                 num_classes: int = 100, n_exits: int = 4,
                 dropout_exit: bool = True, dropout: str | None = None,
                 stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 stage_planes: Sequence[int] = (64, 128, 256, 512),
                 block: str = "basic", quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 input_shape: tuple[int, int, int] = (32, 32, 3),
                 quant_overrides: dict | None = None):
        super().__init__()
        if dropout not in (None, "block", "layer"):
            raise ValueError(f"dropout must be None, 'block' or 'layer'; "
                             f"got {dropout!r}")
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck'; got "
                             f"{block!r}")
        can_defer = fused and n_exits == 1
        if quant_overrides:
            raise NotImplementedError(
                "per-layer quant_overrides are not ported yet: ROADMAP "
                "Queue 1 item 8")
        self.bayes, self.quant = bayes, quant
        self.input_shape = tuple(input_shape)
        make = basic_block if block == "basic" else bottleneck
        expansion = 1 if block == "basic" else 4
        h, _, c = input_shape
        self.stem = ConvBN(c, stage_planes[0], (3, 3), padding=_P3,
                           dtype=dtype, quant=quant, quant_input=False)
        c = stage_planes[0]
        # the Bayesian sites in JAX call order: each deferred block site
        # (both of its convs: one site fused, one each unfused), each
        # materialized site, each exit head, then the final linear
        sites: list = []

        def site_after(name: str) -> str:
            self.add_module(name, BayesSite(bayes, c))
            sites.append(getattr(self, name))
            return name

        # per stage: (block, materialized site after it), the stage's site,
        # the exit head
        self._stages: list[tuple[list, str | None, str | None]] = []
        n_stages = len(stage_blocks)
        for s in range(n_stages):
            names = []
            for b in range(stage_blocks[s]):
                stride = 2 if (s > 0 and b == 0) else 1
                deferred = (can_defer and dropout is not None and s > 0
                            and b == 0)
                blk = make(c, stage_planes[s], stride, dtype, quant,
                           bayes if deferred else None)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, blk)
                if blk.has_site:
                    pair = [blk.convbn1.conv, blk.downsample.conv]
                    sites.extend([pair] if pair[0].drop is None else pair)
                c = stage_planes[s] * expansion
                h = _down(h) if stride == 2 else h
                last_in_stage = b == stage_blocks[s] - 1
                after = None
                if (dropout == "layer" and not (s == n_stages - 1
                                                and last_in_stage)
                        and not (can_defer and last_in_stage)):
                    after = site_after(f"bayes_l{s + 1}_{b}")
                names.append((name, after))
            stage_site = None
            if dropout == "block" and not can_defer and s < n_stages - 1:
                stage_site = site_after(f"bayes_s{s + 1}")
            exit_name = None
            if n_exits > 1 and s < n_stages - 1:
                exit_name = f"exit{s + 1}"
                head = _ExitHead(c, h, tuple(stage_planes[s + 1:]),
                                 num_classes,
                                 bayes if dropout_exit else None, dtype,
                                 fused, quant)
                self.add_module(exit_name, head)
                sites.append(head.linear)
            self._stages.append((names, stage_site, exit_name))
        self.pool = min(4, h)
        final_bayes = bayes if dropout_exit else dataclasses.replace(
            bayes, kind=DropoutKind.NONE)
        self.linear = BayesDense(c * (h // self.pool) ** 2, num_classes,
                                 bayes=final_bayes, fused=fused, quant=quant,
                                 dtype=dtype)
        sites.append(self.linear)
        self.number_sites(sites, [s for s in sites
                                  if isinstance(s, BayesDense)])
        self.eval()

    def forward(self, x: torch.Tensor, seeds: torch.Tensor,
                sample_idx=None) -> ExitOutputs:
        idx, sample_shape = self.prepare(x, seeds, sample_idx)
        exits, feats = [], []
        carry = None    # S once the activations carry the sample axis

        def head_out(y: torch.Tensor) -> torch.Tensor:
            # a deterministic head broadcasts over the sample axis
            return y.expand(sample_shape + tuple(y.shape[-2:]))

        out = self.stem(x.permute(0, 3, 1, 2))   # NHWC → NCHW
        for names, stage_site, exit_name in self._stages:
            for name, after in names:
                blk = getattr(self, name)
                s1 = s2 = None
                if blk.has_site:
                    s1 = self.site_seeds(blk.convbn1.conv, seeds)
                    s2 = self.site_seeds(blk.downsample.conv, seeds)
                out = blk(out, s1, idx, carry, s2)
                if blk.has_site and sample_shape:
                    carry = sample_shape[0]   # the site returned S samples
                if after is not None:
                    out, carry = self.run_site(getattr(self, after), out,
                                               carry, seeds, idx)
            if stage_site is not None:
                out, carry = self.run_site(getattr(self, stage_site), out,
                                           carry, seeds, idx)
            if exit_name is not None:
                head = getattr(self, exit_name)
                logit, feat = head(out, self.site_seeds(head.linear, seeds),
                                   idx, carry)
                exits.append(head_out(logit))
                feats.append(feat)
        feat = flatten_nhwc(avg_pool(torch.relu(out), self.pool))
        if carry:
            feat = feat.unflatten(0, (carry, -1))
        feats.append(feat)
        exits.append(head_out(self.linear(
            feat, self.site_seeds(self.linear, seeds), idx)))
        return stack_exits(exits, feats)


@register_model("resnet18")
def build_resnet18(**kw) -> ResNet18:
    kw.setdefault("n_exits", 1)
    kw.setdefault("dropout_exit", False)
    return ResNet18(**kw)


@register_model("resnet18_me")
def build_resnet18_me(**kw) -> ResNet18:
    kw.setdefault("n_exits", 4)
    return ResNet18(**kw)


@register_model("resnet50")
def build_resnet50(**kw) -> ResNet18:
    """ResNet-50: Bottleneck blocks [3, 4, 6, 3]."""
    kw.setdefault("block", "bottleneck")
    kw.setdefault("stage_blocks", (3, 4, 6, 3))
    kw.setdefault("n_exits", 1)
    kw.setdefault("dropout_exit", True)
    return ResNet18(**kw)


@register_model("resnet20")
def build_resnet20(**kw) -> ResNet18:
    """CIFAR ResNet-20: 3 stages × 3 blocks at 16/32/64."""
    kw.setdefault("stage_blocks", (3, 3, 3))
    kw.setdefault("stage_planes", (16, 32, 64))
    kw.setdefault("n_exits", 1)
    kw.setdefault("dropout_exit", True)
    kw.setdefault("num_classes", 10)
    return ResNet18(**kw)
