"""Plain reference of ResNet-18 at ImageNet shapes with MC-dropout block
sites (He et al., arXiv:1512.03385, Table 1, 18-layer column), at
inference, in f32.

- Stem: a 7×7 stride-2 conv of the image, zero-padded by 3, BatchNorm,
  relu, then a 3×3 stride-2 max pool padded by 1 (the padding never wins).
- Stages of basic blocks (``stage_blocks`` at ``stage_planes``): 3×3
  conv-BN-relu (stride 2 in the first block of every stage but the first),
  3×3 conv-BN, each zero-padded by 1; a 1×1 conv-BN projection at the
  block's stride where the stride or the width changes; then relu(y +
  residual). BatchNorm on running statistics, eps 1e-5.
- Block sites: MC dropout on the input of the first block of stages 2 … n,
  read by both of that block's convs that take it (the 3×3 stride-2 conv
  and the projection) under one mask. Element (n, c, h, w) of a sample's
  input is kept iff ``common.hash_bits`` of (n·H·W + h·W + w, c) under
  that sample's seed pair of the site lies under (1 - rate)·2^32: only
  real input positions are masked, and the 3×3 conv's zero padding is
  added to the masked input. Each sample keeps its own rows (the sample is
  never part of the hash row). Before the first site the samples share one
  forward; from it on each sample runs alone.
- Head: relu, the global average over H×W, then ``common.mc_dense`` (MC
  dropout and the classifier) under the sample's pair of the last site.

Sites are numbered in that order: the block sites of stages 2 … n, then
``linear``. Parameters are named as the configuration's parameter list
names them (``param_specs``: conv kernels OIHW, the classifier (in, out)).

Departures from the published model, each a property of the configuration
as it is run: a kept element of a block site is scaled by 1/(1 - rate)
rounded to the configuration's ``dtype`` (bf16: 1.3359375 at rate 0.25,
not 4/3), as the configuration's model forms it in that type; the head's
scale is ``mc_dense``'s 1/(1 - rate) in f32 whatever the type; dropout at
the block sites and before the classifier at inference (MC dropout) is the
Bayesian placement, not the paper's; the projection is a 1×1 conv-BN (the
paper's option B); weights and BatchNorm statistics are random
(``perfbench.weights``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import Numerics, bn_eval, conv, mc_dense
# ``num_sites`` is part of a reference's contract, the same for both
from perfbench.reference.resnet_blocks import (  # noqa: F401
    _down, num_sites, site_mask, site_scale)


def _blocks(cfg: dict):
    """(name, cin, cout, stride, site, projection) of every block in
    order; ``site`` is the index of the block site on its input or
    None."""
    c = cfg["stage_planes"][0]
    out = []
    for s, (planes, n) in enumerate(zip(cfg["stage_planes"],
                                        cfg["stage_blocks"])):
        for b in range(n):
            first = s > 0 and b == 0
            stride = 2 if first else 1
            out.append((f"layer{s + 1}_{b}", c, planes, stride,
                        s - 1 if first else None,
                        stride != 1 or c != planes))
            c = planes
    return out


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    specs = []

    def conv_bn(prefix, cin, cout, k):
        specs.append((prefix + ".conv.kernel", (cout, cin, k, k), "kernel",
                      cin * k * k))
        specs.extend((f"{prefix}.bn.{n}", (cout,), "bn_" + n, 0)
                     for n in ("scale", "bias", "mean", "var"))

    conv_bn("stem", cfg["input_shape"][2], cfg["stage_planes"][0], 7)
    c = cfg["stage_planes"][0]
    for name, cin, cout, _, _, proj in _blocks(cfg):
        conv_bn(name + ".convbn1", cin, cout, 3)
        conv_bn(name + ".convbn2", cout, cout, 3)
        if proj:
            conv_bn(name + ".downsample", cin, cout, 1)
        c = cout
    specs.append(("linear.kernel", (c, cfg["num_classes"]), "head", c))
    specs.append(("linear.bias", (cfg["num_classes"],), "bias", 0))
    return specs


def layer_shapes(cfg: dict) -> list[dict]:
    """Every conv and the MC head of one image's forward: ``pixels`` the
    output pixels, ``hin`` the input's side; ``carried`` marks the layers
    that run once a sample (from the first site on: S times a request),
    ``site`` the masked convs of a block site (the 3×3 stride-2 ``convbn1``
    and the ``downsample``) and ``x_carries`` those whose input already
    holds the S samples."""
    out = []
    h = cfg["input_shape"][0]

    def conv(name, cin, cout, k, hin, hout, carried, site=False,
             x_carries=False):
        out.append({"name": name, "op": "conv", "cin": cin, "cout": cout,
                    "k": k, "pixels": hout * hout, "hin": hin,
                    "carried": carried, "site": site,
                    "x_carries": x_carries})

    conv("stem", cfg["input_shape"][2], cfg["stage_planes"][0], 7, h,
         _down(h), False)
    h = _down(_down(h))
    carried = False
    for name, cin, cout, stride, site, proj in _blocks(cfg):
        first = site is not None
        x_carries = carried
        carried |= first
        ho = _down(h) if stride == 2 else h
        conv(name + ".convbn1", cin, cout, 3, h, ho, carried, first,
             first and x_carries)
        conv(name + ".convbn2", cout, cout, 3, ho, ho, carried)
        if proj:
            conv(name + ".downsample", cin, cout, 1, h, ho, carried, first,
                 first and x_carries)
        h = ho
    out.append({"name": "linear", "op": "head", "k": cout,
                "n": cfg["num_classes"], "carried": True})
    return out


def forward(p: dict, x, pairs, cfg: dict, num: Numerics):
    """(S, 1, B, C) logits of NHWC images x under ``pairs`` (S, sites, 2),
    computed sample by sample from the first site on."""
    if num.grid is not None:
        raise ValueError("the block-site ResNet reference is a float one")
    rate, scale = cfg["mc_rate"], site_scale(cfg)
    blocks = _blocks(cfg)

    def conv_bn(y, prefix, stride, relu):
        w = p[prefix + ".conv.kernel"]
        y = bn_eval(conv(y, w, stride, w.shape[-1] // 2, num), p,
                    prefix + ".bn")
        return y.relu() if relu else y

    def block(y, spec, pair):
        name, _, _, stride, site, proj = spec
        if site is not None:
            y = site_mask(y, pair[site], rate, scale)
        z = conv_bn(y, name + ".convbn1", stride, True)
        z = conv_bn(z, name + ".convbn2", 1, False)
        res = conv_bn(y, name + ".downsample", stride, False) if proj else y
        return (z + res).relu()

    y = conv_bn(x.permute(0, 3, 1, 2), "stem", 2, True)
    y = F.max_pool2d(y, 3, 2, 1)
    first = next(i for i, b in enumerate(blocks) if b[4] is not None)
    for spec in blocks[:first]:
        y = block(y, spec, None)
    logits = []
    for pair in pairs:
        z = y
        for spec in blocks[first:]:
            z = block(z, spec, pair)
        feat = z.relu().mean((2, 3))
        logits.append(mc_dense(feat, p["linear.kernel"], p["linear.bias"],
                               pair[-1], rate, num))
    return torch.stack(logits)[:, None]
