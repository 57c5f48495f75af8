"""Plain reference of the multi-exit MC-dropout ResNet-18 (CIFAR stem) at
an ap_fixed<W, I> point, at inference.

- Stem: a 3×3 conv of the raw image (never quantized) with the kernel on
  the grid, then BatchNorm; no relu.
- Stages of two basic blocks at widths (64, 128, 256, 512), the first
  block of stages 2–4 at stride 2: 3×3 conv-BN-relu, 3×3 conv-BN, a 1×1
  conv-BN projection where the stride or the width changes, then
  relu(y + residual). Every conv but the stem rounds its input and its
  kernel to the grid and sums their codes exactly; BatchNorm follows on
  running statistics, in f32.
- After stages 1–3 an exit head: relu, 3×3 stride-2 conv-BN-relu layers
  up to 512 channels, each output rounded to the unsigned grid, a
  min(4, H) average pool, then MC dropout and a dense classifier on the
  grid (input, kernel and bias rounded to it, the masked codes summed
  exactly). After stage 4: relu, the same pool and head.

3×3 convs are zero-padded by 1 on each side at either stride. Sites are
exit 1 … exit 3, then the final classifier ``linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (Grid, Numerics, bn_eval, conv_codes,
                                        flatten_nhwc, mc_dense_grid)

PLANES = (64, 128, 256, 512)


def num_sites(cfg: dict) -> int:
    return cfg["n_exits"]


def _down(h: int) -> int:
    return (h + 1) // 2


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    specs = []

    def conv_bn(prefix, cin, cout, k):
        specs.append((prefix + ".conv.kernel", (cout, cin, k, k), "kernel",
                      cin * k * k))
        specs.extend((f"{prefix}.bn.{n}", (cout,), "bn_" + n, 0)
                     for n in ("scale", "bias", "mean", "var"))

    h, _, c = cfg["input_shape"]
    conv_bn("stem", c, PLANES[0], 3)
    c = PLANES[0]
    for s, planes in enumerate(PLANES):
        for b in range(2):
            stride = 2 if (s > 0 and b == 0) else 1
            name = f"layer{s + 1}_{b}"
            conv_bn(name + ".convbn1", c, planes, 3)
            conv_bn(name + ".convbn2", planes, planes, 3)
            if stride != 1 or c != planes:
                conv_bn(name + ".downsample", c, planes, 1)
            c = planes
            h = _down(h) if stride == 2 else h
        if s < len(PLANES) - 1:
            w, e = c, h
            for k, ch in enumerate(PLANES[s + 1:]):
                conv_bn(f"exit{s + 1}.convbn{k + 1}", w, ch, 3)
                w, e = ch, _down(e)
            width = w * (e // min(4, e)) ** 2
            specs.append((f"exit{s + 1}.linear.kernel",
                          (width, cfg["num_classes"]), "head", width))
            specs.append((f"exit{s + 1}.linear.bias", (cfg["num_classes"],),
                          "bias", 0))
    width = c * (h // min(4, h)) ** 2
    specs.append(("linear.kernel", (width, cfg["num_classes"]), "head",
                  width))
    specs.append(("linear.bias", (cfg["num_classes"],), "bias", 0))
    return specs


def layer_shapes(cfg: dict) -> list[dict]:
    """Every conv and MC head of one image's forward (see ``vgg_me``)."""
    out = []
    h, _, c = cfg["input_shape"]

    def conv(name, cin, cout, k, pixels):
        out.append({"name": name, "op": "conv", "cin": cin, "cout": cout,
                    "k": k, "pixels": pixels})

    conv("stem", c, PLANES[0], 3, h * h)
    c = PLANES[0]
    for s, planes in enumerate(PLANES):
        for b in range(2):
            stride = 2 if (s > 0 and b == 0) else 1
            name = f"layer{s + 1}_{b}"
            ho = _down(h) if stride == 2 else h
            conv(name + ".convbn1", c, planes, 3, ho * ho)
            conv(name + ".convbn2", planes, planes, 3, ho * ho)
            if stride != 1 or c != planes:
                conv(name + ".downsample", c, planes, 1, ho * ho)
            c, h = planes, ho
        if s < len(PLANES) - 1:
            w, e = c, h
            for k, ch in enumerate(PLANES[s + 1:]):
                e = _down(e)
                conv(f"exit{s + 1}.convbn{k + 1}", w, ch, 3, e * e)
                w = ch
            out.append({"name": f"exit{s + 1}.linear", "op": "head",
                        "k": w * (e // min(4, e)) ** 2,
                        "n": cfg["num_classes"]})
    out.append({"name": "linear", "op": "head",
                "k": c * (h // min(4, h)) ** 2, "n": cfg["num_classes"]})
    return out


def forward(p: dict, x, pairs, cfg: dict, num: Numerics):
    """(S, E, B, C) logits of NHWC images x under ``pairs`` (S, sites, 2)."""
    grid: Grid = num.grid
    if grid is None:
        raise ValueError("the ResNet reference is a quantized one")
    rate = cfg["mc_rate"]

    def conv_bn(y, prefix, stride, relu):
        w = p[prefix + ".conv.kernel"]
        pad = w.shape[-1] // 2
        out = conv_codes(grid.codes(y), grid.codes(w), stride, pad) * (
            grid.step * grid.step)
        out = bn_eval(out, p, prefix + ".bn")
        return out.relu() if relu else out

    def head(feat, prefix, site):
        return mc_dense_grid(feat, p[prefix + ".kernel"], p[prefix + ".bias"],
                             pairs[:, site], rate, grid)

    def pool_head(y, prefix, site):
        y = F.avg_pool2d(y, min(4, y.shape[-1]))
        return head(flatten_nhwc(y), prefix, site)

    img = x.permute(0, 3, 1, 2)
    y = F.conv2d(img, grid.values(p["stem.conv.kernel"]), padding=1)
    y = bn_eval(y, p, "stem.bn")
    exits = []
    c = PLANES[0]
    for s, planes in enumerate(PLANES):
        for b in range(2):
            stride = 2 if (s > 0 and b == 0) else 1
            name = f"layer{s + 1}_{b}"
            z = conv_bn(y, name + ".convbn1", stride, True)
            z = conv_bn(z, name + ".convbn2", 1, False)
            res = (conv_bn(y, name + ".downsample", stride, False)
                   if stride != 1 or c != planes else y)
            y = (z + res).relu()
            c = planes
        if s < len(PLANES) - 1:
            e = y.relu()
            for k in range(len(PLANES) - 1 - s):
                e = grid.unsigned().values(
                    conv_bn(e, f"exit{s + 1}.convbn{k + 1}", 2, True))
            exits.append(pool_head(e, f"exit{s + 1}.linear", len(exits)))
    exits.append(pool_head(y.relu(), "linear", len(exits)))
    return torch.stack(exits, dim=-3)
