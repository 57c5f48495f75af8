"""Plain reference of the multi-exit MC-dropout VGG (``vgg11_me``,
arXiv:2308.06849): conv blocks of 3×3 conv, BatchNorm and relu at stride 1
with zero padding 1, a 2×2 max pool after each block; after every block
but the last an exit head (relu, 3×3 stride-2 conv-BN-relu layers doubling
the width up to 512, a 2×2 average pool where more than one pixel is left,
then MC dropout and a dense classifier); after the last block the
NHWC-flattened features, dense layers of ``head_dims`` (the first followed
by BatchNorm), each with relu, then MC dropout and the dense classifier.

Sites are numbered exit 1 … exit E-1, then the classifier. Parameters are
named as the configuration's parameter list names them (``param_specs``):
conv kernels OIHW, dense kernels (in, out), BatchNorm ``scale``, ``bias``,
``mean`` and ``var``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (Numerics, bn_eval, bn_train, conv,
                                        flatten_nhwc, mc_dense)


def _blocks(cfg: dict) -> list[list[int]]:
    blocks, cur = [], []
    for v in cfg["cfg"]:
        if v == "M":
            blocks.append(cur)
            cur = []
        else:
            cur.append(v)
    return blocks


def _exit_chain(width: int) -> list[int]:
    chain = []
    while width < 512:
        width *= 2
        chain.append(min(width, 512))
    return chain


def num_sites(cfg: dict) -> int:
    return cfg["n_exits"]


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every parameter and statistic."""
    specs = []

    def conv_bn(prefix, cin, cout):
        specs.append((prefix + ".conv.kernel", (cout, cin, 3, 3), "kernel",
                      cin * 9))
        specs.extend((f"{prefix}.bn.{k}", (cout,), "bn_" + k, 0)
                     for k in ("scale", "bias", "mean", "var"))

    h, _, c = cfg["input_shape"]
    blocks = _blocks(cfg)
    for i, chans in enumerate(blocks):
        for j, ch in enumerate(chans):
            conv_bn(f"block{i}.convbn{j}", c, ch)
            c = ch
        h //= 2
        if i < len(blocks) - 1 and i < cfg["n_exits"] - 1:
            w, s = c, h
            for k, ch in enumerate(_exit_chain(c)):
                conv_bn(f"exit{i + 1}.convbn{k + 1}", w, ch)
                w, s = ch, (s + 1) // 2
            if s > 1:
                s //= 2
            specs.append((f"exit{i + 1}.linear.kernel",
                          (w * s * s, cfg["num_classes"]), "head",
                          w * s * s))
            specs.append((f"exit{i + 1}.linear.bias", (cfg["num_classes"],),
                          "bias", 0))
    width = c * h * h
    for j, d in enumerate(cfg["head_dims"]):
        specs.append((f"fc_{j}.kernel", (width, d), "kernel", width))
        specs.append((f"fc_{j}.bias", (d,), "bias", 0))
        if j == 0:
            specs.extend((f"fc_bn_{j}.{k}", (d,), "bn_" + k, 0)
                         for k in ("scale", "bias", "mean", "var"))
        width = d
    specs.append(("classifier.kernel", (width, cfg["num_classes"]), "head",
                  width))
    specs.append(("classifier.bias", (cfg["num_classes"],), "bias", 0))
    return specs


def layer_shapes(cfg: dict) -> list[dict]:
    """Every conv, dense layer and MC head of one image's forward, with
    the sizes ``perfbench.work`` counts: a conv's output pixels, a dense
    layer's or a head's (K, N)."""
    out = []
    h, _, c = cfg["input_shape"]
    blocks = _blocks(cfg)
    for i, chans in enumerate(blocks):
        for j, ch in enumerate(chans):
            out.append({"name": f"block{i}.convbn{j}", "op": "conv",
                        "cin": c, "cout": ch, "k": 3, "pixels": h * h})
            c = ch
        h //= 2
        if i < len(blocks) - 1 and i < cfg["n_exits"] - 1:
            w, s = c, h
            for k, ch in enumerate(_exit_chain(c)):
                s = (s + 1) // 2
                out.append({"name": f"exit{i + 1}.convbn{k + 1}",
                            "op": "conv", "cin": w, "cout": ch, "k": 3,
                            "pixels": s * s})
                w = ch
            if s > 1:
                s //= 2
            out.append({"name": f"exit{i + 1}.linear", "op": "head",
                        "k": w * s * s, "n": cfg["num_classes"]})
    width = c * h * h
    for j, d in enumerate(cfg["head_dims"]):
        out.append({"name": f"fc_{j}", "op": "dense", "k": width, "n": d})
        width = d
    out.append({"name": "classifier", "op": "head", "k": width,
                "n": cfg["num_classes"]})
    return out


def forward(p: dict, x, pairs, cfg: dict, num: Numerics = Numerics(),
            train: bool = False):
    """Logits of NHWC images x: (S, E, B, C) for ``pairs`` (S, sites, 2)
    at inference (running BatchNorm statistics), or (E, B, C) for one
    step's ``pairs`` (sites, 2) in training (batch statistics)."""
    if num.grid is not None:
        raise ValueError("the VGG reference is a float one")
    rate = cfg["mc_rate"]
    bn = bn_train if train else bn_eval

    def conv_bn_relu(y, prefix, stride):
        y = conv(y, p[prefix + ".conv.kernel"], stride, 1, num)
        return (bn(y, p, prefix + ".bn")).relu()

    def head(feat, prefix, site):
        return mc_dense(feat, p[prefix + ".kernel"], p[prefix + ".bias"],
                        pairs[..., site, :], rate, num)

    y = x.permute(0, 3, 1, 2)
    exits = []
    blocks = _blocks(cfg)
    for i, chans in enumerate(blocks):
        for j in range(len(chans)):
            y = conv_bn_relu(y, f"block{i}.convbn{j}", 1)
        y = F.max_pool2d(y, 2, 2)
        if i < len(blocks) - 1 and i < cfg["n_exits"] - 1:
            e = y.relu()
            for k in range(len(_exit_chain(y.shape[1]))):
                e = conv_bn_relu(e, f"exit{i + 1}.convbn{k + 1}", 2)
            if e.shape[-1] > 1:
                e = F.avg_pool2d(e, 2, 2)
            exits.append(head(flatten_nhwc(e), f"exit{i + 1}.linear",
                              len(exits)))
    h = flatten_nhwc(y)
    for j in range(len(cfg["head_dims"])):
        h = num.operand(h) @ num.operand(p[f"fc_{j}.kernel"]) + p[
            f"fc_{j}.bias"]
        if j == 0:
            h = bn(h, p, f"fc_bn_{j}")
        h = h.relu()
    exits.append(head(h, "classifier", len(exits)))
    return torch.stack(exits, dim=-3)
