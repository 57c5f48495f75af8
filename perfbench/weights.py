"""Weights and inputs made from ``--seed``, on the device, in a few large
calls.

A configuration's reference lists its parameters (``param_specs``: name,
shape, kind, fan-in). One ``torch.Generator`` on the device seeded with
the run's seed draws one normal vector for them all and one uniform vector
for the BatchNorm variances; each parameter is a slice of them, scaled by
its kind as the configuration's ``init`` says:

- ``kernel``: normal · gain/sqrt(fan_in) (gain sqrt(2): He, so that
  activations keep their scale through relu layers); ``head``, the kernel
  of a classifier, the same with ``head_gain``, which sets how far the
  predictive is from uniform;
- ``bias``: normal · ``bias_std``;
- ``bn_scale``: ``bn_scale`` · (1 + normal · ``bn_jitter``);
- ``bn_bias`` and ``bn_mean``: normal · ``bn_shift``;
- ``bn_var``: uniform in [``var_lo``, ``var_hi``].

Weights are f32, the type the program stores and serves them in (a bf16
model rounds its operands per call).
"""

from __future__ import annotations

import math

import torch

INIT = {"gain": math.sqrt(2.0), "head_gain": math.sqrt(2.0), "bias_std": 0.05,
        "bn_scale": 1.0,
        "bn_jitter": 0.1, "bn_shift": 0.1, "var_lo": 0.5, "var_hi": 1.5}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` for a 64-bit seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return g


def make_params(specs: list, seed: int, device, init: dict | None = None
                ) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``specs`` drawn from ``seed``."""
    init = {**INIT, **(init or {})}
    g = generator(seed, device)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind in ("kernel", "head"):
            gain = init["gain" if kind == "kernel" else "head_gain"]
            t = z * (gain / math.sqrt(fan_in))
        elif kind == "bias":
            t = z * init["bias_std"]
        elif kind == "bn_scale":
            t = init["bn_scale"] * (1.0 + z * init["bn_jitter"])
        elif kind in ("bn_bias", "bn_mean"):
            t = z * init["bn_shift"]
        elif kind == "bn_var":
            t = init["var_lo"] + u * (init["var_hi"] - init["var_lo"])
        else:
            raise ValueError(f"{name}: unknown parameter kind {kind!r}")
        out[name] = t.contiguous()
    return out


def make_images(seed: int, count: int, batch: int, shape, device,
                stream: int = 1) -> torch.Tensor:
    """(count, batch, H, W, C) f32 standard-normal images (CIFAR inputs as
    normalized), drawn from ``seed`` on a stream apart from the
    weights'."""
    g = generator(seed * 7919 + stream, device)
    return torch.randn((count, batch) + tuple(shape), generator=g,
                       device=device)


def make_labels(seed: int, count: int, batch: int, classes: int, device
                ) -> torch.Tensor:
    g = generator(seed * 7919 + 2, device)
    return torch.randint(0, classes, (count, batch), generator=g,
                         device=device)
