"""Shared CLI plumbing: flags → typed configs (counterpart of
``bayestpu/cli/common.py``: the same flags, defaults and choices, plus
``--device``).

``--fused`` selects the port's CUDA-kernel heads and sites; ``--int8`` the
int8 kernels. ``--device`` is where every CLI runs: ``cuda`` (the default)
raises without a card, ``cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse

from bayestpu_torch.core.config import (
    BayesConfig,
    DropoutKind,
    EngineConfig,
    InsertStrategy,
    QuantConfig,
    SamplingMode,
)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="lenet",
                   help="zoo name (lenet, lenet_me, resnet18_me, vgg11, ...)")
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "cifar10", "cifar100", "svhn", "jet",
                            "imagenet", "chestx"])
    p.add_argument("--data_dir", default=None)
    # ≙ --dropout_type {mc,mask} (train_qkeras_mcme.py:207)
    p.add_argument("--dropout_type", default="mc",
                   choices=["mc", "mask", "none"])
    p.add_argument("--dropout_rate", type=float, default=0.25)
    p.add_argument("--num_masks", type=int, default=4)
    p.add_argument("--scale", type=float, default=2.0)
    p.add_argument("--mc_samples", type=int, default=10)
    p.add_argument("--num_bayes_layer", type=int, default=1)
    p.add_argument("--strategy", default="default",
                   choices=["default", "last", "full"])
    # ≙ --quant_tbit/--quant_ibit (train_qkeras_mcme.py:213-214)
    p.add_argument("--quant_tbit", type=int, default=0,
                   help="0 = float; 8 = the paper operating point")
    p.add_argument("--quant_ibit", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="run the heads and sites on the int8 kernels")
    p.add_argument("--quant_mixed_head", action="store_true",
                   help="per-layer mixed precision: fc_0 bias + following "
                        "relu at 2x the base bits (≙ s_qmodels_bayes.py:"
                        "294-298 / qmodels.py:327-331; vgg models only)")
    p.add_argument("--opt_mode", default="spatial",
                   choices=["spatial", "temporal", "sharded"],
                   help="MC mapping (≙ S_*/T_* models)")
    p.add_argument("--fused", action="store_true",
                   help="the CUDA masked-kernel heads and sites")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)


def bayes_from_args(a: argparse.Namespace) -> BayesConfig:
    return BayesConfig(
        kind=DropoutKind(a.dropout_type), rate=a.dropout_rate,
        num_masks=a.num_masks, scale=a.scale, num_samples=a.mc_samples,
        num_bayes_layers=a.num_bayes_layer,
        strategy=InsertStrategy(a.strategy))


def quant_from_args(a: argparse.Namespace) -> QuantConfig | None:
    if a.quant_tbit <= 0:
        return None
    return QuantConfig(total_bits=a.quant_tbit, integer_bits=a.quant_ibit,
                       int8_infer=getattr(a, "int8", False))


def engine_from_args(a: argparse.Namespace) -> EngineConfig:
    return EngineConfig(mode=SamplingMode(a.opt_mode),
                        quant=quant_from_args(a))


def run_suffix(a: argparse.Namespace) -> str:
    """Run-name suffix in the reference's convention (``main.py:80-88``:
    ``me_`` for multi-exit, then ``mc_droprate<p>`` / ``mask_scale<s>``)."""
    s = "me_" if a.model.endswith("_me") else ""
    if a.dropout_type == "mask":
        s += f"mask_scale{int(a.scale)}"
    elif a.dropout_type == "mc":
        s += f"mc_droprate{a.dropout_rate:g}"
    return s


def build_model(a: argparse.Namespace):
    from bayestpu_torch.data.datasets import _SHAPES
    from bayestpu_torch.nn.zoo import get_model
    num_classes = _SHAPES[a.dataset][1]
    kw = {}
    if getattr(a, "quant_mixed_head", False):
        if not a.model.startswith("vgg"):
            raise SystemExit("--quant_mixed_head is a vgg head option "
                             "(the reference's fc_0 2x-bits head)")
        kw["mixed_head"] = True
    return get_model(a.model, bayes=bayes_from_args(a),
                     quant=quant_from_args(a), num_classes=num_classes,
                     fused=a.fused, **kw)
