"""Import the reference's PyTorch weights into port models (a copy of
``bayestpu/interop/torch_import.py``, numpy only).

The functions return the nested-numpy ``{"params", "batch_stats"}`` tree
that ``interop.from_flax.load_flax_variables`` and ``BayesEngine.attach``
take, filled into a template from ``to_flax_variables(model)``; the port's
modules carry the Flax names, so the template has the JAX model's
structure and the copy is the JAX function line for line:

- layout conversion torch→Flax: conv ``(O, I, kh, kw)`` → ``(kh, kw, I, O)``
  (OIHW → HWIO; ``load_flax_variables`` turns it back), linear
  ``(out, in)`` → ``(in, out)``;
- the flatten-order fix: torch flattens NCHW (index ``c·H·W + h·W + w``),
  channels-last flattens NHWC (``h·W·C + w·C + c``) — the first dense layer
  after a flatten needs its input rows permuted accordingly;
- BatchNorm mapping (weight/bias/running_mean/running_var → scale/bias/
  mean/var in flax's ``batch_stats``);
- key re-mapping mirrors the reference's own porting helper
  (``vgg_pytorch_to_new_vgg`` + ``check_weight_load``,
  ``Software_Artifact/software/models/vgg19/vgg19.py:53-84``).

Everything takes plain numpy state dicts, so torch is only needed by the
caller, not by this module.
"""

from __future__ import annotations

import numpy as np


def conv_weight(w: np.ndarray) -> np.ndarray:
    """torch conv (O, I, kh, kw) → flax (kh, kw, I, O)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def linear_weight(w: np.ndarray) -> np.ndarray:
    """torch linear (out, in) → (in, out)."""
    return np.transpose(np.asarray(w), (1, 0))


def flatten_permutation(c: int, h: int, w: int) -> np.ndarray:
    """Row permutation for the first dense after a flatten.

    Returns ``perm`` with ``perm[nhwc_index] = nchw_index`` so that
    ``kernel = linear_weight(w_torch)[perm]`` consumes channels-last
    flattened activations.
    """
    idx = np.arange(c * h * w).reshape(c, h, w)       # nchw flat index grid
    return idx.transpose(1, 2, 0).reshape(-1)          # walk in nhwc order


def linear_weight_after_flatten(w: np.ndarray, c: int, h: int, wdim: int
                                ) -> np.ndarray:
    return linear_weight(w)[flatten_permutation(c, h, wdim)]


def batchnorm_params(prefix: str, sd: dict) -> tuple[dict, dict]:
    """(params, batch_stats) entries for one torch BatchNorm layer."""
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


def check_weight_load(expected: np.ndarray, loaded: np.ndarray,
                      atol: float = 0.0) -> None:
    """Assert a known weight survived the port (≙ ``check_weight_load``,
    ``vgg19.py:53-64``)."""
    if not np.allclose(expected, loaded, atol=atol):
        raise ValueError("weight port mismatch: max abs diff "
                         f"{np.abs(np.asarray(expected) - np.asarray(loaded)).max()}")


def import_reference_resnet18(sd: dict, variables: dict,
                              stage_blocks=(2, 2, 2, 2)) -> dict:
    """Port a state dict of the reference's multi-exit ResNet-18
    (``Software_Artifact/software/models/resnet18/resnet18.py`` —
    ``ResNet``/``ResNet18EarlyExit``; layout ``conv1/bn1``, ``layer{L}.{B}``,
    ``ex{e}conv{i}/ex{e}bn{i}/ex{e}linear``, ``linear``) into the variables
    of ``get_model("resnet18_me")`` (``ResNet18(n_exits=4)``), whose
    template ``variables`` is ``to_flax_variables(model)``.

    ``sd`` maps torch names → numpy arrays (``{k: v.numpy() for k, v in
    model.state_dict().items()}``), so reference checkpoints saved with
    ``torch.save`` (``train_base.py:71-74``) load directly after
    ``torch.load(...).state_dict()``.
    """
    variables = _to_mutable(variables)
    p, bs = variables["params"], variables["batch_stats"]

    def put_convbn(dst_p: dict, dst_bs: dict, conv: str, bn: str) -> None:
        dst_p["conv"] = {"kernel": conv_weight(sd[conv + ".weight"])}
        dst_p["bn"] = {"scale": np.asarray(sd[bn + ".weight"]),
                       "bias": np.asarray(sd[bn + ".bias"])}
        dst_bs["bn"] = {"mean": np.asarray(sd[bn + ".running_mean"]),
                        "var": np.asarray(sd[bn + ".running_var"])}

    put_convbn(p["stem"], bs["stem"], "conv1", "bn1")
    for s, n_blocks in enumerate(stage_blocks):
        for b in range(n_blocks):
            name = f"layer{s + 1}_{b}"
            t = f"layer{s + 1}.{b}"
            put_convbn(p[name]["convbn1"], bs[name]["convbn1"],
                       f"{t}.conv1", f"{t}.bn1")
            put_convbn(p[name]["convbn2"], bs[name]["convbn2"],
                       f"{t}.conv2", f"{t}.bn2")
            if f"{t}.downsample.0.weight" in sd:
                put_convbn(p[name]["downsample"], bs[name]["downsample"],
                           f"{t}.downsample.0", f"{t}.downsample.1")
    n_exits = sum(1 for k in p if k.startswith("exit")) + 1
    for e in range(1, n_exits):
        for i in range(1, len(stage_blocks) - e + 1):
            put_convbn(p[f"exit{e}"][f"convbn{i}"],
                       bs[f"exit{e}"][f"convbn{i}"],
                       f"ex{e}conv{i}", f"ex{e}bn{i}")
        p[f"exit{e}"]["linear"] = {
            "kernel": linear_weight(sd[f"ex{e}linear.weight"]),
            "bias": np.asarray(sd[f"ex{e}linear.bias"])}
    p["linear"] = {"kernel": linear_weight(sd["linear.weight"]),
                   "bias": np.asarray(sd["linear.bias"])}
    check_weight_load(sd["linear.bias"], p["linear"]["bias"])
    return variables


def import_reference_vgg19(sd: dict, variables: dict) -> dict:
    """Port the reference's 5-exit ``VGG19EarlyExit``
    (``Software_Artifact/software/models/vgg19/vgg19.py:255-324``: blocks of
    [Conv, BN, ReLU]×k + MaxPool as ``blocks.{b}``, exit feature extractors
    ``ex{e}featureextractor`` of [conv,bn,relu]×k, single-linear classifiers
    for 32×32) into the variables of ``get_model("vgg19_me")``
    (``VGG(cfg_name='vgg19', n_exits=5)``)."""
    variables = _to_mutable(variables)
    p, bs = variables["params"], variables["batch_stats"]

    def put_convbn(dst_p, dst_bs, conv, bn):
        dst_p["conv"] = {"kernel": conv_weight(sd[conv + ".weight"])}
        dst_p["bn"] = {"scale": np.asarray(sd[bn + ".weight"]),
                       "bias": np.asarray(sd[bn + ".bias"])}
        mean = np.asarray(sd[bn + ".running_mean"])
        # the reference's backbone convs keep their bias (default Conv2d,
        # ``make_layers`` vgg19.py:132); our ConvBN conv is bias-free, so
        # fold it into the BN mean: (y+c-μ)/σ == (y-(μ-c))/σ
        if conv + ".bias" in sd:
            mean = mean - np.asarray(sd[conv + ".bias"])
        dst_bs["bn"] = {"mean": mean,
                        "var": np.asarray(sd[bn + ".running_var"])}

    n_blocks = sum(1 for k in p if k.startswith("block"))
    for b in range(n_blocks):
        n_convs = sum(1 for k in p[f"block{b}"] if k.startswith("convbn"))
        for j in range(n_convs):
            # torch Sequential index: conv at 3j, bn at 3j+1
            put_convbn(p[f"block{b}"][f"convbn{j}"],
                       bs[f"block{b}"][f"convbn{j}"],
                       f"blocks.{b}.{3 * j}", f"blocks.{b}.{3 * j + 1}")
    n_exits = sum(1 for k in p if k.startswith("exit"))
    for e in range(1, n_exits + 1):
        n_convs = sum(1 for k in p[f"exit{e}"] if k.startswith("convbn"))
        for j in range(n_convs):
            put_convbn(p[f"exit{e}"][f"convbn{j + 1}"],
                       bs[f"exit{e}"][f"convbn{j + 1}"],
                       f"ex{e}featureextractor.{3 * j}",
                       f"ex{e}featureextractor.{3 * j + 1}")
        p[f"exit{e}"]["linear"] = {
            "kernel": linear_weight(sd[f"ex{e}linear.0.weight"]),
            "bias": np.asarray(sd[f"ex{e}linear.0.bias"])}
    p["classifier"] = {"kernel": linear_weight(sd["classifier.0.weight"]),
                       "bias": np.asarray(sd["classifier.0.bias"])}
    check_weight_load(sd["classifier.0.bias"], p["classifier"]["bias"])
    return variables


def _to_mutable(tree):
    if hasattr(tree, "items"):
        return {k: _to_mutable(v) for k, v in tree.items()}
    return np.asarray(tree)
