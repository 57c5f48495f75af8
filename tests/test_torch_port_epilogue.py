"""The one-pass bf16 epilogue (``kernels.epilogue.bias_act_bf16``; the
kernel ``bf16_epilogue_kernel`` of ``bayestpu_torch/csrc/epilogue.cu``)
and the route that takes it: every conv of a bf16 float model at
inference whose kernel did not run its epilogue.

The CPU tests hold the route to the op sequence it replaced in ``BayesConv``
and ``_Block`` after ``xla_conv``'s f32 output (``+ bias``, relu,
``.to(bf16)``, ``relu(y + residual)``), check which convs take the
residual, and count the route's passes in a forward. The
tests marked ``card`` hold the kernel to its plain version bit for bit on
the card (``torch.equal``: the kernel rounds as the op sequence does), at
each epilogue shape of the resnet50 block-site and vgg11 benchmark cells,
and one whole resnet50 block-site forward against the same forward with the
wrapper replaced by its plain version. The file imports neither JAX nor
the JAX package, so that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_port_epilogue.py --noconftest -q

The card tests decide inside the ``card`` fixture whether there is a card,
and skip without one.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.core.rng import sample_seeds, step_seeds
from bayestpu_torch.kernels import epilogue as te
from bayestpu_torch.nn import fused
from bayestpu_torch.nn.layers import ConvBN, xla_conv
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.utils import profiler

from port_threads import thread_budget  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import resnet_blocks  # noqa: E402

BF16 = torch.bfloat16
# (rows, H = W, C, act, residual) of the resnet50 block-site cell's 47
# epilogues (batch 128, S = 10: stages 2-4 on 1,280 rows), each once
RESNET50 = {
    "stem": (128, 112, 64, "relu", False),
    "s1_relu": (128, 56, 64, "relu", False),
    "s1_last": (128, 56, 256, None, True),
    "s1_down": (128, 56, 256, None, False),
    "s2_relu": (1280, 28, 128, "relu", False),
    "s2_last": (1280, 28, 512, None, True),
    "s3_relu": (1280, 14, 256, "relu", False),
    "s3_last": (1280, 14, 1024, None, True),
    "s4_relu": (1280, 7, 512, "relu", False),
    "s4_last": (1280, 7, 2048, None, True),
}
# the vgg11_me cell's (batch 128): the backbone's and the exit cascades'
VGG11 = {"b1": (128, 32, 64), "b2": (128, 16, 128), "b3": (128, 8, 256),
         "b4": (128, 4, 512), "b5": (128, 2, 512), "x8": (128, 8, 128),
         "x4": (128, 4, 256), "x1": (128, 1, 512)}
SHAPES = {**{f"resnet50_{k}": v[:3] for k, v in RESNET50.items()},
          **{f"vgg11_{k}": v for k, v in VGG11.items()}}
VARIANTS = [("relu", False), ("relu", True), (None, True), (None, False)]
# ResNet-50 with the ImageNet stem and block sites, the cell's model at
# planes (8, 16, 32, 64) and 64x64 images (32 channels at the first site,
# the fewest a fused masked conv takes)
SMALL = dict(stem="imagenet", dropout="block", n_exits=1, fused=True,
             num_classes=10, input_shape=(64, 64, 3),
             stage_planes=(8, 16, 32, 64))
S = 3


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _data(rows: int, hw: int, c: int, device, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    y = _cl(torch.randn(rows, c, hw, hw, generator=gen, device=device)
            .to(BF16))
    res = _cl(torch.randn(rows, c, hw, hw, generator=gen, device=device)
              .to(BF16))
    bias = torch.randn(c, generator=gen, device=device) * 0.5
    return y, bias, res


def _old(y, bias, act, residual):
    """The op sequence the kernel replaced: ``BayesConv``'s epilogue after
    ``xla_conv``'s widening, then ``_Block``'s ``relu(y + residual)``."""
    t = y.float()
    if bias is not None:
        t = t + bias[:, None, None]
    if act == "relu":
        t = torch.relu(t)
    t = t.to(BF16)
    return t if residual is None else torch.relu(t + residual)


def _counted(fn):
    """``fn()`` and the two epilogue counters it added."""
    names = ("epilogue.launches", "epilogue.residual_launches")
    before = profiler.counters()
    out = fn()
    after = profiler.counters()
    return out, tuple(after.get(k, 0) - before.get(k, 0) for k in names)


# ------------------------------------------------------------------- CPU


def _layer(kind: str) -> ConvBN:
    """A ``ConvBN`` 16 -> 24, 3x3, with a seeded kernel and BatchNorm
    (``kind`` "convbn"), in bf16, or its f32, int8 or MC-site twin."""
    gen = torch.Generator().manual_seed(5)
    layer = ConvBN(16, 24, (3, 3), dtype=torch.float32 if kind == "f32"
                   else BF16,
                   quant=(QuantConfig(8, 0, int8_infer=True)
                          if kind == "int8" else None),
                   bayes=BayesConfig(rate=0.25) if kind == "site" else None)
    with torch.no_grad():
        layer.conv.kernel.copy_(torch.randn(24, 16, 3, 3, generator=gen)
                                * 0.2)
        layer.bn.mean.copy_(torch.randn(24, generator=gen) * 0.1)
        layer.bn.var.copy_(torch.rand(24, generator=gen) + 0.5)
        layer.bn.bias.copy_(torch.randn(24, generator=gen) * 0.3)
    return layer.eval()


@pytest.mark.parametrize("samples", [False, True])
@pytest.mark.parametrize("bias_on", [True, False])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("act", ["relu", None])
def test_convbn_route_equals_the_old_path(act, with_res, bias_on, samples):
    """A bf16 conv at inference, with the folded BatchNorm's bias
    (``ConvBN``) or with none (its ``BayesConv`` alone), with and without
    the residual, NCHW or with the sample axis (S, N, C, H, W): equal bit
    for bit to ``xla_conv``'s f32 output plus the bias, relu, bf16, then
    ``relu(y + residual)``, in y's channels_last layout, and one pass of
    the route (one with the residual)."""
    gen = torch.Generator().manual_seed(6)
    layer = _layer("convbn")
    x = _cl(torch.randn(4, 16, 9, 9, generator=gen).to(BF16))
    res = (_cl(torch.randn(4, 24, 9, 9, generator=gen).to(BF16))
           if with_res else None)
    if samples:
        x = x.unflatten(0, (2, 2))
        res = None if res is None else res.unflatten(0, (2, 2))
    with torch.no_grad():
        if bias_on:
            got, n = _counted(lambda: layer(x, act=act, residual=res))
            inv, shift = layer.bn.fold()
            kernel = layer.conv.kernel * inv[:, None, None, None]
        else:
            got, n = _counted(lambda: layer.conv(x, act=act, residual=res))
            shift, kernel = None, layer.conv.kernel
        y = xla_conv(x, kernel, "SAME", 1, BF16).to(BF16)
    want = _old(y, shift, act, res)
    assert got.dtype == BF16 and torch.equal(got, want)
    assert got.flatten(0, -4).is_contiguous(
        memory_format=torch.channels_last)
    assert n == (1, int(with_res))


@pytest.mark.parametrize("kind", ["train", "f32", "int8", "site"])
def test_residual_only_where_the_conv_joins_it(kind):
    """Only a bf16 float conv without a mask at inference takes
    ``residual=`` (``joins_residual``); in training, in f32, in the int8
    model and at an MC site it is refused, and ``_Block`` adds the
    residual itself."""
    layer = _layer("convbn" if kind == "train" else kind)
    assert layer.conv.joins_residual == (kind == "train")
    if kind == "train":
        layer.train()
        assert not layer.conv.joins_residual
    dtype = torch.float32 if kind == "f32" else BF16
    x = _cl(torch.randn(2, 16, 5, 5).to(dtype))
    res = _cl(torch.randn(2, 24, 5, 5).to(dtype))
    with torch.no_grad(), pytest.raises(ValueError, match="residual"):
        layer(x, act=None, residual=res,
              seeds=sample_seeds(9, 1, 1)[0, 0] if kind == "site" else None)


def test_checks_refuse_what_the_kernel_does_not_take():
    y, bias, res = _data(2, 3, 8, "cpu", 1)
    with pytest.raises(ValueError, match="act"):
        te.bias_act_bf16(y, bias, "gelu")
    with pytest.raises(ValueError, match="bf16"):
        te.bias_act_bf16(y.float(), bias)
    with pytest.raises(ValueError, match="bias"):
        te.bias_act_bf16(y, bias[:4])
    with pytest.raises(ValueError, match="residual"):
        te.bias_act_bf16(y, bias, None, res.float())
    with pytest.raises(ValueError, match="residual"):
        te.bias_act_bf16(y, bias, None, res[:1])


def test_channels_inner_copies_only_what_it_must():
    """The layout the kernel reads: a channels_last tensor and one that
    carries the sample axis pass as they are; a channel slice is copied
    with its channel innermost, equal in value."""
    y = _data(4, 3, 16, "cpu", 2)[0]
    assert te._channels_inner(y) is y
    y5 = y.unflatten(0, (2, 2))
    assert te._channels_inner(y5) is y5
    sl = y[:, 3:11]
    got = te._channels_inner(sl)
    assert got.movedim(-3, -1).is_contiguous() and torch.equal(got, sl)


def _resnet50(dtype, quant=None):
    model = get_model("resnet50", bayes=BayesConfig(rate=0.25),
                      dtype=dtype, quant=quant, **SMALL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval()


def _images(n=2):
    return torch.randn(n, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(3))


def test_resnet50_blocks_bf16_counts_47_and_16_a_forward():
    """The cell's model in bf16 at inference: the stem, the 46 block convs
    without a site and the first block's projection take the one-pass
    epilogue (47), the 16 blocks' last convs with the residual; the six
    masked site convs keep their own."""
    model = _resnet50(BF16)
    seeds = sample_seeds(9, S, model.num_sites)
    with torch.no_grad():
        _, n = _counted(lambda: model(_images(), seeds))
    assert n == (47, 16)


@pytest.mark.parametrize("case", ["train", "f32", "int8"])
def test_resnet50_bypasses_the_epilogue(case):
    """No launch in training mode, in f32, or in the int8 model."""
    if case == "train":
        model = _resnet50(BF16).train()
        seeds = step_seeds(9, 0, model.num_sites)
    else:
        model = (_resnet50(torch.float32) if case == "f32" else _resnet50(
            BF16, QuantConfig(8, 0, int8_infer=True)))
        seeds = sample_seeds(9, S, model.num_sites)
    with torch.no_grad():
        _, n = _counted(lambda: model(_images(), seeds))
    assert n == (0, 0)


def test_resnet18_mask_block_sites_f32_residual():
    """The Masksembles block-site resnet18 in bf16 at inference: each
    deferred site's projection is a bank conv with an f32 output, so its
    block's last conv runs the one-pass epilogue without the residual and
    ``_Block`` adds it after, in f32 as before, and the blocks after it
    carry f32:
    14 launches (the stem and every block conv but the three site convs),
    2 with the residual (stage 1's blocks); finite logits."""
    model = get_model("resnet18", bayes=BayesConfig(
        kind=DropoutKind.MASK, num_masks=4, scale=2.0), fused=True,
        dropout="block", dtype=BF16, num_classes=10,
        input_shape=(16, 16, 3), stage_planes=(32, 32, 32, 32)).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(6))
    seeds = torch.zeros(4, 0, 2, dtype=torch.int32)
    with torch.no_grad():
        out, n = _counted(lambda: model(x, seeds, torch.arange(4)))
    assert n == (14, 2) and torch.isfinite(out.logits).all()


def test_vgg11_me_bf16_every_conv_takes_the_epilogue():
    """vgg11_me in bf16 at inference: every ``ConvBN`` (the backbone's 8
    and the exit cascades') takes the one-pass epilogue, none with a
    residual."""
    model = get_model("vgg11_me", bayes=BayesConfig(rate=0.25), fused=True,
                      dtype=BF16, num_classes=10, input_shape=(32, 32, 3),
                      n_exits=5, cfg_name="vgg11",
                      head_dims=[512, 512]).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    convs = sum(isinstance(m, ConvBN) for m in model.modules())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        _, n = _counted(lambda: model(
            x, sample_seeds(9, S, model.num_sites)))
    assert convs > 8 and n == (convs, 0)


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = prev


def _kernel_equals_plain(y, bias, act, res):
    before = te.launch_counts["bias_act_bf16"]
    got = te.bias_act_bf16(y, bias, act, res)
    want = te.bias_act_bf16_plain(y, bias, act, res)
    torch.cuda.synchronize()
    assert te.launch_counts["bias_act_bf16"] == before + 1
    assert got.dtype == BF16 and got.shape == y.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.card
@pytest.mark.parametrize("act,with_res", VARIANTS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_equals_plain_at_the_cells_shapes(card, name, act, with_res):
    """At every epilogue shape of the resnet50 block-site and vgg11 cells,
    with relu and without, with a residual and without: bit-equal to the
    plain version, in y's channels_last layout."""
    rows, hw, c = SHAPES[name]
    y, bias, res = _data(rows, hw, c, card, sum(map(ord, name)))
    got = _kernel_equals_plain(y, bias, act, res if with_res else None)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.card
@pytest.mark.parametrize("act,with_res", VARIANTS)
def test_kernel_scalar_paths(card, act, with_res):
    """The one-element path: an odd C, a y and a residual 2 bytes off the
    16-byte alignment (a view at storage offset 1), a channel slice (copied
    channels-innermost), no bias, and a sample axis."""
    y, bias, res = _data(7, 5, 37, card, 7)
    _kernel_equals_plain(y, bias, act, res if with_res else None)
    _kernel_equals_plain(y, None, act, res if with_res else None)
    y, bias, res = _data(6, 4, 64, card, 8)

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=BF16, device=card)
        v = flat[1:].view(t.shape[0], t.shape[2], t.shape[3], t.shape[1])
        v.copy_(t.permute(0, 2, 3, 1))
        return v.permute(0, 3, 1, 2)

    yo, ro = off(y), off(res)
    assert yo.data_ptr() % 16 and torch.equal(yo, y)
    _kernel_equals_plain(yo, bias, act, ro if with_res else None)
    _kernel_equals_plain(y[:, 8:40], bias[8:40], act,
                         res[:, 8:40] if with_res else None)
    _kernel_equals_plain(y.unflatten(0, (2, 3)), bias, act,
                         res.unflatten(0, (2, 3)) if with_res else None)


@pytest.mark.card
def test_resnet50_blocks_forward_equals_the_plain_epilogue(card,
                                                           monkeypatch):
    """One forward of the resnet50 block-site cell's model (ImageNet stem,
    224x224, bf16, S = 10, the benchmark's seeded weights; batch 16) on the
    card: the kernel launched 47 times, 16 with the residual, and the
    exits finite and bit-equal to the same forward with the wrapper
    replaced by its plain version (the op sequence it replaced, on the
    card)."""
    cfg = json.loads((ROOT / "perfbench/configs/resnet50_blocks_bf16.json")
                     .read_text())
    model = get_model("resnet50", bayes=BayesConfig(rate=cfg["mc_rate"]),
                      fused=True, dtype=BF16,
                      num_classes=cfg["num_classes"],
                      input_shape=tuple(cfg["input_shape"]), n_exits=1,
                      **cfg["model_kwargs"]).to(card).eval()
    model.load_state_dict(weights.make_params(
        resnet_blocks.param_specs(cfg), 2 ** 33 + 1, card, cfg["init"]))
    x = weights.make_images(7, 1, 16, cfg["input_shape"], card)[0]
    seeds = sample_seeds(2 ** 31 + 5, 10, model.num_sites).to(card)
    before = te.launch_counts["bias_act_bf16"]
    with torch.no_grad():
        got, n = _counted(lambda: model(x, seeds))
        assert n == (47, 16)
        assert te.launch_counts["bias_act_bf16"] == before + 47
        monkeypatch.setattr(fused, "bias_act_bf16", te.bias_act_bf16_plain)
        want = model(x, seeds)
    torch.cuda.synchronize()
    assert te.launch_counts["bias_act_bf16"] == before + 47
    assert torch.isfinite(got.logits).all()
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(got.features, want.features)
