"""``resnet50`` and ``resnet18`` with the ImageNet stem and MC block sites
(``get_model(..., stem="imagenet", dropout="block", n_exits=1,
fused=True)``) against the benchmark's plain references
(``perfbench.reference.resnet_blocks`` and ``resnet18_blocks``), on the
CPU.

The JAX package has no ImageNet stem, so the references written from the
published models (He et al., Table 1; v1.5 strides for ResNet-50) are the
yardstick here. Every case runs the published block counts ([3, 4, 6, 3]
and [2, 2, 2, 2]) at small planes and 64×64 inputs on seeded random
weights: ResNet-50's planes (8, 16, 32, 64) and ResNet-18's (32, 48, 64,
96) put 32 channels on the first site's input, the fewest a fused masked
conv takes (``MASKED_CONV_FUSE_MIN_CH``), so every site runs the masked
conv of the card's path (its plain version here): ResNet-50's 1×1
``convbn1``, ResNet-18's 3×3 stride-2 one, zero-padded by 1.
"""

import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import profile

from bayestpu_torch.core.config import BayesConfig
from bayestpu_torch.core.rng import sample_seeds
from bayestpu_torch.engine import sampler
from bayestpu_torch.engine.engine import _has_device_spans
from bayestpu_torch.kernels.masked_conv import stack_samples
from bayestpu_torch.nn.layers import max_pool
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.utils import profiler

from port_threads import thread_budget  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import (common, resnet18_blocks,  # noqa: E402
                                 resnet_blocks)

# each model's benchmark cell, its reference and its small planes
MODELS = {
    "resnet50": ("resnet50_blocks_bf16", resnet_blocks, [8, 16, 32, 64]),
    "resnet18": ("resnet18_blocks_bf16", resnet18_blocks, [32, 48, 64, 96]),
}
SIZE = 64
SEED = 2 ** 31 + 17
REQUEST = 77
S = 3


def config(model="resnet50", dtype="float32", size=SIZE, classes=10, **kw):
    """The benchmark's configuration of ``model`` at the small size."""
    name, _, planes = MODELS[model]
    cfg = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    return dict(cfg, stage_planes=planes, input_shape=[size, size, 3],
                num_classes=classes, dtype=dtype, **kw)


def reference(cfg):
    return {"resnet_blocks": resnet_blocks,
            "resnet18_blocks": resnet18_blocks}[cfg["reference"]]


def port(cfg):
    model = get_model(cfg["model"], bayes=BayesConfig(rate=cfg["mc_rate"]),
                      fused=cfg["fused"], dtype=getattr(torch, cfg["dtype"]),
                      num_classes=cfg["num_classes"],
                      input_shape=tuple(cfg["input_shape"]),
                      n_exits=cfg["n_exits"], stage_planes=cfg["stage_planes"],
                      stage_blocks=cfg["stage_blocks"], **cfg["model_kwargs"])
    model.load_state_dict(params(cfg), strict=True)
    return model


def params(cfg):
    return weights.make_params(reference(cfg).param_specs(cfg), SEED,
                               "cpu", cfg["init"])


def images(cfg, batch=2):
    return weights.make_images(SEED, 1, batch, cfg["input_shape"], "cpu")[0]


def both(cfg, samples=S):
    """The port's and the reference's (S, 1, B, C) logits of one request."""
    model, x, ref_mod = port(cfg), images(cfg), reference(cfg)
    seeds = sample_seeds(REQUEST, samples, model.num_sites)
    with torch.inference_mode():
        got = sampler.mc_logits(model, x, seeds)
        ref = ref_mod.forward(
            params(cfg), x, common.sample_pairs(REQUEST, samples,
                                                ref_mod.num_sites(cfg)),
            cfg, common.Numerics())
    return got, ref


@pytest.mark.parametrize("model", MODELS)
def test_f32_port_equals_the_reference(model):
    """Stem, the blocks (16 bottlenecks or 8 basic blocks), three deferred
    sites (one samples launch, two on an x that carries S) and the MC head:
    f32 to rounding (the port and the reference sum the same products in
    another order)."""
    got, ref = both(config(model))
    assert got.shape == ref.shape == (S, 1, 2, 10)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _site_input(c, h, carries, seed=3):
    """(x, the per-sample list of it): one x for all samples, or S of them
    stacked as an x that carries the samples."""
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(2, c, h, h, generator=gen).contiguous(
        memory_format=torch.channels_last) for _ in range(S if carries
                                                          else 1)]
    return (stack_samples(xs) if carries else xs[0]), xs


def _reference_site_conv(cfg, conv, xs, carries, site):
    """The reference's conv of each sample's input masked from
    ``common.hash_bits`` (then zero-padded by k // 2), without epilogue."""
    pairs = common.sample_pairs(REQUEST, S, reference(cfg).num_sites(cfg))
    scale = resnet_blocks.site_scale(cfg)
    return torch.stack([common.conv(
        resnet_blocks.site_mask(xs[s if carries else 0], pairs[s, site],
                                cfg["mc_rate"], scale),
        conv.kernel, conv.stride, conv.kernel.shape[-1] // 2,
        common.Numerics()) for s in range(S)])


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("block,carries", [("layer2_0", False),
                                           ("layer3_0", True)])
def test_site_masks_are_exact(model, block, carries):
    """One deferred site's two masked convs (no epilogue: the bare f32
    conv) equal the reference's conv of the input masked from
    ``common.hash_bits``, sample by sample; stage 2's site takes one x for
    all samples, stage 3's an x that carries them (each sample's own
    rows)."""
    cfg = config(model)
    model = port(cfg)
    blk = getattr(model, block)
    c, h = blk.convbn1.conv.kernel.shape[1], SIZE // {"layer2_0": 4,
                                                       "layer3_0": 8}[block]
    x, xs = _site_input(c, h, carries)
    site = int(block[5]) - 2          # stage 2's site is the first
    seeds = sample_seeds(REQUEST, S, model.num_sites)[:, site]
    with torch.inference_mode():
        for conv in (blk.convbn1.conv, blk.downsample.conv):
            assert conv.site == site
            got = conv(x, seeds=seeds.contiguous())
            want = _reference_site_conv(cfg, conv, xs, carries, site)
            assert got.shape == want.shape
            # f32 sums of the same products in another order
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_bf16_model_within_the_cells_limits(model):
    """The bf16 model against the f32 reference stays within the limits
    the benchmark holds the card to (``perfbench/limits``): its activations
    and folded kernels round to bf16 at every layer (2^-8 of each), the
    reference keeps f32; the gap is that rounding, not zero."""
    got, ref = both(config(model, "bfloat16"), samples=10)
    limits = json.loads((ROOT / "perfbench/limits/"
                         f"{MODELS[model][0]}.predict_b128.json").read_text())
    pg, pr = common.predictive(got.float()), common.predictive(ref)
    gaps = {k + "_gap": float((pg[k] - pr[k]).abs().max()) for k in pg}
    assert gaps["probs_gap"] > 0
    for k, v in gaps.items():
        assert v <= limits[k], (k, v)


@pytest.mark.parametrize("size", [64, 65, 224])
def test_imagenet_stem_sizes_and_padded_pool(size):
    """The 7×7/2 conv padded by 3 and the 3×3/2 max pool padded by 1 each
    give ceil(H / 2) (224 → 112 → 56), and the pool equals
    ``F.max_pool2d(padding=1)``: the padding never wins, also where every
    input is negative."""
    planes = MODELS["resnet50"][2]
    model = get_model("resnet50", stem="imagenet", num_classes=10,
                      stage_planes=planes, input_shape=(size, size, 3))
    model.reset_parameters(torch.Generator().manual_seed(size))
    x = torch.randn(2, 3, size, size)
    with torch.inference_mode():
        y = model.stem(x, act="relu")
    half = (size + 1) // 2
    assert y.shape == (2, planes[0], half, half)
    for t in (y, y - 10.0):
        torch.testing.assert_close(max_pool(t, 3, 2, 1),
                                   F.max_pool2d(t, 3, 2, 1), rtol=0, atol=0)
    assert max_pool(y, 3, 2, 1).shape[-1] == (half + 1) // 2
    q = torch.randint(-128, 128, (2, 4, 9, 9), dtype=torch.int8)
    assert torch.equal(max_pool(q, 3, 2, 1),
                       F.max_pool2d(q.float(), 3, 2, 1).to(torch.int8))


@pytest.mark.parametrize("model,last", [("resnet50", "layer4_2"),
                                        ("resnet18", "layer4_1")])
def test_final_pool_is_global(model, last):
    """At 224 the last stage is 7×7: changing only its bottom-right 3×3
    pixels changes the logits (a min(4, H) pool reads the top-left 4×4
    alone)."""
    cfg = config(model, size=224)
    expansion = cfg["expansion"]
    model = port(cfg)
    x = images(cfg, batch=1)
    seeds = sample_seeds(REQUEST, 1, model.num_sites)
    with torch.inference_mode():
        base = model(x, seeds).logits

        def poke(module, args, out):
            assert out.shape[-2:] == (7, 7)
            out = out.clone()
            out[..., 4:, 4:] += 1.0
            return out

        hook = getattr(model, last).register_forward_hook(poke)
        try:
            moved = model(x, seeds).logits
        finally:
            hook.remove()
    assert model.linear.kernel.shape[0] == cfg["stage_planes"][-1] * (
        expansion)
    assert (moved - base).abs().max() > 1e-3


@pytest.mark.parametrize("model,windows", [("resnet50", 0), ("resnet18", 3)])
def test_counters_spans_and_timed_twin(model, windows):
    """A forward counts its six masked site convs and the S·N rows after
    the first site; under a profiler it records ``resnet.stem`` once,
    ``sites.conv`` a site and ``sites.window_conv`` a site whose
    ``convbn1`` is wider than 1×1 (ResNet-18's 3×3, none of ResNet-50's
    1×1); the served graph of a ResNet gets a timed twin."""
    cfg = config(model)
    model, x = port(cfg), images(cfg)
    seeds = sample_seeds(REQUEST, S, model.num_sites)
    assert _has_device_spans(model)
    profiler.reset_spans()
    try:
        with torch.inference_mode(), profile():
            model(x, seeds)
        assert profiler.counters() == {"sites.conv_launches": 6,
                                       "sites.rows": S * 2}
        names = [r.name for r in profiler.span_log()]
        assert names.count("resnet.stem") == 1
        assert names.count("sites.conv") == 3
        assert names.count("sites.window_conv") == windows
    finally:
        profiler.reset_spans()


def test_unknown_stem_is_refused():
    with pytest.raises(ValueError, match="stem"):
        get_model("resnet50", stem="tpu")


def _window_site(side: int, carries: bool):
    """ResNet-18's first site conv (3×3, stride 2, padded by 1) with a
    32-channel input of ``side``², the seeds of its site, and that
    input."""
    cfg = config("resnet18")
    conv = port(cfg).layer2_0.convbn1.conv
    assert tuple(conv.kernel.shape[-2:]) == (3, 3) and conv.stride == 2
    x, xs = _site_input(conv.kernel.shape[1], side, carries, seed=side)
    seeds = sample_seeds(REQUEST, S, 4)[:, 0].contiguous()
    return cfg, conv, x, xs, seeds


@pytest.mark.parametrize("side", [15, 16])
@pytest.mark.parametrize("carries", [False, True])
def test_window_site_conv_equals_the_reference(side, carries):
    """The 3×3 stride-2 masked conv of a ResNet-18 site, at an odd and an
    even input side (ceil(side / 2) outputs: at 15 the last window's
    bottom-right taps fall on the padding), from one x and from an x that
    carries the samples, equals the reference's conv of each sample's
    masked input."""
    cfg, conv, x, xs, seeds = _window_site(side, carries)
    with torch.inference_mode():
        got = conv(x, seeds=seeds)
    want = _reference_site_conv(cfg, conv, xs, carries, 0)
    assert got.shape == want.shape == (S, 2, 48, (side + 1) // 2,
                                       (side + 1) // 2)
    # f32 sums of the same products in another order
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("side", [15, 16])
def test_window_site_padding_is_never_masked(side):
    """The mask is hashed on the real input positions (row n·H·W + h·W +
    w) and the zero padding is added after it: the conv equals the
    unpadded conv of the masked input padded by 1, and differs from the
    conv of an input whose padding took part in the hash (the rows of the
    padded side, which shift every real position's mask)."""
    cfg, conv, x, xs, seeds = _window_site(side, False)
    pairs = common.sample_pairs(REQUEST, S, 4)
    scale = resnet_blocks.site_scale(cfg)
    with torch.inference_mode():
        got = conv(x, seeds=seeds)

    def mask(y, s):
        return resnet_blocks.site_mask(y, pairs[s, 0], cfg["mc_rate"], scale)

    def unpadded_conv(y):
        return common.conv(y, conv.kernel, 2, 0, common.Numerics())

    for s in range(S):
        pad_after = unpadded_conv(F.pad(mask(xs[0], s), (1, 1, 1, 1)))
        pad_hashed = unpadded_conv(mask(F.pad(xs[0], (1, 1, 1, 1)), s))
        # f32 sums of the same products in another order
        torch.testing.assert_close(got[s], pad_after, rtol=1e-6, atol=1e-6)
        assert (got[s] - pad_hashed).abs().max() > 0.1


def test_window_conv_span_nests_in_the_site_span():
    """Under a profiler a ResNet-18 forward records ``sites.window_conv``
    once a site, each inside that site's ``sites.conv``."""
    cfg = config("resnet18")
    model, x = port(cfg), images(cfg)
    seeds = sample_seeds(REQUEST, S, model.num_sites)
    profiler.reset_spans()
    try:
        with torch.inference_mode(), profile():
            model(x, seeds)
        log = profiler.span_log()
        by_id = {r.id: r for r in log}
        windows = [r for r in log if r.name == "sites.window_conv"]
        assert len(windows) == 3
        assert all(by_id[r.parent].name == "sites.conv" for r in windows)
        assert len({r.parent for r in windows}) == 3
    finally:
        profiler.reset_spans()
