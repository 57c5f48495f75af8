"""``resnet50`` with the ImageNet stem and MC block sites
(``get_model("resnet50", stem="imagenet", dropout="block", n_exits=1,
fused=True)``) against the benchmark's plain reference
(``perfbench.reference.resnet_blocks``), on the CPU.

The JAX package has no ImageNet stem, so the reference written from the
published model (He et al., Table 1; v1.5 strides) is the yardstick here.
Every case runs the published block counts [3, 4, 6, 3] at planes (8, 16,
32, 64) and 64×64 inputs on seeded random weights: planes of 8 put 32
channels on the first site's input, the fewest a fused masked conv takes
(``MASKED_CONV_FUSE_MIN_CH``), so every site runs the masked conv of the
card's path (its plain version here).
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
from perfbench.reference import common, resnet_blocks  # noqa: E402

PLANES = [8, 16, 32, 64]
SIZE = 64
SEED = 2 ** 31 + 17
REQUEST = 77
S = 3


def config(dtype="float32", size=SIZE, classes=10, **kw):
    """The benchmark's configuration at the small size."""
    cfg = json.loads((ROOT / "perfbench/configs/resnet50_blocks_bf16.json")
                     .read_text())
    return dict(cfg, stage_planes=PLANES, input_shape=[size, size, 3],
                num_classes=classes, dtype=dtype, **kw)


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
    return weights.make_params(resnet_blocks.param_specs(cfg), SEED, "cpu",
                               cfg["init"])


def images(cfg, batch=2):
    return weights.make_images(SEED, 1, batch, cfg["input_shape"], "cpu")[0]


def both(cfg, samples=S):
    """The port's and the reference's (S, 1, B, C) logits of one request."""
    model, x = port(cfg), images(cfg)
    seeds = sample_seeds(REQUEST, samples, model.num_sites)
    with torch.inference_mode():
        got = sampler.mc_logits(model, x, seeds)
        ref = resnet_blocks.forward(
            params(cfg), x, common.sample_pairs(REQUEST, samples,
                                                resnet_blocks.num_sites(cfg)),
            cfg, common.Numerics())
    return got, ref


def test_f32_port_equals_the_reference():
    """Stem, 16 bottlenecks, three deferred sites (one samples launch, two
    on an x that carries S) and the MC head: f32 to rounding."""
    got, ref = both(config())
    assert got.shape == ref.shape == (S, 1, 2, 10)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block,carries", [("layer2_0", False),
                                           ("layer3_0", True)])
def test_site_masks_are_exact(block, carries):
    """One deferred site's two masked convs (no epilogue: the bare f32
    conv) equal the reference's conv of the input masked from
    ``common.hash_bits``, sample by sample; stage 2's site takes one x for
    all samples, stage 3's an x that carries them (each sample's own
    rows)."""
    cfg = config()
    model = port(cfg)
    blk = getattr(model, block)
    c, h = blk.convbn1.conv.kernel.shape[1], SIZE // {"layer2_0": 4,
                                                       "layer3_0": 8}[block]
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(2, c, h, h, generator=gen).contiguous(
        memory_format=torch.channels_last) for _ in range(S if carries
                                                          else 1)]
    x = stack_samples(xs) if carries else xs[0]
    site = int(block[5]) - 2          # stage 2's site is the first
    pairs = common.sample_pairs(REQUEST, S, resnet_blocks.num_sites(cfg))
    seeds = sample_seeds(REQUEST, S, model.num_sites)[:, site]
    scale = resnet_blocks.site_scale(cfg)
    with torch.inference_mode():
        for conv, stride in ((blk.convbn1.conv, 1), (blk.downsample.conv, 2)):
            assert conv.site == site
            got = conv(x, seeds=seeds.contiguous())
            want = torch.stack([common.conv(
                resnet_blocks.site_mask(xs[s if carries else 0], pairs[s, site],
                                        cfg["mc_rate"], scale),
                conv.kernel, stride, 0, common.Numerics())
                for s in range(S)])
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_bf16_model_within_the_cells_limits():
    """The bf16 model against the f32 reference stays within the limits
    the benchmark holds the card to (``perfbench/limits``): its activations
    and folded kernels round to bf16 at every layer (2^-8 of each), the
    reference keeps f32; the gap is that rounding, not zero."""
    got, ref = both(config("bfloat16"), samples=10)
    limits = json.loads((ROOT / "perfbench/limits/"
                         "resnet50_blocks_bf16.predict_b128.json").read_text())
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
    model = get_model("resnet50", stem="imagenet", num_classes=10,
                      stage_planes=PLANES, input_shape=(size, size, 3))
    model.reset_parameters(torch.Generator().manual_seed(size))
    x = torch.randn(2, 3, size, size)
    with torch.inference_mode():
        y = model.stem(x, act="relu")
    half = (size + 1) // 2
    assert y.shape == (2, PLANES[0], half, half)
    for t in (y, y - 10.0):
        torch.testing.assert_close(max_pool(t, 3, 2, 1),
                                   F.max_pool2d(t, 3, 2, 1), rtol=0, atol=0)
    assert max_pool(y, 3, 2, 1).shape[-1] == (half + 1) // 2
    q = torch.randint(-128, 128, (2, 4, 9, 9), dtype=torch.int8)
    assert torch.equal(max_pool(q, 3, 2, 1),
                       F.max_pool2d(q.float(), 3, 2, 1).to(torch.int8))


def test_final_pool_is_global():
    """At 224 the last stage is 7×7: changing only its bottom-right 3×3
    pixels changes the logits (a min(4, H) pool reads the top-left 4×4
    alone)."""
    cfg = config(size=224)
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

        hook = model.layer4_2.register_forward_hook(poke)
        try:
            moved = model(x, seeds).logits
        finally:
            hook.remove()
    assert model.linear.kernel.shape[0] == PLANES[-1] * 4
    assert (moved - base).abs().max() > 1e-3


def test_counters_spans_and_timed_twin():
    """A forward counts its six masked site convs and the S·N rows after
    the first site; under a profiler it records ``resnet.stem`` once and
    ``sites.conv`` a site; the served graph of a ResNet gets a timed
    twin."""
    cfg = config()
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
    finally:
        profiler.reset_spans()


def test_unknown_stem_is_refused():
    with pytest.raises(ValueError, match="stem"):
        get_model("resnet50", stem="tpu")
