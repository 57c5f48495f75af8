"""The block-site ResNet-50's shapes and the work counted from them
(``perfbench.work_blocks``)."""

import json
import math

import pytest

from conftest import ROOT
from perfbench import work, work_blocks
from perfbench.reference import resnet_blocks


def config():
    return json.loads((ROOT / "perfbench/configs/resnet50_blocks_bf16.json")
                      .read_text())


def test_resnet50_published_size():
    """Table 1's 50-layer column: 4.09 G multiply-adds an image (53 convs
    and the 2048 × 1000 classifier), 25.6 M parameters."""
    cfg = config()
    shapes = resnet_blocks.layer_shapes(cfg)
    assert sum(s["op"] == "conv" for s in shapes) == 53
    macs = sum(work.layer_ops(s) // 2 for s in shapes)
    assert macs == 4_089_184_256
    weights = sum(math.prod(shape) for _, shape, kind, _
                  in resnet_blocks.param_specs(cfg)
                  if kind in ("kernel", "head", "bias", "bn_scale", "bn_bias"))
    assert weights == 25_557_032


def test_sampled_ops_run_the_carried_layers_s_times():
    shapes = resnet_blocks.layer_shapes(config())
    once = sum(work.layer_ops(s) for s in shapes if not s["carried"])
    each = sum(work.layer_ops(s) for s in shapes if s["carried"])
    assert once == 2 * 785_956_864 and each == 2 * 3_303_227_392
    assert work_blocks.sampled_ops(shapes, 128, 10) == 128 * (
        once + 10 * each)


def test_site_convs_and_their_bound():
    """Six masked 1×1 convs, two a site; stage 2's reads one x for the S
    samples, stages 3–4 read an x that carries them. Each writes S bf16
    outputs, which its bytes, not its operations, bound."""
    shapes = resnet_blocks.layer_shapes(config())
    sites = [s for s in shapes if s.get("site")]
    assert [s["name"] for s in sites] == [
        f"layer{i}_0.{c}" for i in (2, 3, 4)
        for c in ("convbn1", "downsample")]
    assert [s["x_carries"] for s in sites] == [False] * 2 + [True] * 4
    conv = sites[0]          # 56² × 256 → 128, stride 1
    nbytes = 128 * 3136 * 256 * 2 + 256 * 128 * 2 + 10 * 128 * 3136 * 128 * 2
    assert work_blocks.site_conv_bound_s(conv, 128, 10, "bfloat16") == (
        pytest.approx(nbytes / work.PEAK_BYTES))
    total = work_blocks.site_convs_bound_s(shapes, 128, 10, "bfloat16")
    assert total == pytest.approx(sum(work_blocks.site_conv_bound_s(
        s, 128, 10, "bfloat16") for s in sites))
    assert 1.9e-3 < total < 2e-3           # 1.95 ms a request


@pytest.mark.parametrize("name,site", [
    ("void (anonymous namespace)::conv_mma_kernel<__nv_bfloat16, "
     "__nv_bfloat16, (anonymous namespace)::HashMask<__nv_bfloat16> >", True),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     False)])
def test_site_kernel(name, site):
    assert work_blocks.is_site_kernel(name) is site
