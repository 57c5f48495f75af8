"""The block-site ResNet-18's shapes, the work counted from them
(``perfbench.work_blocks``) and the kernel its window roofline reads."""

import importlib.util
import json
import math

import pytest

from conftest import ROOT
from perfbench import work, work_blocks
from perfbench.reference import resnet18_blocks


def config():
    return json.loads((ROOT / "perfbench/configs/resnet18_blocks_bf16.json")
                      .read_text())


def metric_module(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resnet18_published_size():
    """Table 1's 18-layer column: 1.81 G multiply-adds an image (20 convs
    and the 512 × 1000 classifier), 11.7 M parameters."""
    cfg = config()
    shapes = resnet18_blocks.layer_shapes(cfg)
    assert sum(s["op"] == "conv" for s in shapes) == 20
    macs = sum(work.layer_ops(s) // 2 for s in shapes)
    assert macs == 1_814_073_344
    weights = sum(math.prod(shape) for _, shape, kind, _
                  in resnet18_blocks.param_specs(cfg)
                  if kind in ("kernel", "head", "bias", "bn_scale", "bn_bias"))
    assert weights == 11_689_512


def test_sampled_ops_run_the_carried_layers_s_times():
    """The stem and stage 1 once, stages 2–4 and the head S times."""
    shapes = resnet18_blocks.layer_shapes(config())
    assert work_blocks.sampled_ops(shapes, 128, 10) == 128 * (
        2 * 580_435_968) + 1_280 * (2 * 1_233_637_376)


def test_site_convs_and_the_window_bound():
    """Six masked convs, two a site: the 3×3 stride-2 ``convbn1`` and the
    1×1 stride-2 ``downsample``; stage 2's read one x for the S samples,
    stages 3–4 an x that carries them. The three 3×3 convs are
    compute-bound: 2·S·N·Cin·Cout·9 a output pixel at the bf16 peak, 0.150
    ms each."""
    shapes = resnet18_blocks.layer_shapes(config())
    sites = [s for s in shapes if s.get("site")]
    assert [s["name"] for s in sites] == [
        f"layer{i}_0.{c}" for i in (2, 3, 4)
        for c in ("convbn1", "downsample")]
    assert [s["x_carries"] for s in sites] == [False] * 2 + [True] * 4
    assert [(s["k"], s["hin"]) for s in sites] == [
        (3, 56), (1, 56), (3, 28), (1, 28), (3, 14), (1, 14)]
    windows = [s for s in sites if s["k"] > 1]
    for conv in windows:
        ops = 2 * 10 * 128 * conv["pixels"] * conv["cin"] * conv["cout"] * 9
        assert work_blocks.site_conv_bound_s(conv, 128, 10, "bfloat16") == (
            pytest.approx(ops / work.PEAK_OPS["bfloat16"]))
    bound = sum(work_blocks.site_conv_bound_s(s, 128, 10, "bfloat16")
                for s in windows)
    assert 0.448e-3 < bound < 0.450e-3           # 0.449 ms a request


@pytest.mark.parametrize("name,window", [
    ("void (anonymous namespace)::conv_mma_kernel<__nv_bfloat16, "
     "__nv_bfloat16, (anonymous namespace)::HashMask<__nv_bfloat16> >", True),
    ("void (anonymous namespace)::conv_mma_kernel_1x1<(anonymous "
     "namespace)::HashMask<__nv_bfloat16> >", False),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     False),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>",
     False)])
def test_window_roofline_reads_the_windowed_routine(name, window):
    mod = metric_module("site_window_roofline.predict")
    assert mod.is_window_kernel(name) is window


def test_window_roofline_reading():
    """The three 3×3 site convs' bound over the windowed routine's device
    time a traced request; nothing to read without that kernel in the
    trace or without a windowed site in the shapes (ResNet-50's)."""
    from types import SimpleNamespace

    from perfbench import trace
    from perfbench.reference import resnet_blocks

    read = metric_module("site_window_roofline.predict").read
    conv = "void conv_mma_kernel<__nv_bfloat16, __nv_bfloat16, HashMask>"
    kernels = [(conv, 0.0, 2e-3),
               ("conv_mma_kernel_1x1<HashMask>", 0.0, 1.0),
               ("sm90_xmma_fprop_implicit_gemm", 0.0, 1.0),
               (conv, 0.0, 2e-3)]

    def run(shapes, ks):
        rec = SimpleNamespace(kind="predict", batch=128, samples=10,
                              trace=trace.Trace(1.0, 1.0, 2, ks))
        return SimpleNamespace(record=rec, shapes=shapes,
                               cell=SimpleNamespace(compute="bfloat16"))

    shapes = resnet18_blocks.layer_shapes(config())
    bound = sum(work_blocks.site_conv_bound_s(s, 128, 10, "bfloat16")
                for s in shapes if s.get("site") and s["k"] > 1)
    assert read(run(shapes, kernels)) == pytest.approx(
        100.0 * bound * 2 / 4e-3)
    assert read(run(shapes, kernels[1:3])) is None
    r50 = json.loads((ROOT / "perfbench/configs/resnet50_blocks_bf16.json")
                     .read_text())
    assert read(run(resnet_blocks.layer_shapes(r50), kernels)) is None


def test_config_is_its_own_source():
    """A configuration is new only if its source or its cuts differ from
    every other's: resnet18's source names the 18-layer network alone, not
    the paper that resnet50 cites too, and the entry and the file agree."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "resnet18_blocks_bf16")
    assert entry["source"] == config()["source"]
    assert all((c["source"], c["reduced"]) != (entry["source"], entry["reduced"])
               for c in bench["configs"] if c is not entry)
