"""Operations and bytes from shapes, and the kernel-name groups."""

import json

import pytest

from conftest import ROOT
from perfbench import work
from perfbench.reference import resnet_me, vgg_me


def config(name):
    return json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())


def test_vgg11_eight_convs():
    shapes = vgg_me.layer_shapes(config("vgg11_me_bf16"))
    assert work.conv_macs(shapes, "block") == 152_764_416


def test_predict_and_train_ops():
    shapes = vgg_me.layer_shapes(config("vgg11_me_bf16"))
    once = sum(work.layer_ops(s) for s in shapes if s["op"] != "head")
    heads = [s for s in shapes if s["op"] == "head"]
    assert len(heads) == 5 and all((h["k"], h["n"]) == (512, 10)
                                   for h in heads)
    assert work.predict_ops(shapes, 128, 10) == 128 * (
        once + 10 * 5 * 2 * 512 * 10)
    assert work.train_ops(shapes, 4) == 3 * 4 * (once + 5 * 2 * 512 * 10)


def test_resnet18_macs():
    shapes = resnet_me.layer_shapes(config("resnet18_me_int8"))
    # ResNet-18 with the CIFAR stem: 0.555 G multiply-adds an image
    assert work.conv_macs(shapes, "stem") + work.conv_macs(
        shapes, "layer") == 555_417_600
    assert [(h["k"], h["n"]) for h in shapes if h["op"] == "head"] == [
        (512, 100)] * 4


def test_head_bound():
    head = {"k": 512, "n": 10}
    nbytes = 128 * 512 * 2 + 512 * 10 * 2 + 40 + 4 * 10 * 128 * 10
    assert work.head_bound_s(head, 128, 10, "bfloat16") == pytest.approx(
        nbytes / 3.35e12)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::chain_samples_kernel<HashChain<bf16>>",
     "port"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc", "library"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64>",
     "library"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>",
     "elementwise"),
    ("void at::native::reduce_kernel<128, 4, ReduceOp<float>>",
     "elementwise")])
def test_kernel_group(name, group):
    assert work.kernel_group(name) == group
