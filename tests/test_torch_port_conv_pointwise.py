"""Row 10's 1x1 routine (``conv_mma_kernel_1x1`` of
``bayestpu_torch/csrc/masked_conv.cu``) on the card, against the plain
versions that ``tests/test_torch_port_conv.py`` holds against the JAX
package on the CPU.

The file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and without JAX, where the repository's conftest
(which configures JAX) is left out:

    python -m pytest tests/test_torch_port_conv_pointwise.py --noconftest -q

Every test needs a card: it decides inside the test, through the ``card``
fixture, and skips without one.

Tolerances: masks bit for bit (the readout ``conv(ones, 1x1 identity)``
reads each kept element as the bf16 scale); sample s of a samples or _xs
launch bit-equal to the single launch with seeds[s]; an f32 store within
CONV_RTOL of max|ref| against the plain version's f32 conv (TF32 off: the
products are exact on both sides, the f32 sums run in other orders); a bf16
store one bf16 ulp (BF16_RTOL), where an f32 sum a few ulps away rounds to
the neighbouring bf16 value.
"""

import pytest
import torch

from bayestpu_torch.kernels import masked_conv as tmc
from bayestpu_torch.kernels import masked_matmul as tmm
from bayestpu_torch.utils import profiler

from port_threads import thread_budget  # noqa: F401

RATE = 0.25
BF16_RTOL = 2.0 ** -8
CONV_RTOL = 3e-5
S = 3
# x NHWC, F, stride: C not a multiple of 64 (40, 72), F not a multiple of
# the 128-channel tile (200, 1000, 10), N·Ho·Wo not a multiple of the
# 64-pixel tile (odd H at stride 1, odd W; at stride 2 an item is R =
# 64 / Wo output rows, across images), C over 512 (one A buffer) and at
# 1024, the routine's largest
GEOMS = {
    "c40_f200_s1": ((2, 8, 8, 40), 200, 1),
    "c72_f1000_s2": ((3, 6, 6, 72), 1000, 2),
    "c64_f130_s2_odd_w": ((3, 8, 9, 64), 130, 2),
    "c64_f72_s1_odd": ((3, 7, 9, 64), 72, 1),
    "c48_f10_s2": ((3, 6, 6, 48), 10, 2),
    "c256_f256_s1": ((5, 11, 13, 256), 256, 1),
    "c520_f136_s2": ((2, 10, 9, 520), 136, 2),
    "c1024_f264_s1": ((1, 6, 10, 1024), 264, 1),
    "c128_f64_s2_wide": ((2, 30, 100, 128), 64, 2),
}
SEEDS = [[-123456789, -7], [5, 99], [2 ** 31 - 1, 0]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = prev


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _data(name: str, dev):
    (n, h, w, c), f, stride = GEOMS[name]
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    x = _cl(torch.randn(n, c, h, w, generator=gen).to(torch.bfloat16))
    wt = (torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5).to(
        torch.bfloat16)
    bias = torch.randn(f, generator=gen) * 0.3
    xs = torch.randn(S, n, c, h, w, generator=gen).to(torch.bfloat16)
    xs = xs.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    return (x.to(dev), wt.to(dev), bias.to(dev), xs.to(dev), seeds.to(dev),
            stride)


def _close(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype
    assert err <= rtol * max(1.0, want.float().abs().max().item()), err


def _launches() -> int:
    return profiler.counters().get("conv.pointwise_launches", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", list(GEOMS))
def test_pointwise_launches_equal_plain_and_single(card, name):
    """Samples, _xs and single launches of the 1x1 routine: sample s
    bit-equal to the single launch with seeds[s] (on x[s] for _xs); each
    within one bf16 ulp (the served epilogue: bias, relu, bf16 store) or
    CONV_RTOL (no epilogue, f32 store) of the plain version; every launch
    takes the 1x1 routine."""
    x, w, bias, xs, seeds, stride = _data(name, card)
    before = _launches()
    for epi, rtol in ((dict(bias=bias, act="relu",
                            out_dtype=torch.bfloat16), BF16_RTOL),
                      (dict(), CONV_RTOL)):
        geo = dict(stride=stride, **epi)
        ys = tmc.dropout_conv_samples(x, w, seeds, RATE, **geo)
        yx = tmc.dropout_conv_inference(xs, w, seeds, RATE, **geo)
        for s in range(S):
            sd = seeds[s].contiguous()
            assert torch.equal(ys[s], tmc.dropout_conv_inference(
                x, w, sd, RATE, **geo))
            assert torch.equal(yx[s], tmc.dropout_conv_inference(
                xs[s], w, sd, RATE, **geo))
            _close(ys[s], tmc.dropout_conv_plain(
                x, w, sd, RATE, "SAME", stride, **epi), rtol)
            _close(yx[s], tmc.dropout_conv_plain(
                xs[s], w, sd, RATE, "SAME", stride, **epi), rtol)
    torch.cuda.synchronize()
    assert _launches() - before == 2 * (2 + 2 * S)


@pytest.mark.card
@pytest.mark.parametrize("row0", [0, 2 ** 31 + 4096, 2 ** 32 - 40])
@pytest.mark.parametrize("stride", [1, 2])
def test_pointwise_mask_readout_is_exact(card, stride, row0):
    """x = ones, w = a 1x1 identity: sample s reads the mask of seeds[s]
    at the pixels the conv reads, each kept element as the bf16 scale, bit
    for bit the plain version's (and so JAX's), at row0 0 and past
    2^31 (the hash row wraps at 2^32)."""
    n, c, h, wd = 3, 40, 8, 7
    ones = _cl(torch.ones(n, c, h, wd, dtype=torch.bfloat16, device=card))
    eye = torch.eye(c, dtype=torch.bfloat16, device=card)[:, :, None, None]
    seeds = torch.tensor(SEEDS, dtype=torch.int32, device=card)
    before = _launches()
    got = tmc.dropout_conv_samples(ones, eye, seeds, RATE, "VALID",
                                   stride=stride, row0=row0)
    want = tmc.stack_samples([tmc.dropout_conv_plain(
        ones, eye, seeds[s], RATE, "VALID", stride, row0=row0)
        for s in range(S)])
    assert _launches() - before == 1
    assert torch.equal(got, want)
    keep = torch.stack([tmc.keep_mask_nchw(
        seeds[s], ones, RATE, row0)[:, :, ::stride, ::stride]
        for s in range(S)])
    assert torch.equal(got != 0, keep)
    assert sorted(set(got.unique().tolist())) == [
        0.0, tmm.scale_of(RATE, torch.bfloat16)]


def _kernels(fn) -> set:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "conv_mma_kernel" in e.key}


@pytest.mark.card
def test_only_pointwise_shapes_take_the_routine(card):
    """The profiler's kernel names and the counter: a bf16 MC 1x1 conv with
    no padding runs ``conv_mma_kernel_1x1``; a mask-free bf16 1x1
    (``conv_fused``), a 3x3 bf16 conv, an explicitly padded 1x1, a 1x1 with
    C not a multiple of 8, a stride-2 1x1 with H odd, an f32 1x1 and an
    int8 1x1 run ``conv_mma_kernel``."""
    x, w, bias, _, seeds, _ = _data("c40_f200_s1", card)
    sd = seeds[0].contiguous()
    w3 = torch.randn(16, 40, 3, 3, device=card).to(torch.bfloat16)
    xq = x.to(torch.int8)
    wq = w.to(torch.int8)
    runs = {
        "1x1": (lambda: tmc.dropout_conv_samples(x, w, seeds, RATE), True),
        "conv_fused_1x1": (lambda: tmc.conv_fused(x, w, bias), False),
        "3x3": (lambda: tmc.dropout_conv_samples(x, w3, seeds, RATE), False),
        "1x1_padded": (lambda: tmc.dropout_conv_inference(
            x, w, sd, RATE, ((0, 1), (0, 1))), False),
        "1x1_c36": (lambda: tmc.dropout_conv_inference(
            x[:, :36].contiguous(memory_format=torch.channels_last),
            w[:, :36].contiguous(), sd, RATE), False),
        "1x1_s2_odd_h": (lambda: tmc.dropout_conv_inference(
            x[:, :, :7].contiguous(memory_format=torch.channels_last), w,
            sd, RATE, stride=2), False),
        "1x1_f32": (lambda: tmc.dropout_conv_inference(
            x.float(), w.float(), sd, RATE), False),
        "1x1_int8": (lambda: tmc.dropout_conv_int8(
            xq, wq, sd, RATE, 2.0 ** -7, 2.0 ** -7), False),
    }
    for name, (fn, pointwise) in runs.items():
        before = _launches()
        names = _kernels(fn)
        assert _launches() - before == int(pointwise), name
        assert names, name
        assert all(("conv_mma_kernel_1x1" in k) == pointwise
                   for k in names), (name, names)
