"""Row 10's window routine (``window::conv_mma_kernel`` of
``bayestpu_torch/csrc/masked_conv.cu``): the bf16 MC conv with a 3x3
window at stride 2.

The CPU tests hold the routine's route (``takes_window``), its plan of
output rows an item (``window_rows``) and its mask evaluations
(``mask_hashes``) against tables and brute-force counts. The card tests
hold its launches against the plain versions that
``tests/test_torch_port_conv.py`` holds against the JAX package on the
CPU. The file imports neither JAX nor the JAX package, so that it runs on
a machine with a card and without JAX, where the repository's conftest
(which configures JAX) is left out:

    python -m pytest tests/test_torch_port_conv_window.py --noconftest -q

Each card test needs a card: it decides inside the test, through the
``card`` fixture, and skips without one.

Tolerances: masks bit for bit (the readout ``conv(ones, one tap's
identity)`` reads each kept element as the bf16 scale); sample s of a
samples or _xs launch bit-equal to the single launch with seeds[s]; an f32
store within CONV_RTOL of max|ref| against the plain version's f32 conv
(TF32 off: the products are exact on both sides, the f32 sums run in other
orders); a bf16 store within BF16_OUT_RTOL, two bf16 ulps, as
``chip_smoke.py`` holds every bf16 conv store (an f32 sum a few ulps away
rounds to a neighbouring bf16 value, and relu's input may sit on either
side of a rounding boundary).
"""

import itertools

import pytest
import torch

from bayestpu_torch.kernels import masked_conv as tmc
from bayestpu_torch.kernels import masked_matmul as tmm
from bayestpu_torch.utils import profiler

from port_threads import thread_budget  # noqa: F401

RATE = 0.25
BF16_OUT_RTOL = 2.0 ** -7
CONV_RTOL = 3e-5
S = 3
P1 = ((1, 1), (1, 1))       # torch's padding=1, as resnet18's convbn1
# x NHWC, F: the three ImageNet block-site shapes of resnet18 (row 10I),
# the three CIFAR ones (row 10r), at a small batch; then ragged ones: F
# off the 128-channel tile, odd H and W (items across images, a short last
# item), one output column, C at 1024
GEOMS = {
    "imagenet_56x64_f128": ((3, 56, 56, 64), 128),
    "imagenet_28x128_f256": ((3, 28, 28, 128), 256),
    "imagenet_14x256_f512": ((3, 14, 14, 256), 512),
    "cifar_32x64_f128": ((3, 32, 32, 64), 128),
    "cifar_16x128_f256": ((3, 16, 16, 128), 256),
    "cifar_8x256_f512": ((3, 8, 8, 256), 512),
    "odd_15x17x64_f72": ((5, 15, 17, 64), 72),
    "odd_9x5x192_f200": ((3, 9, 5, 192), 200),
    "one_col_7x2x64_f10": ((4, 7, 2, 64), 10),
    "c1024_6x6_f136": ((2, 6, 6, 1024), 136),
}
SEEDS = [[-123456789, -7], [5, 99], [2 ** 31 - 1, 0]]


# ---------------------------------------------------------- CPU: the route


def _takes(entry="masked_conv", shape=(2, 64, 8, 8), k=3, padding="SAME",
           stride=2, xdt=torch.bfloat16, wdt=torch.bfloat16, hashed=True,
           carries=0):
    n, c, h, w = shape
    x = torch.zeros(n, c, h, w, dtype=xdt).contiguous(
        memory_format=torch.channels_last)
    if carries:
        x = torch.zeros(carries, n, h, w, c, dtype=xdt).permute(
            0, 1, 4, 2, 3)
    wt = torch.zeros(8, c, k, k, dtype=wdt)
    g = tmc.geometry(h, w, k, k, padding, stride)
    return tmc.takes_window(entry, x, wt, g, stride, hashed)


ROUTES = {
    # (arguments of _takes, whether the window routine takes the conv)
    "resnet18_stage2_p1": (dict(shape=(128, 64, 56, 56), padding=P1), True),
    "resnet18_stage3_xs": (dict(entry="masked_conv_xs",
                                shape=(128, 128, 28, 28), padding=P1,
                                carries=10), True),
    "resnet18_stage4_same": (dict(shape=(128, 256, 14, 14)), True),
    "cifar_8x8x256": (dict(shape=(128, 256, 8, 8), padding=P1), True),
    "odd_sides": (dict(shape=(5, 64, 15, 17), padding=P1), True),
    "pad_top_only": (dict(padding=((1, 0), (0, 1))), True),
    "c1024": (dict(shape=(2, 1024, 6, 6)), True),
    "stride1": (dict(stride=1), False),
    "pad2": (dict(padding=((2, 2), (2, 2))), False),
    "c40": (dict(shape=(2, 40, 8, 8)), False),
    "c96": (dict(shape=(2, 96, 8, 8)), False),
    "c1088": (dict(shape=(2, 1088, 8, 8)), False),
    "wide_wo128": (dict(shape=(1, 64, 4, 256)), False),
    "one_by_one": (dict(k=1), False),
    "f32_x": (dict(xdt=torch.float32), False),
    "f32_w": (dict(wdt=torch.float32), False),
    "mask_free": (dict(hashed=False), False),
    "int8": (dict(entry="masked_conv_int8", xdt=torch.int8,
                  wdt=torch.int8), False),
    "bank": (dict(entry="bank_conv_samples"), False),
    "over_2e31_pixels": (dict(entry="masked_conv_xs",
                              shape=(1024, 64, 512, 512), carries=8),
                         False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_window_route_follows_the_shape_and_dtypes(case):
    """``takes_window`` mirrors ``takes_window`` of masked_conv.cu: an MC
    conv of bf16 x and w with a 3x3 window at stride 2, a top and left pad
    of 0 or 1, C a multiple of 64 up to 1024, at most 127 output columns
    and under 2^31 input pixels takes the window routine; stride 1, a
    larger pad, C off the multiple of 64 or over 1024, a 1x1 window, an f32
    operand, a mask-free conv, int8 and every bank conv do not."""
    kwargs, want = ROUTES[case]
    if case == "over_2e31_pixels":
        # the predicate reads x's shape and pointer only: a view of one
        # element broadcast to the shape stands for the 4 GiB tensor
        s, (n, c, h, w) = kwargs["carries"], kwargs["shape"]
        x = torch.zeros(1, dtype=torch.bfloat16).expand(
            s * n * h * w * c).view(s, n, h, w, c).permute(0, 1, 4, 2, 3)
        g = tmc.geometry(h, w, 3, 3, "SAME", 2)
        wt = torch.zeros(8, c, 3, 3, dtype=torch.bfloat16)
        assert tmc.takes_window("masked_conv_xs", x, wt, g, 2, True) == want
        return
    assert _takes(**kwargs) == want


@pytest.mark.parametrize("shape,rows", [
    ((128, 64, 28, 28), 4), ((128, 128, 14, 14), 4), ((128, 256, 7, 7), 8),
    ((128, 64, 16, 16), 4), ((128, 128, 8, 8), 8), ((128, 256, 4, 4), 8),
    ((2, 1024, 3, 3), 1), ((1, 64, 1, 100), 1)])
def test_window_rows_fill_the_m_tiles(shape, rows):
    """``window_rows`` (``window_plan``): resnet18's ImageNet sites take 4,
    4 and 8 output rows an item (112, 56 and 56 pixels: 7/8 of their 64-row
    M tiles; two bands of 72 and 80 KiB, one of 144 KiB beside the ring,
    where two do not fit), its CIFAR sites 4, 8 and 8 (64, 64 and 32
    pixels); at C = 1024 and 3x3 outputs one band of three 32 KiB slots
    fits, one output row an item, and one output row of 100 pixels fits
    alone."""
    n, c, ho, wo = shape
    assert tmc.window_rows(n, c, ho, wo) == rows


# ------------------------------------------- CPU: the mask evaluations


def _brute_inputs(n, h, w, ho, wo, pt, pl, r):
    """Input positions (image, row, column) inside x that the items of r
    output rows read, counted once for each item that reads them."""
    total = 0
    rows = n * ho
    for q0 in range(0, rows, r):
        seen = set()
        for q in range(q0, min(q0 + r, rows)):
            img, oh = divmod(q, ho)
            for ow, kh, kw in itertools.product(range(wo), range(3),
                                                range(3)):
                ih, iw = 2 * oh - pt + kh, 2 * ow - pl + kw
                if 0 <= ih < h and 0 <= iw < w:
                    seen.add((img, ih, iw))
        total += len(seen)
    return total


@pytest.mark.parametrize("shape,padding", [
    ((3, 9, 8, 64), P1), ((3, 9, 8, 64), "SAME"), ((5, 15, 17, 64), P1),
    ((4, 7, 2, 64), "SAME"), ((2, 12, 12, 128), ((0, 1), (1, 0))),
    ((3, 28, 28, 128), P1)])
def test_window_mask_hashes_count_each_item_once(shape, padding):
    """``mask_hashes`` of the window routine against a brute-force count:
    each item masks every input element its outputs' windows read, once a
    sample, whatever F is, so an element of a row two items share (the
    halo) once for each; columns and rows of the padding are not masked."""
    n, h, w, c = shape
    g = tmc.geometry(h, w, 3, 3, padding, 2)
    r = tmc.window_rows(n, c, g.ho, g.wo)
    want = 2 * c * _brute_inputs(n, h, w, g.ho, g.wo, g.ph, g.pw, r)
    for f in (8, 512):
        assert tmc.mask_hashes(n, h, w, c, f, 3, 3, g, 2, 2, False,
                               True) == want


def test_resnet18_forward_mask_hashes():
    """The mask evaluations of one resnet18 blocks forward at ImageNet
    shapes (batch 128, S = 10; ``chip_smoke.py``'s BLOCKS_FORWARD): the
    three 3x3 site convs on the window routine 284.4 M, 142.2 M and 67.7 M
    (each input element once, and the halo rows items share) where
    ``conv_mma_kernel`` took 285.2 M, 275.6 M and 256.9 M, and the three
    1x1 projections on the 1x1 routine."""
    window = old = pointwise = 0
    for hw, c, f in ((56, 64, 128), (28, 128, 256), (14, 256, 512)):
        g = tmc.geometry(hw, hw, 3, 3, P1, 2)
        window += tmc.mask_hashes(128, hw, hw, c, f, 3, 3, g, 2, 10, False,
                                  True)
        old += tmc.mask_hashes(128, hw, hw, c, f, 3, 3, g, 2, 10, False)
        g1 = tmc.geometry(hw, hw, 1, 1, "SAME", 2)
        pointwise += tmc.mask_hashes(128, hw, hw, c, f, 1, 1, g1, 2, 10,
                                     True)
    assert window == 494_305_280
    assert old + pointwise == 930_037_760
    assert window + pointwise == 606_699_520


# ----------------------------------------------------------- card tests


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
    (n, h, w, c), f = GEOMS[name]
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    x = _cl(torch.randn(n, c, h, w, generator=gen).to(torch.bfloat16))
    wt = (torch.randn(f, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(
        torch.bfloat16)
    bias = torch.randn(f, generator=gen) * 0.3
    xs = torch.randn(S, n, c, h, w, generator=gen).to(torch.bfloat16)
    xs = xs.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    return (x.to(dev), wt.to(dev), bias.to(dev), xs.to(dev), seeds.to(dev))


def _close(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype
    assert err <= rtol * max(1.0, want.float().abs().max().item()), err


def _launches() -> int:
    return profiler.counters().get("conv.window_launches", 0)


@pytest.mark.card
@pytest.mark.parametrize("padding", [P1, "SAME"], ids=["pad1", "same"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_window_launches_equal_plain_and_single(card, name, padding):
    """Samples, _xs and single launches of the window routine: sample s
    bit-equal to the single launch with seeds[s] (on x[s] for _xs); each
    within BF16_OUT_RTOL (the served epilogue: bias, relu, bf16 store) or
    CONV_RTOL (no epilogue, f32 store) of the plain version; every launch
    takes the window routine."""
    x, w, bias, xs, seeds = _data(name, card)
    before = _launches()
    for epi, rtol in ((dict(bias=bias, act="relu",
                            out_dtype=torch.bfloat16), BF16_OUT_RTOL),
                      (dict(), CONV_RTOL)):
        geo = dict(padding=padding, stride=2, **epi)
        ys = tmc.dropout_conv_samples(x, w, seeds, RATE, **geo)
        yx = tmc.dropout_conv_inference(xs, w, seeds, RATE, **geo)
        for s in range(S):
            sd = seeds[s].contiguous()
            assert torch.equal(ys[s], tmc.dropout_conv_inference(
                x, w, sd, RATE, **geo))
            assert torch.equal(yx[s], tmc.dropout_conv_inference(
                xs[s], w, sd, RATE, **geo))
            _close(ys[s], tmc.dropout_conv_plain(
                x, w, sd, RATE, padding, 2, **epi), rtol)
            _close(yx[s], tmc.dropout_conv_plain(
                xs[s], w, sd, RATE, padding, 2, **epi), rtol)
    torch.cuda.synchronize()
    assert _launches() - before == 2 * (2 + 2 * S)


@pytest.mark.card
@pytest.mark.parametrize("row0", [0, 2 ** 31 + 4096, 2 ** 32 - 40])
@pytest.mark.parametrize("padding", [P1, "SAME"], ids=["pad1", "same"])
def test_window_mask_readout_is_exact(card, padding, row0):
    """x = ones, w = the identity on one tap (kh, kw) and zeros on the
    other eight: sample s reads the mask of seeds[s] at the inputs that tap
    reads, each kept element as the bf16 scale, bit for bit the plain
    version's (and so JAX's), for each of the nine taps (so every element
    an item's band holds, the halo rows two items share included), at row0
    0 and past 2^31 (the hash row wraps at 2^32)."""
    n, c, h, wd = 3, 64, 9, 8
    ones = _cl(torch.ones(n, c, h, wd, dtype=torch.bfloat16, device=card))
    seeds = torch.tensor(SEEDS, dtype=torch.int32, device=card)
    g = tmc.geometry(h, wd, 3, 3, padding, 2)
    keep = torch.stack([torch.nn.functional.pad(
        tmc.keep_mask_nchw(seeds[s], ones, RATE, row0),
        (g.pw, g.pw_hi, g.ph, g.ph_hi)) for s in range(S)])
    for kh, kw in itertools.product(range(3), range(3)):
        eye = torch.zeros(c, c, 3, 3, dtype=torch.bfloat16, device=card)
        eye[:, :, kh, kw] = torch.eye(c, dtype=torch.bfloat16)
        before = _launches()
        got = tmc.dropout_conv_samples(ones, eye, seeds, RATE, padding,
                                       stride=2, row0=row0)
        want = tmc.stack_samples([tmc.dropout_conv_plain(
            ones, eye, seeds[s], RATE, padding, 2, row0=row0)
            for s in range(S)])
        assert _launches() - before == 1
        assert torch.equal(got, want), (kh, kw)
        tap = keep[:, :, :, kh:kh + 2 * g.ho:2, kw:kw + 2 * g.wo:2]
        assert torch.equal(got != 0, tap), (kh, kw)
        assert set(got.unique().tolist()) <= {
            0.0, tmm.scale_of(RATE, torch.bfloat16)}


def _kernels(fn) -> set:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "conv_mma_kernel" in e.key}


@pytest.mark.card
def test_only_window_shapes_take_the_routine(card):
    """The profiler's kernel names and the counter: a bf16 MC 3x3 conv at
    stride 2 with C = 64 runs ``window::conv_mma_kernel`` (a samples, an
    _xs and a single launch, SAME and padding=1); its int8 twin, the
    mask-free ``conv_fused``, the same conv at stride 1, a 1x1 at stride 2
    (the 1x1 routine), C = 40, an f32 operand, a pad of 2 and the bank
    convs do not."""
    x, w, bias, xs, seeds = _data("odd_15x17x64_f72", card)
    sd = seeds[0].contiguous()
    xq, wq = x.to(torch.int8), w.to(torch.int8)
    x40 = _cl(x[:, :40])
    bank = torch.ones(4, 64, device=card)
    idxs = torch.arange(S, dtype=torch.int32, device=card)
    runs = {
        "samples": (lambda: tmc.dropout_conv_samples(
            x, w, seeds, RATE, P1, stride=2), True),
        "xs": (lambda: tmc.dropout_conv_inference(
            xs, w, seeds, RATE, "SAME", stride=2), True),
        "single": (lambda: tmc.dropout_conv_inference(
            x, w, sd, RATE, P1, stride=2), True),
        "int8": (lambda: tmc.dropout_conv_int8(
            xq, wq, sd, RATE, 2.0 ** -7, 2.0 ** -7, P1, stride=2), False),
        "conv_fused": (lambda: tmc.conv_fused(
            x, w, bias, padding=P1, stride=2), False),
        "stride1": (lambda: tmc.dropout_conv_samples(
            x, w, seeds, RATE, P1), False),
        "1x1_s2": (lambda: tmc.dropout_conv_samples(
            x, _cl(w[:, :, 1:2, 1:2]), seeds, RATE, stride=2), False),
        "c40": (lambda: tmc.dropout_conv_samples(
            x40, w[:, :40].contiguous(), seeds, RATE, P1, stride=2), False),
        "f32": (lambda: tmc.dropout_conv_inference(
            x.float(), w.float(), sd, RATE, P1, stride=2), False),
        "pad2": (lambda: tmc.dropout_conv_inference(
            x, w, sd, RATE, ((2, 2), (2, 2)), stride=2), False),
        "bank": (lambda: tmc.bank_conv_samples(
            x, w.float(), bank, idxs, P1, stride=2), False),
    }
    for name, (fn, window) in runs.items():
        before = _launches()
        names = _kernels(fn)
        assert _launches() - before == int(window), name
        assert names, name
        assert all(("window::conv_mma_kernel<" in k) == window
                   for k in names), (name, names)
