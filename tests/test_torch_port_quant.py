"""The port's fixed-point quantization against the JAX package's, on the CPU.

``bayestpu_torch.core.quant`` (fake-quant with AP_RND and a
straight-through gradient, the int8 grid, the exact int8 matmul and
convolution) and the quantized layers (``Dense``, ``QuantAct``, the int8
``max_pool``) are held bit for bit against ``bayestpu.core.quant`` and
``bayestpu.nn.layers`` on the same numpy inputs, with exact ±0.5-step ties
and saturation among them.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.core import quant as jq
from bayestpu.core.config import QuantConfig as JQuant
from bayestpu.nn import layers as jlayers
from bayestpu_torch.core import quant as tq
from bayestpu_torch.core.config import QuantConfig
from bayestpu_torch.nn import layers as tlayers

from port_threads import thread_budget  # noqa: F401

CONFIGS = [(8, 0, True), (8, 0, False), (8, 1, True), (4, 0, True)]


def _values(n=4000, seed=0, step=2.0 ** -7):
    """Random f32 values on and beyond the grid's range, with exact ties
    (k + 0.5) * step of both signs, grid points, zeros and saturating
    values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.7, size=n).astype(np.float32)
    k = rng.integers(-140, 140, size=n // 4)
    x[: n // 4] = ((k + 0.5) * step).astype(np.float32)          # ties
    x[n // 4: n // 2] = (k * step).astype(np.float32)            # on grid
    x[-6:] = [0.0, -0.0, 5.0, -5.0, 127.5 * step, -128.5 * step]
    return x


def _cfgs(total, ibits, signed):
    return (JQuant(total, ibits, keep_negative=signed),
            QuantConfig(total, ibits, keep_negative=signed))


@pytest.mark.parametrize("total,ibits,signed", CONFIGS)
@pytest.mark.parametrize("bf16", [False, True])
def test_fake_quant_bit_equal_jax(total, ibits, signed, bf16):
    jc, tc = _cfgs(total, ibits, signed)
    x = _values(step=2.0 ** (ibits - total + 1))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    want = np.asarray(jq.fake_quant(jnp.asarray(x, jdt), jc), np.float32)
    got = tq.fake_quant(torch.from_numpy(x).to(tdt), tc)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_ties_round_away_from_zero():
    """AP_RND, not round-half-even: ±0.5, ±1.5 and ±2.5 steps."""
    step = 2.0 ** -7
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5]) * step
    got = tq.fake_quant(x, QuantConfig(8, 0)) / step
    assert got.tolist() == [1.0, 2.0, 3.0, -1.0, -2.0, -3.0]
    other = dataclasses.replace(QuantConfig(8, 0), round_mode="CONV")
    want = np.asarray(jq.fake_quant(jnp.asarray(x.numpy()),
                                    JQuant(8, 0, round_mode="CONV")))
    np.testing.assert_array_equal(tq.fake_quant(x, other).numpy(), want)
    assert (tq.fake_quant(x, other) / step).tolist() == [0.0, 2.0, 2.0, -0.0,
                                                         -2.0, -2.0]


def test_fake_quant_gradient_is_identity():
    """The straight-through estimator, as ``jax.grad`` of JAX's."""
    x = _values(n=400, seed=3)
    w = np.random.default_rng(4).normal(size=400).astype(np.float32)
    cfg = QuantConfig(8, 0)
    jg = jax.grad(lambda a: jnp.sum(jq.fake_quant(a, JQuant(8, 0))
                                    * jnp.asarray(w)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tg,) = torch.autograd.grad((tq.fake_quant(xt, cfg)
                                 * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tg.numpy(), w)


@pytest.mark.parametrize("ibits", [0, 1])
def test_quantize_and_dequantize_int8_bit_equal_jax(ibits):
    x = _values(step=2.0 ** (ibits - 7), seed=ibits)
    jc, tc = JQuant(8, ibits), QuantConfig(8, ibits)
    jv, js = jq.quantize_int8(jnp.asarray(x), jc)
    tv, ts = tq.quantize_int8(torch.from_numpy(x), tc)
    assert tv.dtype == torch.int8 and ts == js == tq.int8_step(tc)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.min() == -128 and tv.max() == 127                # saturation
    again, _ = tq.quantize_int8(tv, tc)                        # pass-through
    assert again is tv
    np.testing.assert_array_equal(
        tq.dequantize_int8(tv, tc).numpy(),
        np.asarray(jq.dequantize_int8(jv, jc)))
    with pytest.raises(ValueError, match="total_bits"):
        tq.int8_step(QuantConfig(4, 0))


@pytest.mark.parametrize("m,k,n", [(5, 24, 10), (128, 512, 10),
                                   (37, 45, 19), (300, 700, 130)])
def test_int8_matmul_bit_equal_jax(m, k, n):
    """Small M and ragged K, N are padded for ``torch._int_mm`` and sliced;
    the int32 sum is exact, so the f32 result equals JAX's."""
    rng = np.random.default_rng(m)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                     2.0 ** -7, 2.0 ** -6))
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         2.0 ** -7, 2.0 ** -6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tq.int_mm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        x.astype(np.int64) @ w.astype(np.int64))


def test_int8_matmul_keeps_leading_axes():
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, size=(3, 4, 16)).astype(np.int8)
    w = rng.integers(-128, 128, size=(16, 8)).astype(np.int8)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w), 0.5,
                                     0.25))
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), 0.5, 0.25)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride,padding,c,o,hw", [
    ((1, 1), "SAME", 128, 64, 8),
    ((2, 2), ((1, 1), (1, 1)), 64, 128, 16),
    ((2, 2), ((1, 1), (1, 1)), 256, 32, 7),
])
def test_int8_conv_equals_jax(stride, padding, c, o, hw):
    """The im2col int8 convolution against XLA's int8 convolution with an
    int32 result, ``array_equal``."""
    rng = np.random.default_rng(c + o)
    x = rng.integers(-128, 128, size=(2, hw, hw, c)).astype(np.int8)
    w = rng.integers(-128, 128, size=(3, 3, c, o)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=stride,
        padding=padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    got = tq.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(w).permute(3, 2, 0, 1), stride,
                         (1, 1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_max_pool_int8_equals_jax():
    x = np.random.default_rng(2).integers(-128, 128, size=(2, 8, 6, 5)
                                          ).astype(np.int8)
    want = np.asarray(jlayers.max_pool(jnp.asarray(x), 2, 2))
    got = tlayers.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_quant_act_equals_jax():
    x = _values(n=1000, seed=6).reshape(10, 100)
    cfg = JQuant(8, 0)
    want = np.asarray(jlayers.QuantAct(quant=cfg).apply({}, jnp.asarray(x)))
    got = tlayers.QuantAct(QuantConfig(8, 0))(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got >= 0).all())


@pytest.mark.parametrize("int8_infer", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_dense_quant_equals_jax(int8_infer, bf16):
    """The fake-quant Dense (kernel and bias on the grid, the dot in the
    compute dtype) and the int8 one (``int8_matmul`` + fake-quant bias) on
    the same weights. f32: rtol 1e-6 for the fake-quant dot's summation
    order; the int8 Dense is exact."""
    rng = np.random.default_rng(7)
    x = rng.normal(scale=0.5, size=(6, 64)).astype(np.float32)
    kernel = rng.normal(scale=0.3, size=(64, 12)).astype(np.float32)
    bias = rng.normal(scale=0.2, size=12).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    want = np.asarray(jlayers.Dense(12, quant=JQuant(8, 0, int8_infer=int8_infer),
                                    dtype=jdt).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    layer = tlayers.Dense(64, 12, quant=QuantConfig(8, 0,
                                                    int8_infer=int8_infer),
                          dtype=tdt)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(kernel))
        layer.bias.copy_(torch.from_numpy(bias))
        got = layer(torch.from_numpy(x)).numpy()
    if int8_infer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if int8_infer:   # an int8 input is taken as it is, on the grid
        xq = tq.quantize_int8(torch.from_numpy(x), QuantConfig(8, 0))[0]
        with torch.no_grad():
            np.testing.assert_array_equal(layer(xq).numpy(), got)


def test_int8_conv_routing_rule_equals_jax():
    from bayestpu.nn.fused import _int8_conv_on_mxu as jroute
    for q in (JQuant(8, 0), JQuant(8, 0, int8_conv_min_ch=4)):
        tqc = QuantConfig(8, 0, int8_conv_min_ch=q.int8_conv_min_ch)
        for in_ch in (3, 16, 32, 64, 65, 128, 512):
            for spatial in (2, 16, 32):
                assert tlayers._int8_conv_on_mxu(in_ch, tqc, spatial) == \
                    jroute(in_ch, q, spatial), (in_ch, spatial)


def test_quant_adds_no_parameters():
    """A layer with ``quant`` keeps the float layer's parameter names."""
    for a, b in ((tlayers.Dense(8, 4, quant=QuantConfig(8, 0)),
                  tlayers.Dense(8, 4)),
                 (tlayers.ConvBN(8, 4, quant=QuantConfig(8, 0)),
                  tlayers.ConvBN(8, 4))):
        assert [n for n, _ in a.named_parameters()] == [
            n for n, _ in b.named_parameters()]
        assert [n for n, _ in a.named_buffers()] == [
            n for n, _ in b.named_buffers()]
