"""Building blocks: ``Dense``, ``BatchNorm``, ``ConvBN``, ``QuantAct``,
``max_pool`` and ``avg_pool``.

Counterpart of ``bayestpu/nn/layers.py``: the float path (``quant=None``)
and the quantized one (``QuantConfig``, see below). Parameters keep the
Flax names and layouts (dense kernels ``(in, out)``, BatchNorm
``scale``/``bias`` with ``mean``/``var`` buffers) except conv kernels, which
are OIHW. Image activations flow as NCHW tensors, in
``channels_last`` memory when the model is fed NHWC images; dense
activations are ``(..., features)``. ``module.training`` (``model.train()``
/ ``model.eval()``) plays the JAX ``train=`` flag.

Under a bf16 compute dtype the layers reproduce the JAX package's rounding
points. A dense contraction casts both operands to bf16 and accumulates in
f32. At inference ``ConvBN`` folds BN into the kernel in f32, casts it to
bf16, rounds the conv output to bf16, then adds the f32 bias, applies the
relu and stores bf16 (``bayestpu/nn/fused.py:274-278,326-343,465-474``). In
training it convolves the bf16 casts of x and the unfolded kernel, upcasts
the output to f32 and applies BN with batch statistics, so activations stay
f32 between layers (``layers.py:238-246``, ``fused.py:223-241``).

With a ``QuantConfig`` the layers follow the JAX package's quantized
branches (``layers.py:58-83,163-178``, ``fused.py:269-496`` with no mask):

- training (QAT): fake-quantized kernels and biases with a straight-through
  gradient; ``ConvBN`` runs conv → BN → relu → unsigned fake-quant.
- eval, fake-quant model: BN is NOT folded into the kernel. The kernel is
  fake-quantized unfolded and BN rides an f32 epilogue ``y * inv + shift``
  after the conv, then relu and unsigned fake-quant; activations stay f32.
- eval, int8 model (``quant.int8_infer``): activations live as int8 on the
  grid between layers. A conv whose input is wide enough
  (``_int8_conv_on_mxu``) runs int8 × int8 → int32 (``int8_conv2d``) times
  ``x_step * w_step``; the others (the entry conv, which takes the raw
  image, and the 64-channel convs at 16²) run the float conv on grid values,
  rounded to the compute dtype as in float. The epilogue emits int8
  (``clip(AP_RND(y / step), -128, 127)``), or with ``defer_int8`` the
  unsigned grid value in bf16, re-quantized by the caller after its pool.
  ``Dense`` runs ``int8_matmul``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bayestpu_torch.core.config import QuantConfig
from bayestpu_torch.core.quant import (dequantize_int8, fake_quant,
                                       int8_conv2d, int8_matmul,
                                       quantize_int8, unsigned)
from bayestpu_torch.kernels.masked_matmul import matmul_f32


def lecun_normal_(param: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` (truncated normal in two standard deviations,
    variance 1/fan_in), drawn on the CPU from ``generator`` and copied into
    ``param`` on its device."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    tmp = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        param.copy_(tmp * std)


def dot(x: torch.Tensor, kernel: torch.Tensor,
        dtype: torch.dtype) -> torch.Tensor:
    """``jnp.dot(x.astype(dtype), kernel.astype(dtype),
    preferred_element_type=f32)``: operands rounded to ``dtype``, products
    accumulated in f32."""
    return matmul_f32(x.to(dtype), kernel.to(dtype))


def maybe_quant(w: torch.Tensor, q: QuantConfig | None) -> torch.Tensor:
    return fake_quant(w, q) if q is not None else w


def quant_operands(x: torch.Tensor, kernel: torch.Tensor,
                   q: QuantConfig | None, int8: bool):
    """The operands of ``x @ kernel`` under ``q`` (``layers.py:58-83``,
    ``fused.py:524-540``): ``(x_q, w_q, (x_step, w_step))`` with ``int8``
    (an int8 x is already on the grid and passes through), else
    ``(x, fake-quantized kernel, None)`` with an int8 x dequantized."""
    if int8:
        xq, xs = quantize_int8(x, q)
        wq, ws = quantize_int8(kernel, q)
        return xq, wq, (xs, ws)
    if x.dtype == torch.int8:
        x = dequantize_int8(x, q)
    return x, maybe_quant(kernel, q), None


def quant_dot(x: torch.Tensor, kernel: torch.Tensor, q: QuantConfig | None,
              dtype: torch.dtype, int8: bool) -> torch.Tensor:
    """``x @ kernel`` under ``q``: int8 × int8 → int32 with one rescale
    when ``int8``, else ``dot`` of the operands of ``quant_operands``."""
    x, kernel, steps = quant_operands(x, kernel, q, int8)
    return int8_matmul(x, kernel, *steps) if steps else dot(x, kernel, dtype)


class Dense(nn.Module):
    """Dense layer; with ``quant`` fake-quantized kernel and bias, or under
    ``quant.int8_infer`` (inputs of at least ``int8_dense_min_dim``
    features) int8 × int8 → int32 with one rescale, then the fake-quantized
    bias (``layers.py:58-83``)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quant = quant
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quant
        int8 = (q is not None and q.int8_infer
                and x.shape[-1] >= q.int8_dense_min_dim)
        y = quant_dot(x, self.kernel, q, self.dtype, int8)
        if self.bias is None:
            return y
        return y + maybe_quant(self.bias, q)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over dim 1 (channels of NCHW, features of
    (B, F)): running averages in eval mode, batch statistics in train mode.

    Train mode follows flax 0.12's ``_compute_stats``: f32 statistics over
    every other dim, the fast biased variance ``E[x²] − E[x]²`` clamped at
    0, and the running update ``m·running + (1−m)·batch`` under no_grad.
    ``momentum`` is Flax's (0.99 by default; ``ConvBN`` passes 0.9), which
    is 1 − ``nn.BatchNorm2d``'s, and the running variance is the biased one.
    """

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) of the inference affine: ``inv`` and
        ``bias - mean * inv``."""
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            x = x.float()
            axes = [d for d in range(x.dim()) if d != 1]
            mean = x.mean(axes)
            var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        # flax's order of operations: (x - mean) * (rsqrt(var+eps)*scale) + b
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class _Conv(nn.Module):
    """Holds the conv kernel (OIHW) under the Flax name ``conv/kernel``."""

    def __init__(self, in_ch: int, features: int, kernel_size: Sequence[int]):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features, in_ch, *kernel_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, generator)


def _torch_padding(padding, kernel_size: Sequence[int],
                   strides: Sequence[int]) -> tuple[int, int]:
    """Symmetric per-dimension padding of F.conv2d for the Flax paddings the
    ported models use: "SAME" at stride 1 with odd kernels, "VALID", or
    explicit symmetric ((lo, hi), (lo, hi)) pairs."""
    if padding == "VALID":
        return (0, 0)
    if padding == "SAME":
        if any(s != 1 for s in strides) or any(k % 2 == 0
                                               for k in kernel_size):
            raise NotImplementedError(
                "SAME padding is ported for stride 1 and odd kernels only")
        return tuple(k // 2 for k in kernel_size)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if any(lo != hi for lo, hi in pads):
        raise NotImplementedError(f"asymmetric padding {padding}")
    return tuple(lo for lo, _ in pads)


def _int8_conv_on_mxu(in_ch: int, q: QuantConfig, spatial: int) -> bool:
    """Which int8-inference convs run int8 × int8 (``fused.py:53-78``): in
    channels above ``q.int8_conv_min_ch``, or at least 32 at a spatial size
    of at least 32. The rule and its default threshold are the JAX
    package's, tuned on a TPU; under bf16 it changes values, not only
    speed (the float branch rounds its output to bf16, the int8 branch does
    not), so the port keeps it until a benchmark on the card retunes it."""
    return in_ch > q.int8_conv_min_ch or (in_ch >= 32 and spatial >= 32)


class ConvBN(nn.Module):
    """Conv + BatchNorm (no conv bias), with the activation owned by the
    layer.

    Float eval: BN folded: kernel * inv in f32, cast to the compute dtype,
    conv, output rounded to the compute dtype, + f32 shift, relu, store in
    the compute dtype (bf16 residency) or f32. Train: conv of the
    compute-dtype casts of x and the kernel, output upcast to f32, BN with
    batch statistics (momentum 0.9, ``layers.py:209``), relu; f32 out. The
    quantized branches are in the module docstring. ``quant_input=False``
    marks a model's entry conv, which takes the raw image and never
    quantizes it."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 dtype: torch.dtype = torch.float32, epsilon: float = 1e-5,
                 momentum: float = 0.9, quant: QuantConfig | None = None,
                 quant_input: bool = True):
        super().__init__()
        self.quant = quant
        self.quant_input = quant_input
        self.dtype = dtype
        self.strides = tuple(strides)
        self.padding = _torch_padding(padding, kernel_size, strides)
        self.conv = _Conv(in_ch, features, kernel_size)
        self.bn = BatchNorm(features, epsilon, momentum)

    def _conv(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), kernel.to(self.dtype),
                        stride=self.strides, padding=self.padding).float()

    def forward(self, x: torch.Tensor, act: str | None = None,
                act_quant: bool = False, defer_int8: bool = False
                ) -> torch.Tensor:
        """``act_quant``: an unsigned fake-quant (QuantAct) follows the
        relu, or in the int8 model the epilogue emits int8. ``defer_int8``
        (int8 model): emit the grid value in bf16 instead; the caller's max
        pool commutes with the grid rounding and re-quantizes after it
        (``fused.py:476-483``)."""
        if self.quant is not None:
            return self._forward_quant(x, act, act_quant, defer_int8)
        if self.training:
            y = self.bn(self._conv(x, self.conv.kernel))
            return torch.relu(y) if act == "relu" else y
        inv, shift = self.bn.fold()
        y = self._conv(x, self.conv.kernel * inv[:, None, None, None])
        y = y + shift[:, None, None]
        if act == "relu":
            y = torch.relu(y)
        return y.to(self.dtype)

    def _forward_quant(self, x: torch.Tensor, act: str | None,
                       act_quant: bool, defer_int8: bool) -> torch.Tensor:
        q = self.quant
        kernel = fake_quant(self.conv.kernel, q)
        if self.training:
            y = self.bn(self._conv(x, kernel))
            if act == "relu":
                y = torch.relu(y)
                if act_quant:
                    y = fake_quant(y, unsigned(q))
            return y
        int8_mode = q.int8_infer
        x_f = dequantize_int8(x, q) if x.dtype == torch.int8 else x
        int8_exec = False
        if int8_mode and (x.dtype == torch.int8 or self.quant_input):
            # float branches see the grid values the int8 branch consumes
            xq, xs = quantize_int8(x, q)
            x_f = xq.float() * xs
            int8_exec = _int8_conv_on_mxu(x.shape[1], q, x.shape[2])
        if int8_exec:
            wq, ws = quantize_int8(kernel, q)
            y = int8_conv2d(xq, wq, self.strides, self.padding).float() * (
                xs * ws)
        else:
            y = self._conv(x_f, kernel)
        # BN as an f32 epilogue, never folded into the quantized kernel
        inv, shift = self.bn.fold()
        y = y * inv[:, None, None]
        y = y + shift[:, None, None]
        if act == "relu":
            y = torch.relu(y)
        if int8_mode and act == "relu" and act_quant:
            if defer_int8:
                return fake_quant(y, unsigned(q)).to(torch.bfloat16)
            return quantize_int8(y, q)[0]
        if act_quant and act is not None:
            return fake_quant(y, unsigned(q))
        return y


class QuantAct(nn.Module):
    """relu, then with ``quant`` the unsigned fake-quant of QKeras
    ``quantized_relu`` (``layers.py:163-178``)."""

    def __init__(self, quant: QuantConfig | None = None):
        super().__init__()
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(x)
        return y if self.quant is None else fake_quant(y, unsigned(self.quant))


def _pair(v: int | tuple[int, int]) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def max_pool(x: torch.Tensor, window: int | tuple[int, int],
             strides: int | tuple[int, int] | None = None) -> torch.Tensor:
    """VALID max pool of an NCHW tensor. An int8 tensor on the grid pools
    as int8 by a windowed ``amax`` (``F.max_pool2d`` has no int8 kernel on
    CUDA); the max of grid values stays on the grid."""
    window = _pair(window)
    strides = _pair(strides) if strides else window
    if x.dtype == torch.int8:
        return x.unfold(2, window[0], strides[0]).unfold(
            3, window[1], strides[1]).amax(dim=(-2, -1))
    return F.max_pool2d(x, window, strides)


def avg_pool(x: torch.Tensor, window: int | tuple[int, int],
             strides: int | tuple[int, int] | None = None) -> torch.Tensor:
    """VALID average pool of an NCHW tensor."""
    window = _pair(window)
    return F.avg_pool2d(x, window, _pair(strides) if strides else window)
