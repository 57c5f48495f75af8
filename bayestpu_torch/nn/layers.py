"""Building blocks: ``Dense``, ``BatchNorm``, ``ConvBN``, ``QuantAct``,
``max_pool`` and ``avg_pool``.

Counterpart of ``bayestpu/nn/layers.py`` for the float path (``quant=None``).
Parameters keep the Flax names and layouts (dense kernels ``(in, out)``,
BatchNorm ``scale``/``bias`` with ``mean``/``var`` buffers) except conv
kernels, which are OIHW. Image activations flow as NCHW tensors, in
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
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bayestpu_torch.core.config import QuantConfig
from bayestpu_torch.kernels.masked_matmul import matmul_f32

_QUANT_TODO = ("fixed-point quantization (QuantConfig) is not ported yet: "
               "ROADMAP Queue 1 item 8, the int8 operating point")


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


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if quant is not None:
            raise NotImplementedError(_QUANT_TODO)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dot(x, self.kernel, self.dtype)
        return y + self.bias if self.bias is not None else y


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


class ConvBN(nn.Module):
    """Conv + BatchNorm (no conv bias), with the activation owned by the
    layer.

    Eval: BN folded: kernel * inv in f32, cast to the compute dtype, conv,
    output rounded to the compute dtype, + f32 shift, relu, store in the
    compute dtype (bf16 residency) or f32. Train: conv of the compute-dtype
    casts of x and the kernel, output upcast to f32, BN with batch
    statistics (momentum 0.9, ``layers.py:209``), relu; f32 out."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 dtype: torch.dtype = torch.float32, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        self.padding = _torch_padding(padding, kernel_size, strides)
        self.conv = _Conv(in_ch, features, kernel_size)
        self.bn = BatchNorm(features, epsilon, momentum)

    def _conv(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), kernel.to(self.dtype),
                        stride=self.strides, padding=self.padding).float()

    def forward(self, x: torch.Tensor, act: str | None = None
                ) -> torch.Tensor:
        if self.training:
            y = self.bn(self._conv(x, self.conv.kernel))
            return torch.relu(y) if act == "relu" else y
        inv, shift = self.bn.fold()
        y = self._conv(x, self.conv.kernel * inv[:, None, None, None])
        y = y + shift[:, None, None]
        if act == "relu":
            y = torch.relu(y)
        return y.to(self.dtype)


class QuantAct(nn.Module):
    """Activation with optional fixed-point quantization; relu when
    ``quant=None`` (the only ported case)."""

    def __init__(self, quant: QuantConfig | None = None):
        super().__init__()
        if quant is not None:
            raise NotImplementedError(_QUANT_TODO)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


def _pair(v: int | tuple[int, int]) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def max_pool(x: torch.Tensor, window: int | tuple[int, int],
             strides: int | tuple[int, int] | None = None) -> torch.Tensor:
    """VALID max pool of an NCHW tensor."""
    window = _pair(window)
    return F.max_pool2d(x, window, _pair(strides) if strides else window)


def avg_pool(x: torch.Tensor, window: int | tuple[int, int],
             strides: int | tuple[int, int] | None = None) -> torch.Tensor:
    """VALID average pool of an NCHW tensor."""
    window = _pair(window)
    return F.avg_pool2d(x, window, _pair(strides) if strides else window)
