"""Building blocks: ``Dense``, ``Conv``, ``BatchNorm``, ``ConvBN``,
``QuantAct``, ``max_pool`` and ``avg_pool``.

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
f32. ``ConvBN``'s conv is ``nn.fused.BayesConv``, the port of the JAX
``BayesConv`` that ``ConvBN`` wraps: at inference a conv without a site
folds BN into the kernel in f32, casts it to bf16, rounds the conv output
to bf16, then adds the f32 bias, applies the relu and stores bf16
(``bayestpu/nn/fused.py:274-278,326-343,465-474``). In training it
convolves the bf16 casts of x and the unfolded kernel, upcasts the output
to f32 and applies BN with batch statistics, so activations stay f32
between layers (``layers.py:238-246``, ``fused.py:223-241``).

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
  ``Dense`` runs ``int8_matmul``; ``Dense(int8_infer=True)`` does so
  whatever its input width, and ``bias_quant`` gives the bias a grid of
  its own.

``Conv`` is the JAX package's plain ``Conv`` (``layers.py:86-160``), an XLA
conv there and ``F.conv2d`` (cuDNN) here: any stride, SAME (XLA's
asymmetric padding), VALID or explicit padding, a bias, and the quantized
branches above; its output is f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from bayestpu_torch.core.config import QuantConfig
from bayestpu_torch.core.quant import (dequantize_int8, fake_quant,
                                       int8_matmul, quantize_int8, unsigned)
from bayestpu_torch.kernels.masked_conv import (conv2d_padded, conv_geometry,
                                                conv_int8)
from bayestpu_torch.kernels.masked_matmul import matmul_f32
from bayestpu_torch.nn.rows import RowAware


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
        if q is None:
            raise ValueError("int8-residency input reached a dense layer "
                             "with quant=None: the producing layer's "
                             "int8 output needs every consumer to carry "
                             "the quant config")
        x = dequantize_int8(x, q)
    return x, maybe_quant(kernel, q), None


def quant_dot(x: torch.Tensor, kernel: torch.Tensor, q: QuantConfig | None,
              dtype: torch.dtype, int8: bool) -> torch.Tensor:
    """``x @ kernel`` under ``q``: int8 × int8 → int32 with one rescale
    when ``int8``, else ``dot`` of the operands of ``quant_operands``."""
    x, kernel, steps = quant_operands(x, kernel, q, int8)
    return int8_matmul(x, kernel, *steps) if steps else dot(x, kernel, dtype)


class Dense(nn.Module):
    """Dense layer; with ``quant`` fake-quantized kernel and bias, or with
    ``int8_infer`` (or under ``quant.int8_infer``, inputs of at least
    ``int8_dense_min_dim`` features) int8 × int8 → int32 with one rescale,
    then the fake-quantized bias (``layers.py:36-83``). ``bias_quant``
    puts the bias alone on a grid of its own (the reference's 2×-bits fc_0
    bias); None leaves it on ``quant``'s."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, int8_infer: bool = False,
                 bias_quant: QuantConfig | None = None):
        super().__init__()
        self.quant = quant
        self.dtype = dtype
        self.int8_infer = int8_infer
        self.bias_quant = bias_quant
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quant
        int8 = q is not None and (self.int8_infer or (
            q.int8_infer and x.shape[-1] >= q.int8_dense_min_dim))
        y = quant_dot(x, self.kernel, q, self.dtype, int8)
        if self.bias is None:
            return y
        return y + maybe_quant(self.bias, self.bias_quant or q)


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of ``group``, whose backward sums
    the gradients over them too: every rank's loss reaches every rank's
    share of the sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchNorm(RowAware, nn.Module):
    """Flax ``nn.BatchNorm`` over dim 1 (channels of NCHW, features of
    (B, F)): running averages in eval mode, batch statistics in train mode.

    Train mode follows flax 0.12's ``_compute_stats``: f32 statistics over
    every other dim, the fast biased variance ``E[x²] − E[x]²`` clamped at
    0, and the running update ``m·running + (1−m)·batch`` under no_grad.
    ``momentum`` is Flax's (0.99 by default; ``ConvBN`` passes 0.9), which
    is 1 − ``nn.BatchNorm2d``'s, and the running variance is the biased one.
    On one rank's rows of a data-sharded batch with the data axis's process
    group (``nn.rows``) the statistics are the global batch's: the
    per-channel sums of x and x² and the count, summed over the group
    (``_AllReduceSum``, whose backward sums their gradients), as a sharded
    ``jax.jit`` reduces them.
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
            if self.rows.group is None:
                mean = x.mean(axes)
                var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
            else:
                c = x.shape[1]
                total = _AllReduceSum.apply(torch.cat([
                    x.sum(axes), (x * x).sum(axes),
                    x.new_full((1,), x.numel() // c)]), self.rows.group)
                mean = total[:c] / total[-1]
                var = torch.clamp_min(total[c:2 * c] / total[-1] - mean * mean,
                                      0.0)
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
    """Holds the conv kernel (OIHW) under the Flax name ``conv/kernel`` and,
    for a Masksembles site, its (num_masks, in_ch) f32 bank as the buffer
    ``bank`` (``masks/<…>/conv/bank``)."""

    def __init__(self, in_ch: int, features: int, kernel_size: Sequence[int],
                 bank: torch.Tensor | None = None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features, in_ch, *kernel_size))
        if bank is not None:
            self.register_buffer("bank", bank)

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, generator)


def _folded(conv):
    """``conv`` applied to an NCHW x, or to an x (S, N, C, H, W) that
    carries the sample axis with S folded into the batch (no mask here)."""
    def run(x: torch.Tensor, *args) -> torch.Tensor:
        lead = x.shape[:-3]
        y = conv(x.reshape((-1,) + tuple(x.shape[-3:])), *args)
        return y.reshape(tuple(lead) + tuple(y.shape[1:]))
    return run


@_folded
def xla_conv(x: torch.Tensor, kernel: torch.Tensor, padding, stride: int,
             dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's XLA conv (``fused.py:223-241``, ``layers.py:
    138-153``): operands cast to ``dtype``, a bf16 conv rounded to bf16, f32
    out."""
    g = conv_geometry(x.shape[2], x.shape[3], kernel.shape[2],
                      kernel.shape[3], padding, stride)
    return conv2d_padded(x.to(dtype), kernel.to(dtype), g, stride).float()


@_folded
def xla_conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, padding,
                  stride: int) -> torch.Tensor:
    """int8 × int8 → int32 conv of the grid values, any stride."""
    g = conv_geometry(x_q.shape[2], x_q.shape[3], w_q.shape[2],
                      w_q.shape[3], padding, stride)
    return conv_int8(x_q, w_q, g, stride)


def _int8_conv_on_mxu(in_ch: int, q: QuantConfig, spatial: int) -> bool:
    """Which int8-inference convs run int8 × int8 (``fused.py:53-78``): in
    channels above ``q.int8_conv_min_ch``, or at least 32 at a spatial size
    of at least 32. The rule and its default threshold are the JAX
    package's, tuned on a TPU; under bf16 it changes values, not only
    speed (the float branch rounds its output to bf16, the int8 branch does
    not), so the port keeps it until a benchmark on the card retunes it."""
    return in_ch > q.int8_conv_min_ch or (in_ch >= 32 and spatial >= 32)


class Conv(_Conv):
    """The plain conv (``layers.py:86-160``): ``kernel`` (OIHW) and, with
    ``use_bias``, ``bias``. Under ``quant`` it runs int8 × int8 → int32
    times ``x_step · w_step`` when ``int8_infer`` is set on the layer, or
    under ``quant.int8_infer`` when ``_int8_conv_on_mxu`` routes the input
    there, provided the input is int8 or ``quant_input`` (False on a
    model's entry conv, which takes the raw image); else the
    fake-quantized kernel on the float (an int8 x dequantized) input in
    ``dtype``. f32 out, the fake-quantized bias added."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 use_bias: bool = True, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32, int8_infer: bool = False,
                 quant_input: bool = True):
        super().__init__(in_ch, features, kernel_size)
        self.stride = int(strides[0])
        if tuple(strides) != (self.stride, self.stride):
            raise ValueError(f"strides {tuple(strides)}: the port takes "
                             "equal strides")
        self.padding = padding
        conv_geometry(8, 8, *kernel_size, padding, self.stride)  # validates
        self.quant, self.dtype = quant, dtype
        self.int8_infer, self.quant_input = int8_infer, quant_input
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quant
        use_int8 = (q is not None
                    and (self.int8_infer or (q.int8_infer and _int8_conv_on_mxu(
                        x.shape[-3], q, x.shape[-2])))
                    and (x.dtype == torch.int8 or self.quant_input))
        if use_int8:
            xq, xs = quantize_int8(x, q)
            wq, ws = quantize_int8(self.kernel, q)
            y = xla_conv_int8(xq, wq, self.padding, self.stride).float() * (
                xs * ws)
        else:
            if x.dtype == torch.int8:
                if q is None:
                    raise ValueError("int8-residency input reached a Conv "
                                     "with quant=None")
                x = dequantize_int8(x, q)
            y = xla_conv(x, maybe_quant(self.kernel, q), self.padding,
                         self.stride, self.dtype)
        if self.bias is None:
            return y
        return y + maybe_quant(self.bias, q)[:, None, None]


class ConvBN(nn.Module):
    """Conv + BatchNorm (no conv bias), with the activation owned by the
    layer (``layers.py:181-260``). The conv is a ``BayesConv`` (``conv``),
    with a Bayesian site on its input when ``bayes`` is given.

    Train: ``bn(conv(x))`` with batch statistics (momentum 0.9), relu, and
    under ``quant`` the unsigned fake-quant; f32 out. Eval: the running
    statistics folded into the conv, ``inv`` and ``shift`` handed to
    ``BayesConv`` as ``fold_scale``/``fold_bias`` with the activation — see
    ``nn.fused.BayesConv`` for where they go on each branch.
    ``quant_input=False`` marks a model's entry conv, which takes the raw
    image and never quantizes it."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 dtype: torch.dtype = torch.float32, epsilon: float = 1e-5,
                 momentum: float = 0.9, quant: QuantConfig | None = None,
                 quant_input: bool = True, bayes=None):
        from bayestpu_torch.nn.fused import BayesConv

        super().__init__()
        self.quant = quant
        self.conv = BayesConv(in_ch, features, kernel_size, strides, padding,
                              bayes=bayes, quant=quant, dtype=dtype,
                              quant_input=quant_input)
        self.bn = BatchNorm(features, epsilon, momentum)

    def forward(self, x: torch.Tensor, act: str | None = None,
                act_quant: bool = False, emit_int8: bool = False,
                defer_int8: bool = False,
                seeds: torch.Tensor | None = None, sample_idx=0
                ) -> torch.Tensor:
        """``act_quant``: an unsigned fake-quant (QuantAct) follows the
        relu, or in the int8 model the epilogue emits int8. ``emit_int8``
        (int8 model, relu): emit int8 without ``act_quant``; every
        consumer must requantize on the same grid. ``defer_int8``
        (int8 model, unfused conv): emit the grid value in bf16 instead; the
        caller's max pool commutes with the grid rounding and re-quantizes
        after it (``fused.py:476-483``). ``seeds``/``sample_idx`` feed the
        site: see ``BayesConv``."""
        if self.training:
            y = self.bn(self.conv(x, seeds=seeds, sample_idx=sample_idx))
            if act == "relu":
                y = torch.relu(y)
                if act_quant and self.quant is not None:
                    y = fake_quant(y, unsigned(self.quant))
            return y
        inv, shift = self.bn.fold()
        return self.conv(x, seeds=seeds, sample_idx=sample_idx,
                         fold_scale=inv, fold_bias=shift, act=act,
                         act_quant=act_quant, emit_int8=emit_int8,
                         defer_int8=defer_int8)


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
    CUDA) over the NHWC view, so channels_last memory stays channels_last;
    the max of grid values stays on the grid."""
    window = _pair(window)
    strides = _pair(strides) if strides else window
    if x.dtype == torch.int8:
        return x.permute(0, 2, 3, 1).unfold(1, window[0], strides[0]).unfold(
            2, window[1], strides[1]).amax(dim=(-2, -1)).permute(0, 3, 1, 2)
    return F.max_pool2d(x, window, strides)


def avg_pool(x: torch.Tensor, window: int | tuple[int, int],
             strides: int | tuple[int, int] | None = None) -> torch.Tensor:
    """VALID average pool of an NCHW tensor."""
    window = _pair(window)
    return F.avg_pool2d(x, window, _pair(strides) if strides else window)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W of x (B, H, W, C): (B, C)."""
    return torch.mean(x, dim=(1, 2))
