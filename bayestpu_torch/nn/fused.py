"""Bayesian mask sites fused into the layer after them: ``BayesDense``,
``BayesConv`` and ``BayesConvInput``.

Counterpart of ``bayestpu.nn.fused`` (``fused.py:123-614``): the
MC-dropout, Masksembles and no-dropout branches, in training and at
inference. ``BayesConv`` is below ``BayesDense``, which this part
describes.

MC dropout at rate > 0, fused: the mask is generated inside the CUDA
matmul kernel (``bayestpu_torch.kernels.masked_matmul``). At inference seeds of
shape (2,) run one sample and seeds of shape (S, 2) run all S samples in
one launch (the spatial mapping). In training (``self.training``) the seeds
are (2,) and the head goes through the trainable ``dropout_matmul``, whose
backward regenerates the mask (``fused.py:581-588``). Under bf16 both x and
the kernel are cast to bf16 and the f32 bias is added to the f32 product.
Unfused (``fused=False``, the JAX default; ``fused.py:589-594``) the head
is the materialized ``BayesianDropout`` ``drop`` (threefry masks, on the
same seed pair) and then the dense, in training too.

Masksembles (``kind=MASK``, ``fused.py:541-571``): the head holds the
(num_masks, in_features) f32 buffer ``bank``, generated from
``nn.bayes.BANK_SEED`` as the Flax init does (``nn.bayes.make_bank``). At
inference an int ``sample_idx`` selects one mask, (B, out), and a 1-D
tensor of S indices every mask in one launch, (S, B, out):
``bank_matmul_inference`` when
fused, ``(x · bank[idx % n]) @ kernel`` when not. In training the batch
splits into ``num_masks`` groups, group g under mask g, unfused as in JAX.
This family computes in f32 whatever ``dtype`` is: a bf16 x times the f32
bank is f32 and the kernel is never cast (``fused.py:502-505``), and no
``1/(1-rate)`` scale applies.

With ``quant`` the kernel and bias are fake-quantized (QAT and the
fake-quant eval model). In the int8 model (``quant.int8_infer``, at
inference) x and the kernel are quantized to int8 and every MC head runs
``dropout_matmul_int8_inference`` (one ``dropout_matmul_int8_samples``
launch for S samples), every Masksembles head
``bank_matmul_int8_inference``; a head without a mask runs ``int8_matmul``
(``fused.py:524-540,560-563,573-580,595-613``).

x of shape (S, B, in) carries the sample axis (the activations after a
spatial conv site, one row of x per sample): sample s of x runs under
seeds[s] or index s, as JAX's ``lax.map`` fallback
(``masked_matmul.py:407-411``) runs one single kernel per sample. On the
card every fused head makes one ``_xs`` launch for the S samples; an
unfused one masks sample s of x under seeds[s] or row s.

On one rank's rows of a data-sharded batch (``nn.rows``) every site hands
its kernels ``row0``: the global row of x's first row for a head, the hash
row ``b0·H·W`` of its first pixel for a conv site (``image_row0``), so the
masks are those rows of the global batch's masks; the Masksembles training
split is the global batch's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.core.quant import (dequantize_int8, fake_quant, int8_step,
                                       quantize_int8, unsigned)
from bayestpu_torch.kernels.epilogue import bias_act_bf16
from bayestpu_torch.kernels.masked_conv import (
    bank_conv_inference, bank_conv_int8_inference, conv_int8_fused,
    dropout_conv, dropout_conv_inference, dropout_conv_int8_inference,
    conv_geometry, image_row0, mask_apply_nhwc)
from bayestpu_torch.kernels.masked_matmul import (
    bank_matmul_inference, bank_matmul_int8_inference, dropout_matmul,
    dropout_matmul_inference, dropout_matmul_int8_inference, matmul_f32)
from bayestpu_torch.nn.bayes import (BayesianDropout, apply_row, batch_split,
                                     make_bank)
from bayestpu_torch.nn.layers import (_Conv, _int8_conv_on_mxu, dot,
                                      lecun_normal_, maybe_quant, quant_dot,
                                      quant_operands, xla_conv_int8,
                                      xla_conv_raw)
from bayestpu_torch.nn.rows import RowAware
from bayestpu_torch.utils.profiler import count, span


class BayesDense(RowAware, nn.Module):
    def __init__(self, in_features: int, features: int,
                 bayes: BayesConfig = BayesConfig(), use_bias: bool = True,
                 fused: bool = True, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quant = quant
        self.fused = fused
        self.bayes = bayes
        self.dtype = dtype
        # a site draws masks only for MC at rate > 0 (as in the JAX layer)
        self.stochastic = bayes.kind is DropoutKind.MC and bayes.rate > 0.0
        self.masked = bayes.kind is DropoutKind.MASK
        self.drop = (BayesianDropout(bayes.rate)
                     if self.stochastic and not fused else None)
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        if self.masked:
            self.register_buffer("bank", make_bank(
                in_features, bayes.num_masks, bayes.scale))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None = None,
                sample_idx=0) -> torch.Tensor:
        """x: (B, in). An MC head takes seeds (2,) (or (S, 2) at inference)
        int32 on x's device; a Masksembles head takes ``sample_idx``, an int
        or at inference a 1-D integer tensor of S indices on x's device
        (unused in training); other heads ignore both. Returns (B, out) or
        (S, B, out) f32."""
        q = self.quant
        int8 = (q is not None and q.int8_infer and self.fused
                and not self.training and x.shape[-1] >= q.int8_dense_min_dim)
        if self.masked:
            y = self._bank_head(x, sample_idx, int8)
        elif not self.stochastic:
            y = quant_dot(x, self.kernel, q, self.dtype, int8)
        elif self.drop is not None:
            x, kernel, _ = quant_operands(x, self.kernel, q, False)
            y = dot(self.drop(x, seeds, carries_samples=x.dim() == 3),
                    kernel, self.dtype)
        else:
            x, kernel, steps = quant_operands(x, self.kernel, q, int8)
            if steps:
                y = dropout_matmul_int8_inference(
                    x.contiguous(), kernel.contiguous(), seeds,
                    self.bayes.rate, *steps, row0=self.rows.row0)
            else:
                mm = (dropout_matmul if self.training
                      else dropout_matmul_inference)
                y = mm(x.to(self.dtype).contiguous(),
                       kernel.to(self.dtype).contiguous(), seeds,
                       self.bayes.rate, row0=self.rows.row0)
        return y + maybe_quant(self.bias, q) if self.bias is not None else y

    def _bank_head(self, x: torch.Tensor, sample_idx, int8: bool
                   ) -> torch.Tensor:
        """The four Masksembles branches; x and the kernel keep their
        dtypes (f32 compute)."""
        x, kernel, steps = quant_operands(x, self.kernel, self.quant, int8)
        if self.training:
            return matmul_f32(batch_split(x, self.bank, rows=self.rows),
                              kernel)
        if steps:
            return bank_matmul_int8_inference(
                x.contiguous(), kernel.contiguous(), self.bank, sample_idx,
                *steps)
        if self.fused:
            return bank_matmul_inference(x.contiguous(), kernel.contiguous(),
                                         self.bank, sample_idx)
        return matmul_f32(apply_row(x, self.bank, sample_idx,
                                    carries_samples=x.dim() == 3), kernel)


# The least input channels for which a masked conv runs fused
# (``fused.py:84-98``): below it the JAX package routes the site unfused
# (the TPU kernels pad channels to 128 lanes), and the port follows its
# routing so that both run the same function.
MASKED_CONV_FUSE_MIN_CH = 32


def _masked_conv_fuse_worthwhile(in_ch: int) -> bool:
    return in_ch >= MASKED_CONV_FUSE_MIN_CH


def det_int8_on_kernel(q: QuantConfig, device: torch.device) -> bool:
    """Whether a deterministic int8 conv that a fused kernel takes runs
    ``conv_int8_fused`` on ``device`` (else ``int8_conv2d``): always on a
    card, on the CPU only under ``q.int8_det_pallas``, as the JAX package
    routes it."""
    return device.type == "cuda" or q.int8_det_pallas


class BayesConvInput(RowAware, nn.Module):
    """Dropout on a conv input, generated and applied in one pass
    (``fused.py:123-151``): ``dropout_apply`` on the (N·H·W, C) view, in
    x's dtype; rate 0 is the identity. Unfused (``fused=False``) it is the
    materialized ``BayesianDropout`` ``drop`` on the same seeds."""

    def __init__(self, rate: float = 0.25, fused: bool = True):
        super().__init__()
        self.rate = rate
        self.drop = None if fused else BayesianDropout(rate)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None = None
                ) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        if self.drop is not None:
            return self.drop(x, seeds)
        row0 = image_row0(self.rows.row0, x.shape[-2], x.shape[-1])
        return mask_apply_nhwc(x, seeds, self.rate, row0=row0).to(x.dtype)


class BayesConv(RowAware, _Conv):
    """(Bayesian mask → conv) with the mask fused into the conv kernel
    (``fused.py:154-496``): ``kernel`` (OIHW), for Masksembles the bank
    buffer ``bank``, and with ``use_bias`` a ``bias`` (fake-quantized under
    ``quant``, times the BN scale when one rides the epilogue, plus
    ``fold_bias``; ``ConvBN`` builds the conv without one, and its
    ``fold_bias`` feeds the epilogue).

    ``forward(x, seeds=, sample_idx=, fold_scale=, fold_bias=, act=,
    act_quant=, emit_int8=, defer_int8=, residual=)`` follows the JAX
    branches:

    - MC at rate > 0, fused (stride 1 or 2, SAME/VALID/explicit padding, at
      least ``MASKED_CONV_FUSE_MIN_CH`` input channels): training →
      ``dropout_conv`` on the ``dtype`` casts; inference →
      ``dropout_conv_inference`` with the BN fold and relu in the epilogue,
      bf16 out in a bf16 float model, or under ``quant.int8_infer`` int8
      out; an input wide enough for ``_int8_conv_on_mxu`` runs
      ``dropout_conv_int8_inference`` instead. Unfused (``fused=False``,
      a stride other than 1 or 2, or fewer input channels than
      ``MASKED_CONV_FUSE_MIN_CH``), the materialized ``BayesianDropout``
      ``drop`` (threefry masks, on this conv's own seeds) and then the
      conv, as JAX routes it.
    - Masksembles: training splits the batch (no kernel); inference runs
      ``bank_conv_inference`` (f32 out even in a bf16 model: the f32 folded
      kernel, never cast) or ``bank_conv_int8_inference``; unfused, ``x ·
      row`` then the conv.
    - no mask: the conv (``F.conv2d``, the JAX package's XLA conv) with the
      epilogue in PyTorch, or int8 × int8 for a wide int8 input. In a bf16
      float model at inference the epilogue of every conv whose kernel did
      not run it (no mask, an unfused site) is one pass over the conv's
      bf16 output, ``kernels.epilogue.bias_act_bf16``: a kernel on the
      card. An int8
      conv that a fused kernel takes (stride 1 or 2, at least
      ``MASKED_CONV_FUSE_MIN_CH`` input channels) runs ``conv_int8_fused``
      on the card, the epilogue and an int8 output inside the kernel; on
      the CPU it does so only under ``quant.int8_det_pallas``, as the JAX
      package routes it, and else runs ``int8_conv2d`` (im2col and
      ``torch._int_mm``) with the epilogue in PyTorch. The two round the
      epilogue differently (one fused multiply-add against two roundings),
      so the route follows the device and no knob picks it on the card.
      The counters ``quant.conv_kernel`` and ``quant.conv_im2col`` count
      the two int8 routes as a forward runs them, and
      ``sites.conv_launches`` each fused masked conv (MC or Masksembles),
      one launch of its kernel on the card.

    A fused branch applies the bias to the f32 accumulator and emits int8
    in the kernel whatever ``defer_int8`` says; the other paths round a
    bf16 conv to bf16 before the bias, as XLA does. ``residual`` (a
    residual block's last conv, bf16) makes the output ``relu(y +
    residual)`` inside that one pass, and is taken only where
    ``joins_residual`` says so. ``seeds`` (2,) or (S,
    2) and ``sample_idx`` (an int or S indices) select one sample or S, as
    the kernels' ``_inference`` entries do; x of shape (S, N, C, H, W)
    carries the sample axis (one ``_xs`` launch; sample s of an unfused
    site under seeds[s] or row s).
    """

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 bayes: BayesConfig | None = None, fused: bool = True,
                 quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32,
                 quant_input: bool = True, use_bias: bool = False):
        bayes = bayes if bayes is not None else BayesConfig(
            kind=DropoutKind.NONE)
        masked = bayes.kind is DropoutKind.MASK
        super().__init__(in_ch, features, kernel_size, make_bank(
            in_ch, bayes.num_masks, bayes.scale) if masked else None)
        self.bayes, self.quant, self.dtype = bayes, quant, dtype
        self.quant_input = quant_input
        self.masked = masked
        self.stochastic = bayes.kind is DropoutKind.MC and bayes.rate > 0.0
        self.site = None
        self.stride = int(strides[0])
        if tuple(strides) != (self.stride, self.stride):
            raise ValueError(f"strides {tuple(strides)}: the port takes "
                             "equal strides")
        self.padding = padding
        conv_geometry(8, 8, *kernel_size, padding, self.stride)  # validates
        self.fusable = (fused and self.stride in (1, 2)
                        and _masked_conv_fuse_worthwhile(in_ch))
        self.drop = (BayesianDropout(bayes.rate)
                     if self.stochastic and not self.fusable else None)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @property
    def joins_residual(self) -> bool:
        """Whether ``forward`` takes ``residual=``: a bf16 float conv
        without a mask at inference, whose one-pass epilogue adds it; the
        caller adds it after every other conv."""
        return (self.dtype == torch.bfloat16 and not self.training
                and self.quant is None
                and not (self.masked or self.stochastic))

    def _xla_conv(self, x: torch.Tensor, kernel: torch.Tensor
                  ) -> torch.Tensor:
        """The conv in ``dtype``, not widened (``xla_conv_raw``)."""
        return xla_conv_raw(x, kernel, self.padding, self.stride, self.dtype)

    def forward(self, x: torch.Tensor, *, seeds: torch.Tensor | None = None,
                sample_idx=0, fold_scale: torch.Tensor | None = None,
                fold_bias: torch.Tensor | None = None, act: str | None = None,
                act_quant: bool = False, emit_int8: bool = False,
                defer_int8: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        train = self.training
        in_ch, spatial = x.shape[-3], x.shape[-2]
        kernel = self.kernel
        q = self.quant
        if fold_scale is not None and q is None:
            kernel = kernel * fold_scale[:, None, None, None]
        # under quant BN rides the epilogue in f32, never folded
        epi_scale = (fold_scale.float() if fold_scale is not None
                     and q is not None else None)
        int8_mode = q is not None and q.int8_infer and not train
        quantize_x = int8_mode and (x.dtype == torch.int8
                                    or self.quant_input)
        int8_exec = quantize_x and _int8_conv_on_mxu(in_ch, q, spatial)
        int8_fused = int8_exec and self.fusable
        if q is not None:
            with span("quant.weights", x.is_cuda):
                kernel = fake_quant(kernel, q)
                if quantize_x:
                    wq, ws = quantize_int8(kernel, q)
        if x.dtype == torch.int8 and q is None:
            raise ValueError("int8-residency input requires a quant config "
                             "on the consuming BayesConv")
        # conv bias (fake-quantized), times the BN scale, plus the BN shift
        bias_vec = None if self.bias is None else maybe_quant(self.bias, q)
        if epi_scale is not None and bias_vec is not None:
            bias_vec = bias_vec * epi_scale
        if fold_bias is not None:
            bias_vec = fold_bias if bias_vec is None else bias_vec + fold_bias
        out_step = (int8_step(q) if int8_mode and act == "relu"
                    and (act_quant or emit_int8) else None)
        if residual is not None and not self.joins_residual:
            raise ValueError("a residual joins only a bf16 float conv "
                             "without a mask at inference")
        out_dtype = (torch.bfloat16 if self.dtype == torch.bfloat16
                     and not train and q is None else None)
        kb = bias_vec
        if epi_scale is not None:
            kb = torch.stack([epi_scale, bias_vec if bias_vec is not None
                              else torch.zeros_like(epi_scale)])
        epi = dict(bias=kb, act=act, out_step=out_step, stride=self.stride)
        # the hash row of x's first pixel (of each sample's x)
        row0 = image_row0(self.rows.row0, x.shape[-2], x.shape[-1])
        if quantize_x:
            with span("quant.inputs", x.is_cuda):
                xq, xs = quantize_int8(x, q)

        def floats() -> torch.Tensor:
            # x as a float branch reads it (the int8 ones read xq alone): on
            # the grid the int8 branches consume when x is quantized
            if quantize_x:
                with span("quant.inputs", x.is_cuda):
                    return xq.float() * xs
            return dequantize_int8(x, q) if x.dtype == torch.int8 else x

        done = False               # the epilogue ran in the kernel
        if self.fusable and (self.stochastic or (self.masked and not train)):
            count("sites.conv_launches")      # a masked-conv kernel runs
        if self.masked:
            if train:
                y = self._xla_conv(batch_split(floats(), self.bank, -3,
                                               self.rows), kernel)
            elif int8_fused:
                y = bank_conv_int8_inference(xq, wq, self.bank, sample_idx,
                                             xs, ws, self.padding, **epi)
                done = True
            elif self.fusable:
                y = bank_conv_inference(floats(), kernel, self.bank,
                                        sample_idx, self.padding, **epi)
                done = True
            else:
                y = self._xla_conv(apply_row(
                    floats(), self.bank, sample_idx, -3,
                    carries_samples=x.dim() == 5), kernel)
        elif self.stochastic:
            if seeds is None:
                raise ValueError("an MC conv site needs its seeds")
            if self.drop is not None:
                y = self._xla_conv(self.drop(
                    floats(), seeds, carries_samples=x.dim() == 5), kernel)
            elif int8_fused:
                y = dropout_conv_int8_inference(
                    xq, wq, seeds, self.bayes.rate, xs, ws, self.padding,
                    row0=row0, **epi)
                done = True
            elif train:
                y = dropout_conv(floats().to(self.dtype),
                                 kernel.to(self.dtype), seeds,
                                 self.bayes.rate, self.padding, self.stride,
                                 row0)
            else:
                y = dropout_conv_inference(
                    floats().to(self.dtype), kernel.to(self.dtype), seeds,
                    self.bayes.rate, self.padding, out_dtype=out_dtype,
                    row0=row0, **epi)
                done = True
        elif int8_fused and det_int8_on_kernel(q, x.device):
            count("quant.conv_kernel")
            y = conv_int8_fused(
                xq.contiguous(memory_format=torch.channels_last), wq, xs, ws,
                padding=self.padding, **epi)
            done = True
        elif int8_exec:
            count("quant.conv_im2col")
            y = xla_conv_int8(xq, wq, self.padding, self.stride).float() * (
                xs * ws)
        else:
            y = self._xla_conv(floats(), kernel)
        if not done and out_dtype is not None:
            # a bf16 float model at inference (no quant: no BN scale, no
            # int8 store): the conv's bf16 output, the bias, relu and the
            # residual's relu(y + residual) in one pass
            return bias_act_bf16(y, bias_vec, act, residual)
        if not done:
            # the epilogue of the paths that did not fuse it (``:465-496``)
            y = y.float()
            if epi_scale is not None:
                y = y * epi_scale[:, None, None]
            if bias_vec is not None:
                y = y + bias_vec[:, None, None]
            if act == "relu":
                y = torch.relu(y)
            if out_step is not None:
                if defer_int8:
                    return fake_quant(y, unsigned(q)).to(torch.bfloat16)
                with span("quant.inputs", y.is_cuda):
                    return quantize_int8(y, q)[0]
        # QuantAct on the fake-quant model, after a fused kernel too
        if (out_step is None and act_quant and q is not None
                and act is not None):
            y = fake_quant(y, unsigned(q))
        return y
