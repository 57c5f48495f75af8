"""``BayesDense``: a Bayesian mask site fused into the dense layer after it.

Counterpart of ``bayestpu.nn.fused.BayesDense`` (``fused.py:499-614``): the
MC-dropout, Masksembles and no-dropout branches, in training and at
inference.

MC dropout at rate > 0: the mask is generated inside the CUDA matmul
kernel (``bayestpu_torch.kernels.masked_matmul``). At inference seeds of
shape (2,) run one sample and seeds of shape (S, 2) run all S samples in
one launch (the spatial mapping). In training (``self.training``) the seeds
are (2,) and the head goes through the trainable ``dropout_matmul``, whose
backward regenerates the mask (``fused.py:581-588``). Under bf16 both x and
the kernel are cast to bf16 and the f32 bias is added to the f32 product.

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
"""

from __future__ import annotations

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.kernels.masked_matmul import (
    bank_matmul_inference, bank_matmul_int8_inference, dropout_matmul,
    dropout_matmul_inference, dropout_matmul_int8_inference, matmul_f32)
from bayestpu_torch.nn.bayes import apply_row, batch_split, make_bank
from bayestpu_torch.nn.layers import (lecun_normal_, maybe_quant, quant_dot,
                                      quant_operands)


class BayesDense(nn.Module):
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
        if self.stochastic and not fused:
            raise NotImplementedError(
                "the unfused MC head (BayesianDropout + dense) is not ported "
                "yet: ROADMAP Queue 1 item 3")
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
        else:
            x, kernel, steps = quant_operands(x, self.kernel, q, int8)
            if steps:
                y = dropout_matmul_int8_inference(
                    x.contiguous(), kernel.contiguous(), seeds,
                    self.bayes.rate, *steps)
            else:
                mm = (dropout_matmul if self.training
                      else dropout_matmul_inference)
                y = mm(x.to(self.dtype).contiguous(),
                       kernel.to(self.dtype).contiguous(), seeds,
                       self.bayes.rate)
        return y + maybe_quant(self.bias, q) if self.bias is not None else y

    def _bank_head(self, x: torch.Tensor, sample_idx, int8: bool
                   ) -> torch.Tensor:
        """The four Masksembles branches; x and the kernel keep their
        dtypes (f32 compute)."""
        x, kernel, steps = quant_operands(x, self.kernel, self.quant, int8)
        if self.training:
            return matmul_f32(batch_split(x, self.bank), kernel)
        if steps:
            return bank_matmul_int8_inference(
                x.contiguous(), kernel.contiguous(), self.bank, sample_idx,
                *steps)
        if self.fused:
            return bank_matmul_inference(x.contiguous(), kernel.contiguous(),
                                         self.bank, sample_idx)
        return matmul_f32(apply_row(x, self.bank, sample_idx), kernel)
