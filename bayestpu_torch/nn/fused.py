"""``BayesDense``: an MC-dropout site fused into the dense layer after it.

Counterpart of ``bayestpu.nn.fused.BayesDense`` (``fused.py:499-614``), the
MC and no-dropout branches, in training and at inference. With MC dropout at
rate > 0 the mask is generated inside the CUDA matmul kernel
(``bayestpu_torch.kernels.masked_matmul``). At inference seeds of shape (2,)
run one sample and seeds of shape (S, 2) run all S samples in one launch
(the spatial mapping). In training (``self.training``) the seeds are (2,)
and the head goes through the trainable ``dropout_matmul``, whose backward
regenerates the mask (``fused.py:581-588``). Under bf16 both x and the
kernel are cast to bf16 and the f32 bias is added to the f32 product.

With ``quant`` the kernel and bias are fake-quantized (QAT and the
fake-quant eval model). In the int8 model (``quant.int8_infer``, at
inference) x and the kernel are quantized to int8 and every MC head runs
``dropout_matmul_int8_inference`` (one ``dropout_matmul_int8_samples``
launch for S samples); a head without a mask runs ``int8_matmul``
(``fused.py:524-540,573-580,595-613``).
"""

from __future__ import annotations

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.kernels.masked_matmul import (
    dropout_matmul, dropout_matmul_inference, dropout_matmul_int8_inference)
from bayestpu_torch.nn.layers import (lecun_normal_, maybe_quant, quant_dot,
                                      quant_operands)


class BayesDense(nn.Module):
    def __init__(self, in_features: int, features: int,
                 bayes: BayesConfig = BayesConfig(), use_bias: bool = True,
                 fused: bool = True, quant: QuantConfig | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if bayes.kind is DropoutKind.MASK:
            raise NotImplementedError(
                "Masksembles heads are not ported yet: ROADMAP Queue 1 "
                "item 9")
        self.quant = quant
        self.fused = fused
        self.bayes = bayes
        self.dtype = dtype
        # a site draws masks only for MC at rate > 0 (as in the JAX layer)
        self.stochastic = bayes.kind is DropoutKind.MC and bayes.rate > 0.0
        if self.stochastic and not fused:
            raise NotImplementedError(
                "the unfused MC head (BayesianDropout + dense) is not ported "
                "yet: ROADMAP Queue 1 item 3")
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, seeds: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x: (B, in); seeds: (2,) (or (S, 2) at inference) int32 on x's
        device for a stochastic head, ignored otherwise. Returns (B, out) or
        (S, B, out) f32."""
        q = self.quant
        int8 = (q is not None and q.int8_infer and self.fused
                and not self.training and x.shape[-1] >= q.int8_dense_min_dim)
        if not self.stochastic:
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
