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
"""

from __future__ import annotations

import torch
from torch import nn

from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.kernels.masked_matmul import (dropout_matmul,
                                                  dropout_matmul_inference)
from bayestpu_torch.nn.layers import _QUANT_TODO, dot, lecun_normal_


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
        if quant is not None:
            raise NotImplementedError(_QUANT_TODO)
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
        if self.stochastic:
            mm = dropout_matmul if self.training else dropout_matmul_inference
            y = mm(x.to(self.dtype).contiguous(),
                   self.kernel.to(self.dtype).contiguous(), seeds,
                   self.bayes.rate)
        else:
            y = dot(x, self.kernel, self.dtype)
        return y + self.bias if self.bias is not None else y
