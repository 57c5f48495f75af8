"""Fixed-point quantization on the ap_fixed grid (counterpart of
``bayestpu/core/quant.py:34-101``).

QKeras ``quantized_bits(total_bits, integer_bits, alpha=1)`` semantics:

    step = 2^(integer_bits - total_bits + 1)
    q(x) = clip(AP_RND(x / step), lo, 2^(total_bits-1) - 1) * step

with ``lo = -2^(total_bits-1)`` (signed) or 0 (``keep_negative=False``, the
unsigned grid of ``quantized_relu``). AP_RND rounds to nearest with ties away
from zero, ``trunc(s + (s >= 0 ? 0.5 : -0.5))``; ``torch.round`` rounds ties to
even and is used only for another ``round_mode``, as JAX's ``jnp.round``.
The straight-through estimator is ``x + (q - x).detach()`` in that order
(``x + stop_gradient(q - x)``): its value may differ from ``q`` in the last
bit, and the port keeps that.

The int8 inference path keeps values as int8 on the grid of step
``2^(integer_bits-7)`` and contracts int8 × int8 → int32 exactly
(``torch._int_mm``: cuBLASLt's s8 GEMM on the card, the JAX package's XLA
``dot_general``), rescaling once in f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from bayestpu_torch.core.config import QuantConfig
from bayestpu_torch.utils.profiler import span


def _round_ap_rnd(x: torch.Tensor) -> torch.Tensor:
    """AP_RND: round to nearest, ties away from zero, in x's dtype."""
    half = torch.full_like(x, 0.5)
    return torch.trunc(x + torch.where(x >= 0, half, -half))


def fake_quant(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Fake-quantize to the ``quantized_bits`` grid with a straight-through
    estimator (identity gradient), for quantization-aware training."""
    step = 2.0 ** (cfg.integer_bits - cfg.total_bits + 1)
    lo = -(2.0 ** (cfg.total_bits - 1)) if cfg.keep_negative else 0.0
    hi = 2.0 ** (cfg.total_bits - 1) - 1.0
    scaled = x / step
    r = (_round_ap_rnd(scaled) if cfg.round_mode == "AP_RND"
         else torch.round(scaled))
    q = torch.clamp(r, lo, hi) * step
    return x + (q - x).detach()


def unsigned(cfg: QuantConfig) -> QuantConfig:
    """The unsigned grid of ``quantized_relu`` with the same total bits."""
    return dataclasses.replace(cfg, keep_negative=False)


def int8_step(cfg: QuantConfig) -> float:
    """The static LSB weight of the int8 ap_fixed grid, 2^(ibits-7)."""
    if cfg.total_bits != 8:
        raise ValueError("int8 path requires total_bits == 8")
    return 2.0 ** (cfg.integer_bits - 7)


def quantize_int8(x: torch.Tensor, cfg: QuantConfig
                  ) -> tuple[torch.Tensor, float]:
    """``(values_int8, step)`` with ``x ≈ values * step``. An int8 input is
    already on the grid and passes through."""
    step = int8_step(cfg)
    if x.dtype == torch.int8:
        return x, step
    q = torch.clamp(_round_ap_rnd(x / step), -128, 127).to(torch.int8)
    return q, step


def dequantize_int8(x: torch.Tensor, cfg: QuantConfig,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 on the grid → float (exact: every grid point fits f32)."""
    return x.to(dtype) * int8_step(cfg)


def dequantize(x_q: torch.Tensor, step: float,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return x_q.to(dtype) * step


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) × int8 (K, N) → int32 (M, N) through
    ``torch._int_mm``. On the card it needs M > 16 and K, N multiples of 8,
    so the operands are zero-padded to that and the result sliced: zero rows
    and columns add nothing to an integer sum. ``b`` is handed over
    column-major, the layout cuBLASLt's s8 GEMM is built for."""
    m, k = a.shape
    n = b.shape[1]
    pk, pm, pn = (-k) % 8, max(0, 17 - m), (-n) % 8
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n] if (pm or pn) else out


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_step: float,
                w_step: float, out_dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """int8 × int8 → int32 over the last axis of ``x_q``, then one rescale
    by ``x_step * w_step``."""
    lead = x_q.shape[:-1]
    acc = int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    return acc.reshape(lead + (w_q.shape[1],)).to(out_dtype) * (
        x_step * w_step)


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor,
                stride: tuple[int, int], padding: tuple[int, int]
                ) -> torch.Tensor:
    """Exact int8 convolution → int32: x_q (B, C, H, W) int8, w_q (O, C, KH,
    KW) int8, symmetric zero ``padding``. PyTorch has no int8 convolution,
    so this is an im2col of the padded input (``Tensor.unfold`` views,
    flattened in (C, KH, KW) order as the OIHW kernel and materialised: the
    span ``quant.im2col``) times ``int_mm``; the result (B, O, Ho, Wo) is
    the JAX package's ``conv_general_dilated(...,
    preferred_element_type=int32)``."""
    b = x_q.shape[0]
    o, c, kh, kw = w_q.shape
    ph, pw = padding
    with span("quant.im2col", x_q.is_cuda):
        xp = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
        cols = xp.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
        ho, wo = cols.shape[1], cols.shape[2]
        cols = cols.reshape(b * ho * wo, c * kh * kw).contiguous()
    acc = int_mm(cols, w_q.reshape(o, c * kh * kw).t())
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)
