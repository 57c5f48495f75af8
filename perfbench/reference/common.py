"""What the plain references share: the counter-hash masks and seeds, the
ap_fixed rounding, the precision a reference computes in, and the layers.

Frozen copies of the semantics the configurations state, written from the
published description of each piece and kept apart from the program: this
package imports torch and numpy only.

- Masks. An MC-dropout site keeps element (r, c) of its input (r the row in
  the batch, c the column of the NHWC-flattened features) iff a uint32
  counter hash of (r, c, the site's seed pair) lies under (1 - rate)·2^32;
  kept elements are scaled by 1/(1 - rate). The seed pair of sample s and
  site j is the same hash of (s, 2j + word) under the stream of the 64-bit
  request seed; a training step's pairs use the step as the counter and
  words from 2^31 on.
- ap_fixed<W, I> (QKeras ``quantized_bits(W, I, alpha=1)``): step
  2^(I - W + 1), round to nearest with ties away from zero, clip to
  [-2^(W-1), 2^(W-1) - 1] steps (unsigned: from 0).
- Precision. ``Numerics("f32")`` is the reference itself: f32 with TF32
  off, integer sums in f64 so that they are exact. ``Numerics("fp8")`` is
  fp8 training's recipe: every operand of a conv or matmul rounded to
  float8 e4m3, and the gradient that reaches it to e5m2, each under a
  per-tensor scale (its amax to the format's largest value); it is the
  control of a bf16 configuration. An int8 configuration's control is the
  same reference on a 4-bit grid.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
STEP_WORD0 = 1 << 31
FP8 = ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0))


# ------------------------------------------------------------------ hash


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.int64) & M32


def stream_of(s0, s1) -> torch.Tensor:
    """The stream constant of a seed pair (int32 words, taken as uint32)."""
    return _mix(_mul32(_u32(s0), 0x9E3779B1) ^ _mul32(_u32(s1), 0x85EBCA77)
                ^ 0xC2B2AE35)


def hash_bits(row, col, stream) -> torch.Tensor:
    """Uniform uint32 bits (held in int64) of (row, col) under a stream."""
    row, col, stream = _u32(row), _u32(col), _u32(stream)
    x = _mix(_mul32(row, 0x27D4EB2F) ^ col ^ stream)
    return _mix(x ^ _mul32(col, 0x165667B1))


def keep_threshold(rate: float) -> int:
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _pairs(seed: int, counter: torch.Tensor, num_sites: int, word0: int
           ) -> torch.Tensor:
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    stream = stream_of(s & M32, s >> 32)
    word = (word0 + 2 * torch.arange(num_sites, dtype=torch.int64)[:, None]
            + torch.arange(2, dtype=torch.int64)[None, :])
    bits = hash_bits(counter[..., None, None], word, stream)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def sample_pairs(seed: int, num_samples: int, num_sites: int
                 ) -> torch.Tensor:
    """(S, num_sites, 2) int32 seed pairs of a request seed."""
    return _pairs(seed, torch.arange(num_samples, dtype=torch.int64),
                  num_sites, 0)


def step_pairs(seed: int, step: int, num_sites: int) -> torch.Tensor:
    """(num_sites, 2) int32 seed pairs of training step ``step``."""
    return _pairs(seed, torch.tensor(int(step), dtype=torch.int64),
                  num_sites, STEP_WORD0)


def keep_mask(pair: torch.Tensor, rows: int, cols: int, rate: float,
              device) -> torch.Tensor:
    """(rows, cols) bool: which elements of a (rows, cols) input one seed
    pair keeps."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    pair = pair.to(device)
    return hash_bits(r, c, stream_of(pair[0], pair[1])) < keep_threshold(
        rate)


# ------------------------------------------------------------- ap_fixed


@dataclasses.dataclass(frozen=True)
class Grid:
    """ap_fixed<total_bits, integer_bits>, signed or not."""

    total_bits: int
    integer_bits: int
    signed: bool = True

    @property
    def step(self) -> float:
        return 2.0 ** (self.integer_bits - self.total_bits + 1)

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """The integer codes (as floats) of x on the grid: AP_RND of
        x/step, clipped."""
        s = x / self.step
        r = torch.trunc(s + torch.where(s >= 0, 0.5, -0.5))
        lo = -(2.0 ** (self.total_bits - 1)) if self.signed else 0.0
        return torch.clamp(r, lo, 2.0 ** (self.total_bits - 1) - 1.0)

    def values(self, x: torch.Tensor) -> torch.Tensor:
        return self.codes(x) * self.step

    def unsigned(self) -> "Grid":
        return dataclasses.replace(self, signed=False)


# ------------------------------------------------------------ numerics


@dataclasses.dataclass(frozen=True)
class Numerics:
    """The precision of a reference run: ``kind`` "f32" or "fp8", and for
    a quantized configuration its grid (None: a float configuration)."""

    kind: str = "f32"
    grid: Grid | None = None

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a conv or matmul as this precision sees it (and
        its gradient as this precision hands it back)."""
        return t if self.kind == "f32" else _Fp8.apply(t)


def fp8_round(t: torch.Tensor, fmt: int) -> torch.Tensor:
    """t rounded to FP8[fmt] under a per-tensor scale."""
    dtype, largest = FP8[fmt]
    scale = largest / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return fp8_round(t, 0)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, 1)


def f32_mode() -> None:
    """f32 means f32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- layers


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
         num: Numerics) -> torch.Tensor:
    """A float conv of NCHW x with OIHW w, zero padding ``pad`` each side."""
    return F.conv2d(num.operand(x), num.operand(w), stride=stride,
                    padding=pad)


def conv_codes(xc: torch.Tensor, wc: torch.Tensor, stride: int, pad: int
               ) -> torch.Tensor:
    """The exact sum of integer codes (f64), as f32."""
    return F.conv2d(xc.double(), wc.double(), stride=stride,
                    padding=pad).float()


def bn_eval(y: torch.Tensor, p: dict, prefix: str, eps: float = 1e-5
            ) -> torch.Tensor:
    """BatchNorm on running statistics over dim 1."""
    shape = (1, -1) + (1,) * (y.dim() - 2)
    mul = torch.rsqrt(p[prefix + ".var"] + eps) * p[prefix + ".scale"]
    return ((y - p[prefix + ".mean"].view(shape)) * mul.view(shape)
            + p[prefix + ".bias"].view(shape))


def bn_train(y: torch.Tensor, p: dict, prefix: str, eps: float = 1e-5
             ) -> torch.Tensor:
    """BatchNorm on the batch's statistics (biased variance) over dim 1."""
    axes = [d for d in range(y.dim()) if d != 1]
    shape = (1, -1) + (1,) * (y.dim() - 2)
    mean = y.mean(axes)
    var = torch.clamp_min((y * y).mean(axes) - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * p[prefix + ".scale"]
    return ((y - mean.view(shape)) * mul.view(shape)
            + p[prefix + ".bias"].view(shape))


def flatten_nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)


def mc_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             pairs: torch.Tensor, rate: float, num: Numerics
             ) -> torch.Tensor:
    """MC dropout on x (B, K) under each sample's seed pair, then x @ w + b:
    (S, B, N). ``pairs`` (S, 2); one pair (2,) gives (B, N)."""
    single = pairs.dim() == 1
    pairs = pairs[None] if single else pairs
    outs = []
    wq = num.operand(w)
    for pair in pairs:
        keep = keep_mask(pair, x.shape[0], x.shape[1], rate, x.device)
        xm = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
        outs.append(num.operand(xm) @ wq + b)
    return outs[0] if single else torch.stack(outs)


def mc_dense_grid(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  pairs: torch.Tensor, rate: float, grid: Grid
                  ) -> torch.Tensor:
    """The same on the grid: x and w rounded to it, the masked sum of codes
    exact, rescaled by step²/(1 - rate); the bias on the grid too."""
    xc, wc = grid.codes(x).double(), grid.codes(w).double()
    bq = grid.values(b)
    outs = []
    for pair in pairs:
        keep = keep_mask(pair, x.shape[0], x.shape[1], rate, x.device)
        acc = torch.where(keep, xc, torch.zeros_like(xc)) @ wc
        outs.append((acc * (grid.step * grid.step / (1.0 - rate))).float()
                    + bq)
    return torch.stack(outs)


def predictive(logits: torch.Tensor) -> dict:
    """The MC predictive of (S, E, B, C) logits: the mean of the softmax,
    its variance over samples (ddof 0) and the entropy of the mean."""
    p = torch.softmax(logits, dim=-1)
    mean = p.mean(0)
    return {"probs": mean, "var": p.var(0, correction=0),
            "entropy": -torch.sum(mean * torch.log(mean + 1e-12), dim=-1)}
