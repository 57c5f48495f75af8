"""Matmul with the MC-dropout mask fused in: plain PyTorch versions and the
wrappers of the CUDA kernels in ``bayestpu_torch/csrc/masked_matmul.cu``.

Counterpart of ``bayestpu/kernels/masked_matmul.py``: ``dropout_matmul``
(trainable, with the backward that regenerates the mask through
``dropout_apply``), ``dropout_matmul_samples``, ``dropout_matmul_inference``
and their int8 twins ``dropout_matmul_int8``, ``dropout_matmul_int8_samples``
and ``dropout_matmul_int8_inference`` (``:430-637``). The mask of element ``(r, c)`` of x is a pure
counter hash of ``(seeds, r, c)`` — the global, unpadded coordinates — so
every kernel, tiling and sample mapping reproduces it bit for bit, and so
does the JAX package: an element is kept iff
``coord_bits(r, c, seed_stream(s0, s1)) < keep_threshold(rate)``, all in
uint32 with wraparound. The plain versions compute those bits in int64 with
``& 0xFFFFFFFF`` after every multiply.

Scaling follows the JAX kernels exactly. In the forward kernels the Python
scale ``1/(1-rate)`` is first rounded to x's dtype (bf16: 1.3359375 for rate
0.25, not 1.3333), ``x * scale`` is rounded to x's dtype, and the product
with w is accumulated in f32. ``dropout_apply`` (the backward's mask) casts
x to f32 first and multiplies by the f32 scale (1.3333334 at rate 0.25)
whatever x's dtype, as ``_dropout_mask_kernel`` does; the two scales differ
under bf16 in the JAX package too. The int8 functions mask the int8 x
with the same bits, accumulate int8 × int8 exactly in int32 and return
``f32(acc) * out_scale``, ``out_scale`` being the f32 nearest to the Python
double ``x_step * w_step / (1 - rate)``, as JAX's weak-typed constant: they
equal the JAX kernels bit for bit.

Dispatch is by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel (or raise), and any other device raises. There is
no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bayestpu_torch.core.quant import int_mm

_M32 = 0xFFFFFFFF
_DTYPES = (torch.float32, torch.bfloat16)

# Launches of each CUDA kernel since the last reset; CPU calls do not count.
launch_counts: dict[str, int] = {"dropout_matmul": 0,
                                 "dropout_matmul_samples": 0,
                                 "dropout_apply": 0,
                                 "dropout_matmul_int8": 0,
                                 "dropout_matmul_int8_samples": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ------------------------------------------------------------------ PRNG


def keep_threshold(rate: float) -> int:
    """keep iff bits < keep_prob * 2^32 (uint32 compare)."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a uint32
    constant, split in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3/triple32-style avalanche finalizer on uint32 values held in
    int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u32(v) -> torch.Tensor:
    """int32 (or any integer) values reinterpreted as uint32, in int64."""
    return torch.as_tensor(v).to(torch.int64) & _M32


def seed_stream(s0, s1) -> torch.Tensor:
    """Per-(seed pair) stream constant mixed into every element's counter.
    Seeds are int32 and reinterpreted as uint32, so negative seeds work."""
    return mix(_mul32(_u32(s0), 0x9E3779B1) ^ _mul32(_u32(s1), 0x85EBCA77)
               ^ 0xC2B2AE35)


def coord_bits(grow, gcol, stream) -> torch.Tensor:
    """Uniform uint32 bits (in int64) as a pure function of (global row,
    global col, stream)."""
    grow, gcol, stream = _u32(grow), _u32(gcol), _u32(stream)
    x = mix(_mul32(grow, 0x27D4EB2F) ^ gcol ^ stream)
    return mix(x ^ _mul32(gcol, 0x165667B1))


def keep_mask(seeds: torch.Tensor, m: int, k: int, rate: float
               ) -> torch.Tensor:
    """(m, k) bool keep mask of one seed pair, on the seeds' device."""
    rows = torch.arange(m, dtype=torch.int64, device=seeds.device)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=seeds.device)[None, :]
    return coord_bits(rows, cols, seed_stream(seeds[0], seeds[1])) \
        < keep_threshold(rate)


def scale_of(rate: float, dtype: torch.dtype) -> float:
    """The dropout scale ``1/(1-rate)`` as the kernels apply it: rounded to
    the compute dtype first, as JAX turns the Python scale into a constant
    of x's dtype."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def apply_scale(rate: float) -> float:
    """The scale of ``dropout_apply``: ``1/(1-rate)`` rounded to f32 for
    every input dtype (``_dropout_mask_kernel`` multiplies an f32 cast)."""
    return scale_of(rate, torch.float32)


# -------------------------------------------------------- plain versions


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32: bf16 products are exact in f32."""
    return torch.matmul(x.float(), w.float())


def dropout_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """``dropout(x) @ w`` in plain PyTorch on any device: (M, N) f32."""
    if rate == 0.0:
        return matmul_f32(x, w)
    keep = keep_mask(seeds, x.shape[0], x.shape[1], rate)
    scale = torch.tensor(scale_of(rate, x.dtype), dtype=x.dtype,
                         device=x.device)
    xm = torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return matmul_f32(xm, w)


def dropout_matmul_samples_plain(x: torch.Tensor, w: torch.Tensor,
                                 seeds: torch.Tensor, rate: float
                                 ) -> torch.Tensor:
    """All S samples in plain PyTorch: (S, M, N) f32, sample s equal to
    ``dropout_matmul_plain(x, w, seeds[s], rate)`` bit for bit."""
    num_samples = seeds.shape[0]
    if rate == 0.0:
        y = matmul_f32(x, w)
        return y.expand((num_samples,) + tuple(y.shape))
    return torch.stack([dropout_matmul_plain(x, w, seeds[s], rate)
                        for s in range(num_samples)])


def dropout_apply_plain(x: torch.Tensor, seeds: torch.Tensor,
                        rate: float) -> torch.Tensor:
    """``dropout(x)`` alone in plain PyTorch: (M, K) f32, the forward's mask
    times the f32 scale."""
    keep = keep_mask(seeds, x.shape[0], x.shape[1], rate)
    scale = torch.tensor(apply_scale(rate), dtype=torch.float32,
                         device=x.device)
    return torch.where(keep, x.float() * scale,
                       torch.zeros((), dtype=torch.float32, device=x.device))


def dropout_matmul_vjp_plain(x: torch.Tensor, w: torch.Tensor,
                             seeds: torch.Tensor, rate: float,
                             g: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``dropout(x) @ w`` for the f32 cotangent g (M, N), in
    plain PyTorch: ``dx = dropout(g @ wᵀ)`` and ``dw = dropout(x)ᵀ @ g``,
    both f32 products rounded to x's and w's dtype at the end
    (``masked_matmul.py:252-266``)."""
    g = g.float()
    if rate == 0.0:
        return (torch.matmul(g, w.float().T).to(x.dtype),
                torch.matmul(x.float().T, g).to(w.dtype))
    gx = torch.matmul(g, w.float().T)
    dx = dropout_apply_plain(gx, seeds, rate).to(x.dtype)
    dw = torch.matmul(dropout_apply_plain(x, seeds, rate).T, g).to(w.dtype)
    return dx, dw


# -------------------------------------------------------------- wrappers


def _check_rate_seeds(x: torch.Tensor, seeds: torch.Tensor, seeds_ndim: int,
                      rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1): {rate}")
    if (seeds.dtype != torch.int32 or seeds.dim() != seeds_ndim
            or seeds.shape[-1] != 2):
        want = "(2,)" if seeds_ndim == 1 else "(S, 2)"
        raise ValueError(f"seeds must be int32 of shape {want}; got "
                         f"{seeds.dtype} {tuple(seeds.shape)}")
    if x.device != seeds.device:
        raise ValueError(f"x and seeds must be on one device; got "
                         f"{x.device} and {seeds.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}: the port runs "
                         "its kernels on CUDA and their plain versions on "
                         "the CPU")


def _check(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
           seeds_ndim: int, rate: float) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x and w must be on one device; got {x.device} "
                         f"and {w.device}")
    _check_rate_seeds(x, seeds, seeds_ndim, rate)


def _call(name: str, device: torch.device, tensors: dict, args: list
          ) -> None:
    """Call the C entry ``bt_<name>`` of ``masked_matmul.cu`` with the
    pointers of ``tensors`` (each must be contiguous), then ``args``, then
    PyTorch's current stream; count the launch."""
    from bayestpu_torch.kernels import _build

    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    lib = _build.library("masked_matmul")
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors.values()]
        rc = getattr(lib, "bt_" + name)(*ptrs, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed to launch: cudaError_t "
                           f"{rc}")
    launch_counts[name] += 1


def _launch(name: str, x: torch.Tensor, w: torch.Tensor,
            seeds: torch.Tensor, args: list) -> torch.Tensor:
    """Launch one of the matmul kernels on PyTorch's current stream with
    the trailing C arguments ``args``. ``seeds`` is (S, 2); a single-sample
    kernel is called with S == 1 and returns (M, N), a samples kernel
    (S, M, N)."""
    m, k = x.shape
    n = w.shape[1]
    s = seeds.shape[0]
    single = not name.endswith("_samples")
    out = torch.empty((m, n) if single else (s, m, n), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    _call(name, x.device, {"x": x, "w": w, "seeds": seeds, "out": out},
          [m, k, n] + ([] if single else [s]) + args)
    return out


def _float_args(x: torch.Tensor, rate: float) -> list:
    return [keep_threshold(rate), scale_of(rate, x.dtype),
            int(x.dtype == torch.bfloat16)]


def dropout_apply(x: torch.Tensor, seeds: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """``dropout(x)`` alone: x (M, K) f32/bf16, seeds (2,) int32 on x's
    device. Returns (M, K) f32 with the forward kernels' mask bit for bit,
    scaled by the f32 ``1/(1-rate)`` (``_dropout_apply``)."""
    if x.dim() != 2:
        raise ValueError(f"need x (M, K); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    _check_rate_seeds(x, seeds, 1, rate)
    if x.device.type == "cpu":
        return dropout_apply_plain(x, seeds, rate)
    m, k = x.shape
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _call("dropout_apply", x.device, {"x": x, "seeds": seeds, "out": out},
          [m, k, keep_threshold(rate), apply_scale(rate),
           int(x.dtype == torch.bfloat16)])
    return out


class DropoutMatmul(torch.autograd.Function):
    """``dropout(x) @ w`` with the backward that regenerates the mask from
    the seeds instead of storing it (``jax.custom_vjp`` of
    ``masked_matmul.py:179-269``). It saves x, w and seeds. Its backward
    runs ``dx = dropout(g @ wᵀ)`` and ``dw = dropout(x)ᵀ @ g``: the two f32
    products by ``torch.matmul`` (XLA's ``jnp.dot`` in the JAX package),
    the masks by ``dropout_apply``; dx and dw are rounded to x's and w's
    dtype, so under bf16 both reach the f32 parameters bf16-rounded."""

    @staticmethod
    def forward(ctx, x, w, seeds, rate):
        ctx.save_for_backward(x, w, seeds)
        ctx.rate = rate
        if x.device.type == "cpu" or rate == 0.0:
            return dropout_matmul_plain(x, w, seeds, rate)
        return _launch("dropout_matmul", x, w, seeds.reshape(1, 2),
                       _float_args(x, rate))

    @staticmethod
    def backward(ctx, g):
        x, w, seeds = ctx.saved_tensors
        rate = ctx.rate
        need_x, need_w = ctx.needs_input_grad[:2]
        g = g.float().contiguous()
        dx = dw = None
        if rate == 0.0:
            if need_x:
                dx = torch.matmul(g, w.float().T).to(x.dtype)
            if need_w:
                dw = torch.matmul(x.float().T, g).to(w.dtype)
            return dx, dw, None, None
        if need_x:
            dx = dropout_apply(torch.matmul(g, w.float().T), seeds,
                               rate).to(x.dtype)
        if need_w:
            dw = torch.matmul(dropout_apply(x, seeds, rate).T, g).to(w.dtype)
        return dx, dw, None, None


def dropout_matmul(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """``dropout(x) @ w`` with the mask fused into the kernel; trainable
    through ``DropoutMatmul``.

    x: (M, K) f32/bf16; w: (K, N) of x's dtype; seeds: (2,) int32 on x's
    device. Returns (M, N) f32. Rate 0 is a plain matmul.
    """
    _check(x, w, seeds, 1, rate)
    return DropoutMatmul.apply(x, w, seeds, rate)


def dropout_matmul_samples(x: torch.Tensor, w: torch.Tensor,
                           seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """All-samples fused MC head: ``stack([dropout_s(x) @ w for s in S])``.

    seeds: (S, 2) int32. Returns (S, M, N) f32 with sample s bit-identical to
    ``dropout_matmul(x, w, seeds[s], rate)`` on the same device. The kernel
    stages each x tile once for all samples of a block.
    """
    _check(x, w, seeds, 2, rate)
    if x.device.type == "cpu" or rate == 0.0:
        return dropout_matmul_samples_plain(x, w, seeds, rate)
    return _launch("dropout_matmul_samples", x, w, seeds,
                   _float_args(x, rate))


def dropout_matmul_inference(x: torch.Tensor, w: torch.Tensor,
                             seeds: torch.Tensor, rate: float
                             ) -> torch.Tensor:
    """Inference entry of the masked heads. ``seeds`` (2,) gives one sample,
    (M, N); ``seeds`` (S, 2) gives every sample in one launch, (S, M, N) —
    what the JAX package's vmap rule does. The CUDA samples kernel splits S
    over blocks itself, so no sample chunking happens here."""
    if seeds.dim() == 1:
        return dropout_matmul(x, w, seeds, rate)
    return dropout_matmul_samples(x, w, seeds, rate)


# ------------------------------------------------------------ int8 heads


def int8_out_scale(x_step: float, w_step: float, rate: float) -> float:
    """``x_step * w_step / (1 - rate)`` in Python double, rounded to the
    nearest f32: the constant the JAX int8 kernels multiply by
    (``masked_matmul.py:490,567``)."""
    return float(np.float32(float(x_step) * float(w_step) / (1.0 - rate)))


def dropout_matmul_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                              seeds: torch.Tensor, rate: float,
                              x_step: float, w_step: float) -> torch.Tensor:
    """``f32(dropout(x_q) @ w_q) * out_scale`` in plain PyTorch on any
    device: the mask of ``keep_mask`` zeroes int8 elements (no scaling
    there), ``int_mm`` sums exactly in int32. Rate 0 applies no mask, as the
    JAX kernel skips masking then (``:454``)."""
    xm = x_q
    if rate > 0.0:
        keep = keep_mask(seeds, x_q.shape[0], x_q.shape[1], rate)
        xm = torch.where(keep, x_q, torch.zeros((), dtype=torch.int8,
                                                device=x_q.device))
    return int_mm(xm, w_q).float() * int8_out_scale(x_step, w_step, rate)


def dropout_matmul_int8_samples_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                                      seeds: torch.Tensor, rate: float,
                                      x_step: float, w_step: float
                                      ) -> torch.Tensor:
    """All S int8 samples in plain PyTorch: (S, M, N) f32, sample s equal to
    ``dropout_matmul_int8_plain(x_q, w_q, seeds[s], ...)`` bit for bit."""
    return torch.stack([dropout_matmul_int8_plain(x_q, w_q, seeds[s], rate,
                                                  x_step, w_step)
                        for s in range(seeds.shape[0])])


def _check_int8(x_q: torch.Tensor, w_q: torch.Tensor, seeds: torch.Tensor,
                seeds_ndim: int, rate: float) -> None:
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"need x_q (M, K) and w_q (K, N); got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must both be int8; got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if w_q.device != x_q.device:
        raise ValueError(f"x_q and w_q must be on one device; got "
                         f"{x_q.device} and {w_q.device}")
    _check_rate_seeds(x_q, seeds, seeds_ndim, rate)


def dropout_matmul_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                        seeds: torch.Tensor, rate: float, x_step: float,
                        w_step: float) -> torch.Tensor:
    """``dequant(dropout(x_q) @ w_q)`` in int8: x_q (M, K) and w_q (K, N)
    int8 (``core.quant.quantize_int8``), seeds (2,) int32 on their device.
    Returns (M, N) f32 rescaled by ``x_step·w_step/(1-rate)``, with the
    float kernels' mask. Inference only, as in the JAX package."""
    _check_int8(x_q, w_q, seeds, 1, rate)
    if x_q.device.type == "cpu" or rate == 0.0:
        return dropout_matmul_int8_plain(x_q, w_q, seeds, rate, x_step,
                                         w_step)
    return _launch("dropout_matmul_int8", x_q, w_q, seeds.reshape(1, 2),
                   [keep_threshold(rate),
                    int8_out_scale(x_step, w_step, rate)])


def dropout_matmul_int8_samples(x_q: torch.Tensor, w_q: torch.Tensor,
                                seeds: torch.Tensor, rate: float,
                                x_step: float, w_step: float
                                ) -> torch.Tensor:
    """All-samples int8 head: seeds (S, 2) int32; (S, M, N) f32 with sample
    s bit-identical to ``dropout_matmul_int8(x_q, w_q, seeds[s], ...)``; the
    kernel stages each int8 x tile once for all samples of a block."""
    _check_int8(x_q, w_q, seeds, 2, rate)
    if x_q.device.type == "cpu" or rate == 0.0:
        return dropout_matmul_int8_samples_plain(x_q, w_q, seeds, rate,
                                                 x_step, w_step)
    return _launch("dropout_matmul_int8_samples", x_q, w_q, seeds,
                   [keep_threshold(rate),
                    int8_out_scale(x_step, w_step, rate)])


def dropout_matmul_int8_inference(x_q: torch.Tensor, w_q: torch.Tensor,
                                  seeds: torch.Tensor, rate: float,
                                  x_step: float, w_step: float
                                  ) -> torch.Tensor:
    """Inference entry of the int8 heads: seeds (2,) → one sample (M, N);
    seeds (S, 2) → every sample in one launch, (S, M, N), what the JAX
    package's vmap rule does."""
    if seeds.dim() == 1:
        return dropout_matmul_int8(x_q, w_q, seeds, rate, x_step, w_step)
    return dropout_matmul_int8_samples(x_q, w_q, seeds, rate, x_step,
                                       w_step)
