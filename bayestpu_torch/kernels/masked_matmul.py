"""Masked matmuls — MC dropout and Masksembles — fused into one kernel:
plain PyTorch versions and the wrappers of the CUDA kernels in
``bayestpu_torch/csrc/masked_matmul.cu``.

Counterpart of ``bayestpu/kernels/masked_matmul.py``: ``dropout_matmul``
(trainable, with the backward that regenerates the mask through
``dropout_apply``), ``dropout_matmul_samples``, ``dropout_matmul_inference``
and their int8 twins ``dropout_matmul_int8``, ``dropout_matmul_int8_samples``
and ``dropout_matmul_int8_inference`` (``:430-637``); and the Masksembles
heads ``bank_matmul``, ``bank_matmul_samples``, ``bank_matmul_inference``
and their int8 twins ``bank_matmul_int8``, ``bank_matmul_int8_samples`` and
``bank_matmul_int8_inference`` (``:640-1021``). The MC mask of element
``(r, c)`` of x is a pure counter hash of ``(seeds, r, c)`` — the global,
unpadded coordinates — so every kernel, tiling and sample mapping
reproduces it bit for bit, and so does the JAX package: an element is kept
iff
``coord_bits(r, c, seed_stream(s0, s1)) < keep_threshold(rate)``, all in
uint32 with wraparound. The plain versions compute those bits in int64 with
``& 0xFFFFFFFF`` after every multiply. Every MC function takes ``row0``,
the global row of x's first row (default 0: x is the whole batch): row r of
x hashes as row ``row0 + r`` (uint32, wrapping), so one rank's rows of a
data-sharded batch get the masks of those rows of the whole batch, as the
JAX kernels give them under a sharded ``jit``.

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

The Masksembles functions take an f32 ``bank`` (num_masks, K) and a sample
index, taken modulo num_masks with floor semantics (−1 is the last mask),
as ``idx % num_masks`` in JAX. The float ones compute ``(x · bank[idx]) @
w`` in f32 — a bf16 x is widened exactly, and the bank's value multiplies
x, it is not binarized — and the int8 ones keep the int8 x where
``bank[idx] > 0.5``, sum exactly in int32 and return ``f32(acc) *
out_scale`` with ``out_scale`` the f32 nearest to ``x_step * w_step`` (no
dropout rescale). ``*_inference`` takes an int index (one sample, (M, N))
or a 1-D tensor of S indices (every sample in one launch, (S, M, N)).

An x of (S, M, K) carries the sample axis: sample s of x is masked with
seeds[s] or index s on its own coordinates, as the JAX vmap rules' ``lax.map``
fallback runs the single kernel per sample. On the card each of the four
``*_inference`` heads then makes one launch of its samples kernel with a
per-sample x stride (counted as ``dropout_matmul_xs``,
``dropout_matmul_int8_xs``, ``bank_matmul_xs`` and ``bank_matmul_int8_xs``);
on the CPU it runs the single plain version per sample (``map_samples``).

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
                                 "dropout_matmul_xs": 0,
                                 "dropout_apply": 0,
                                 "dropout_matmul_int8": 0,
                                 "dropout_matmul_int8_samples": 0,
                                 "dropout_matmul_int8_xs": 0,
                                 "bank_matmul": 0,
                                 "bank_matmul_samples": 0,
                                 "bank_matmul_xs": 0,
                                 "bank_matmul_int8": 0,
                                 "bank_matmul_int8_samples": 0,
                                 "bank_matmul_int8_xs": 0}


# The operations those launches did, by the same names: 2·M·N·K a sample
# for a matmul kernel (x (M, K), w (K, N)), M·K multiplies for
# ``dropout_apply``; what ``utils.profiler`` adds to the ATen ops that
# PyTorch's flop counter sees, which does not see a ctypes launch.
work_counts: dict[str, int] = dict.fromkeys(launch_counts, 0)


def reset_launch_counts() -> None:
    """Set every launch and work count to 0."""
    for name in launch_counts:
        launch_counts[name] = work_counts[name] = 0


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


def row_offset(row0) -> int:
    """``row0`` as the uint32 the kernels add to a row: global rows wrap
    modulo 2^32, as the JAX package's uint32 row counters do."""
    return int(row0) & _M32


def keep_mask(seeds: torch.Tensor, m: int, k: int, rate: float,
              row0: int = 0) -> torch.Tensor:
    """(m, k) bool keep mask of one seed pair, on the seeds' device: rows
    ``row0 .. row0 + m`` of the whole tensor's mask."""
    rows = row_offset(row0) + torch.arange(
        m, dtype=torch.int64, device=seeds.device)[:, None]
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
                         seeds: torch.Tensor, rate: float, row0: int = 0
                         ) -> torch.Tensor:
    """``dropout(x) @ w`` in plain PyTorch on any device: (M, N) f32."""
    if rate == 0.0:
        return matmul_f32(x, w)
    keep = keep_mask(seeds, x.shape[0], x.shape[1], rate, row0)
    scale = torch.tensor(scale_of(rate, x.dtype), dtype=x.dtype,
                         device=x.device)
    xm = torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return matmul_f32(xm, w)


def dropout_matmul_samples_plain(x: torch.Tensor, w: torch.Tensor,
                                 seeds: torch.Tensor, rate: float,
                                 row0: int = 0) -> torch.Tensor:
    """All S samples in plain PyTorch: (S, M, N) f32, sample s equal to
    ``dropout_matmul_plain(x, w, seeds[s], rate)`` bit for bit."""
    num_samples = seeds.shape[0]
    if rate == 0.0:
        y = matmul_f32(x, w)
        return y.expand((num_samples,) + tuple(y.shape))
    return torch.stack([dropout_matmul_plain(x, w, seeds[s], rate, row0)
                        for s in range(num_samples)])


def dropout_apply_plain(x: torch.Tensor, seeds: torch.Tensor,
                        rate: float, row0: int = 0) -> torch.Tensor:
    """``dropout(x)`` alone in plain PyTorch: (M, K) f32, the forward's mask
    times the f32 scale."""
    keep = keep_mask(seeds, x.shape[0], x.shape[1], rate, row0)
    scale = torch.tensor(apply_scale(rate), dtype=torch.float32,
                         device=x.device)
    return torch.where(keep, x.float() * scale,
                       torch.zeros((), dtype=torch.float32, device=x.device))


def dropout_matmul_vjp_plain(x: torch.Tensor, w: torch.Tensor,
                             seeds: torch.Tensor, rate: float,
                             g: torch.Tensor, row0: int = 0
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
    dx = dropout_apply_plain(gx, seeds, rate, row0).to(x.dtype)
    dw = torch.matmul(dropout_apply_plain(x, seeds, rate, row0).T,
                      g).to(w.dtype)
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
           seeds_ndim: int, rate: float, x_ndim: int = 2) -> None:
    if x.dim() != x_ndim or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        want = "(M, K)" if x_ndim == 2 else "(S, M, K)"
        raise ValueError(f"need x {want} and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x and w must be on one device; got {x.device} "
                         f"and {w.device}")
    _check_rate_seeds(x, seeds, seeds_ndim, rate)


def _call(name: str, device: torch.device, tensors: dict, args: list,
          count: str | None = None) -> None:
    """Call the C entry ``bt_<name>`` of ``masked_matmul.cu`` with the
    pointers of ``tensors`` (each must be contiguous), then ``args``, then
    PyTorch's current stream; count the launch under ``count`` (default
    ``name``)."""
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
    launch_counts[count or name] += 1
    work_counts[count or name] += (
        2 * tensors["out"].numel() * tensors["w"].shape[0]
        if "w" in tensors else tensors["x"].numel())


def _launch(name: str, x: torch.Tensor, w: torch.Tensor,
            seeds: torch.Tensor, args: list, count: str | None = None
            ) -> torch.Tensor:
    """Launch one of the matmul kernels on PyTorch's current stream with
    the trailing C arguments ``args``. ``seeds`` is (S, 2); a single-sample
    kernel is called with S == 1 and returns (M, N), a samples kernel
    (S, M, N). x is (M, K), or (S, M, K) when it carries the sample axis."""
    m, k = x.shape[-2:]
    n = w.shape[1]
    s = seeds.shape[0]
    single = not name.endswith("_samples")
    out = torch.empty((m, n) if single else (s, m, n), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    _call(name, x.device, {"x": x, "w": w, "seeds": seeds, "out": out},
          [m, k, n] + ([] if single else [s]) + args, count)
    return out


def _x_stride(x: torch.Tensor) -> int:
    """Elements between the samples of an x (S, M, K) that carries the
    sample axis: the C entries take it as an int."""
    stride = x.shape[-2] * x.shape[-1]
    if stride > 2 ** 31 - 1:
        raise ValueError(f"x of {tuple(x.shape)}: M·K={stride} does not fit "
                         "the kernels' int32 sample stride")
    return stride


def _check_carried(x: torch.Tensor, keys) -> None:
    """x (S, M, K) carries the sample axis: one seed pair or index a
    sample."""
    if len(keys) != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} carries {x.shape[0]} samples "
                         f"but {len(keys)} seed pairs or indices came with "
                         "it")


def _float_args(x: torch.Tensor, rate: float, row0: int = 0) -> list:
    return [keep_threshold(rate), scale_of(rate, x.dtype),
            int(x.dtype == torch.bfloat16), row_offset(row0)]


def dropout_apply(x: torch.Tensor, seeds: torch.Tensor,
                  rate: float, row0: int = 0) -> torch.Tensor:
    """``dropout(x)`` alone: x (M, K) f32/bf16, seeds (2,) int32 on x's
    device, ``row0`` the global row of x's first row. Returns (M, K) f32
    with the forward kernels' mask bit for bit, scaled by the f32
    ``1/(1-rate)`` (``_dropout_apply``)."""
    if x.dim() != 2:
        raise ValueError(f"need x (M, K); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    _check_rate_seeds(x, seeds, 1, rate)
    if x.device.type == "cpu":
        return dropout_apply_plain(x, seeds, rate, row0)
    m, k = x.shape
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _call("dropout_apply", x.device, {"x": x, "seeds": seeds, "out": out},
          [m, k, keep_threshold(rate), apply_scale(rate),
           int(x.dtype == torch.bfloat16), row_offset(row0)])
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
    def forward(ctx, x, w, seeds, rate, row0):
        ctx.save_for_backward(x, w, seeds)
        ctx.rate, ctx.row0 = rate, row0
        if x.device.type == "cpu" or rate == 0.0:
            return dropout_matmul_plain(x, w, seeds, rate, row0)
        return _launch("dropout_matmul", x, w, seeds.reshape(1, 2),
                       _float_args(x, rate, row0))

    @staticmethod
    def backward(ctx, g):
        x, w, seeds = ctx.saved_tensors
        rate, row0 = ctx.rate, ctx.row0
        need_x, need_w = ctx.needs_input_grad[:2]
        g = g.float().contiguous()
        dx = dw = None
        if rate == 0.0:
            if need_x:
                dx = torch.matmul(g, w.float().T).to(x.dtype)
            if need_w:
                dw = torch.matmul(x.float().T, g).to(w.dtype)
            return dx, dw, None, None, None
        if need_x:
            dx = dropout_apply(torch.matmul(g, w.float().T), seeds, rate,
                               row0).to(x.dtype)
        if need_w:
            dw = torch.matmul(dropout_apply(x, seeds, rate, row0).T,
                              g).to(w.dtype)
        return dx, dw, None, None, None


def dropout_matmul(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                   rate: float, row0: int = 0) -> torch.Tensor:
    """``dropout(x) @ w`` with the mask fused into the kernel; trainable
    through ``DropoutMatmul``.

    x: (M, K) f32/bf16; w: (K, N) of x's dtype; seeds: (2,) int32 on x's
    device; row0: the global row of x's first row. Returns (M, N) f32. Rate
    0 is a plain matmul.
    """
    _check(x, w, seeds, 1, rate)
    return DropoutMatmul.apply(x, w, seeds, rate, row0)


def dropout_matmul_samples(x: torch.Tensor, w: torch.Tensor,
                           seeds: torch.Tensor, rate: float, row0: int = 0
                           ) -> torch.Tensor:
    """All-samples fused MC head: ``stack([dropout_s(x) @ w for s in S])``.

    seeds: (S, 2) int32. Returns (S, M, N) f32 with sample s bit-identical to
    ``dropout_matmul(x, w, seeds[s], rate)`` on the same device: the kernel
    runs one block per sample and keeps the single kernel's summation chain.
    """
    _check(x, w, seeds, 2, rate)
    if x.device.type == "cpu" or rate == 0.0:
        return dropout_matmul_samples_plain(x, w, seeds, rate, row0)
    return _launch("dropout_matmul_samples", x, w, seeds,
                   [0] + _float_args(x, rate, row0))


def map_samples(fn, x: torch.Tensor, keys, stack=torch.stack
                ) -> torch.Tensor:
    """JAX's ``lax.map`` fallback of the vmap rules (``:407-411``): x (S,
    ...) carries the sample axis, and sample s runs ``fn(x[s], keys[s])``,
    one single-sample launch each; the S results joined by ``stack``."""
    _check_carried(x, keys)
    return stack([fn(x[s], keys[s]) for s in range(x.shape[0])])


def dropout_matmul_inference(x: torch.Tensor, w: torch.Tensor,
                             seeds: torch.Tensor, rate: float, row0: int = 0
                             ) -> torch.Tensor:
    """Inference entry of the masked heads. ``seeds`` (2,) gives one sample,
    (M, N); ``seeds`` (S, 2) gives every sample in one launch, (S, M, N) —
    what the JAX package's vmap rule does. The CUDA samples kernel splits S
    over blocks itself, so no sample chunking happens here. An x of (S, M,
    K) with seeds (S, 2) carries the sample axis: sample s of x under
    seeds[s], on its own coordinates, as JAX's ``lax.map`` fallback runs
    the single kernel per sample (``:407-411``) — one ``dropout_matmul_xs``
    launch of the samples kernel on the card, the single plain version per
    sample on the CPU (and at rate 0, a plain matmul). ``row0`` is the
    global row of x's first row (of each sample's x)."""
    if x.dim() == 3:
        if x.device.type == "cpu" or rate == 0.0:
            return map_samples(lambda xs, sd: dropout_matmul(xs, w, sd, rate,
                                                             row0), x, seeds)
        _check(x, w, seeds, 2, rate, x_ndim=3)
        _check_carried(x, seeds)
        return _launch("dropout_matmul_samples", x, w, seeds,
                       [_x_stride(x)] + _float_args(x, rate, row0),
                       "dropout_matmul_xs")
    if seeds.dim() == 1:
        return dropout_matmul(x, w, seeds, rate, row0)
    return dropout_matmul_samples(x, w, seeds, rate, row0)


# ------------------------------------------------------------ int8 heads


def int8_out_scale(x_step: float, w_step: float, rate: float) -> float:
    """``x_step * w_step / (1 - rate)`` in Python double, rounded to the
    nearest f32: the constant the JAX int8 kernels multiply by
    (``masked_matmul.py:490,567``)."""
    return float(np.float32(float(x_step) * float(w_step) / (1.0 - rate)))


def dropout_matmul_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                              seeds: torch.Tensor, rate: float,
                              x_step: float, w_step: float, row0: int = 0
                              ) -> torch.Tensor:
    """``f32(dropout(x_q) @ w_q) * out_scale`` in plain PyTorch on any
    device: the mask of ``keep_mask`` zeroes int8 elements (no scaling
    there), ``int_mm`` sums exactly in int32. Rate 0 applies no mask, as the
    JAX kernel skips masking then (``:454``)."""
    xm = x_q
    if rate > 0.0:
        keep = keep_mask(seeds, x_q.shape[0], x_q.shape[1], rate, row0)
        xm = torch.where(keep, x_q, torch.zeros((), dtype=torch.int8,
                                                device=x_q.device))
    return int_mm(xm, w_q).float() * int8_out_scale(x_step, w_step, rate)


def dropout_matmul_int8_samples_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                                      seeds: torch.Tensor, rate: float,
                                      x_step: float, w_step: float,
                                      row0: int = 0) -> torch.Tensor:
    """All S int8 samples in plain PyTorch: (S, M, N) f32, sample s equal to
    ``dropout_matmul_int8_plain(x_q, w_q, seeds[s], ...)`` bit for bit."""
    return torch.stack([dropout_matmul_int8_plain(x_q, w_q, seeds[s], rate,
                                                  x_step, w_step, row0)
                        for s in range(seeds.shape[0])])


def _check_int8(x_q: torch.Tensor, w_q: torch.Tensor, seeds: torch.Tensor,
                seeds_ndim: int, rate: float, x_ndim: int = 2) -> None:
    if (x_q.dim() != x_ndim or w_q.dim() != 2
            or x_q.shape[-1] != w_q.shape[0]):
        want = "(M, K)" if x_ndim == 2 else "(S, M, K)"
        raise ValueError(f"need x_q {want} and w_q (K, N); got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must both be int8; got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if w_q.device != x_q.device:
        raise ValueError(f"x_q and w_q must be on one device; got "
                         f"{x_q.device} and {w_q.device}")
    _check_rate_seeds(x_q, seeds, seeds_ndim, rate)


def _int8_args(rate: float, x_step: float, w_step: float, row0: int = 0
               ) -> list:
    return [keep_threshold(rate), int8_out_scale(x_step, w_step, rate),
            row_offset(row0)]


def dropout_matmul_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                        seeds: torch.Tensor, rate: float, x_step: float,
                        w_step: float, row0: int = 0) -> torch.Tensor:
    """``dequant(dropout(x_q) @ w_q)`` in int8: x_q (M, K) and w_q (K, N)
    int8 (``core.quant.quantize_int8``), seeds (2,) int32 on their device.
    Returns (M, N) f32 rescaled by ``x_step·w_step/(1-rate)``, with the
    float kernels' mask. Inference only, as in the JAX package."""
    _check_int8(x_q, w_q, seeds, 1, rate)
    if x_q.device.type == "cpu" or rate == 0.0:
        return dropout_matmul_int8_plain(x_q, w_q, seeds, rate, x_step,
                                         w_step, row0)
    return _launch("dropout_matmul_int8", x_q, w_q, seeds.reshape(1, 2),
                   _int8_args(rate, x_step, w_step, row0))


def dropout_matmul_int8_samples(x_q: torch.Tensor, w_q: torch.Tensor,
                                seeds: torch.Tensor, rate: float,
                                x_step: float, w_step: float, row0: int = 0
                                ) -> torch.Tensor:
    """All-samples int8 head: seeds (S, 2) int32; (S, M, N) f32 with sample
    s bit-identical to ``dropout_matmul_int8(x_q, w_q, seeds[s], ...)``; the
    kernel runs on the s8 tensor cores, one block per (16 rows, 8 columns,
    sample), its exact int32 sums in any order."""
    _check_int8(x_q, w_q, seeds, 2, rate)
    if x_q.device.type == "cpu" or rate == 0.0:
        return dropout_matmul_int8_samples_plain(x_q, w_q, seeds, rate,
                                                 x_step, w_step, row0)
    return _launch("dropout_matmul_int8_samples", x_q, w_q, seeds,
                   [0] + _int8_args(rate, x_step, w_step, row0))


def dropout_matmul_int8_inference(x_q: torch.Tensor, w_q: torch.Tensor,
                                  seeds: torch.Tensor, rate: float,
                                  x_step: float, w_step: float,
                                  row0: int = 0) -> torch.Tensor:
    """Inference entry of the int8 heads: seeds (2,) → one sample (M, N);
    seeds (S, 2) → every sample in one launch, (S, M, N), what the JAX
    package's vmap rule does; x (S, M, K) with seeds (S, 2) → sample s of
    x under seeds[s], as JAX's ``lax.map`` fallback (``:618-622``): one
    ``dropout_matmul_int8_xs`` launch of the samples kernel on the card,
    the single plain version per sample on the CPU (and at rate 0)."""
    if x_q.dim() == 3:
        if x_q.device.type == "cpu" or rate == 0.0:
            return map_samples(lambda xs, sd: dropout_matmul_int8(
                xs, w_q, sd, rate, x_step, w_step, row0), x_q, seeds)
        _check_int8(x_q, w_q, seeds, 2, rate, x_ndim=3)
        _check_carried(x_q, seeds)
        return _launch("dropout_matmul_int8_samples", x_q, w_q, seeds,
                       [_x_stride(x_q)]
                       + _int8_args(rate, x_step, w_step, row0),
                       "dropout_matmul_int8_xs")
    if seeds.dim() == 1:
        return dropout_matmul_int8(x_q, w_q, seeds, rate, x_step, w_step,
                                   row0)
    return dropout_matmul_int8_samples(x_q, w_q, seeds, rate, x_step,
                                       w_step, row0)


# ------------------------------------------------------ Masksembles heads


def bank_index(sample_idx, num_masks: int) -> int:
    """An int (or 0-d integer tensor) sample index taken modulo
    ``num_masks`` with floor semantics, as JAX's ``idx % num_masks``."""
    if isinstance(sample_idx, torch.Tensor):
        if sample_idx.dim() != 0 or sample_idx.is_floating_point():
            raise ValueError(f"sample_idx must be an integer scalar; got "
                             f"{sample_idx.dtype} {tuple(sample_idx.shape)}")
        sample_idx = int(sample_idx)
    return int(sample_idx) % num_masks


def is_index_vector(sample_idx) -> bool:
    """A 1-D tensor of S sample indices (the samples kernels' argument), as
    opposed to one int index."""
    return isinstance(sample_idx, torch.Tensor) and sample_idx.dim() == 1


def host_indices(sample_idx) -> list[int]:
    """S sample indices as Python ints for the CPU's S single calls: a list
    or tuple as it is, a 1-D integer tensor copied to the host."""
    if isinstance(sample_idx, (list, tuple)):
        return [int(i) for i in sample_idx]
    return bank_indices(sample_idx).tolist()


def bank_indices(idxs: torch.Tensor) -> torch.Tensor:
    """1-D integer sample indices as contiguous int32 on their device (no
    copy for int32). Any value in int32's range: the kernels take each
    modulo ``num_masks`` with floor semantics themselves."""
    if (not isinstance(idxs, torch.Tensor) or idxs.dim() != 1
            or idxs.is_floating_point() or idxs.dtype == torch.bool):
        raise ValueError("sample indices must be a 1-D integer tensor")
    return idxs.to(torch.int32).contiguous()


def bank_matmul_plain(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                      sample_idx: int) -> torch.Tensor:
    """``(x · bank[idx]) @ w`` in plain PyTorch on any device: (M, N) f32,
    x widened to f32 and multiplied by the row's values."""
    row = bank[bank_index(sample_idx, bank.shape[0])]
    return matmul_f32(x.float() * row, w)


def bank_matmul_samples_plain(x: torch.Tensor, w: torch.Tensor,
                              bank: torch.Tensor, idxs: torch.Tensor
                              ) -> torch.Tensor:
    """All S samples in plain PyTorch: (S, M, N) f32, sample s equal to
    ``bank_matmul_plain(x, w, bank, idxs[s])`` bit for bit."""
    rows = bank_indices(idxs).tolist()
    if not rows:
        return torch.empty((0, x.shape[0], w.shape[1]), dtype=torch.float32,
                           device=x.device)
    return torch.stack([bank_matmul_plain(x, w, bank, i) for i in rows])


def bank_matmul_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                           bank: torch.Tensor, sample_idx: int,
                           x_step: float, w_step: float) -> torch.Tensor:
    """``f32((x_q where bank[idx] > 0.5) @ w_q) * out_scale`` in plain
    PyTorch on any device; ``int_mm`` sums exactly in int32."""
    keep = bank[bank_index(sample_idx, bank.shape[0])] > 0.5
    xm = torch.where(keep, x_q, torch.zeros((), dtype=torch.int8,
                                            device=x_q.device))
    return int_mm(xm, w_q).float() * bank_out_scale(x_step, w_step)


def bank_matmul_int8_samples_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                                   bank: torch.Tensor, idxs: torch.Tensor,
                                   x_step: float, w_step: float
                                   ) -> torch.Tensor:
    """All S int8 samples in plain PyTorch: (S, M, N) f32, sample s equal to
    ``bank_matmul_int8_plain(x_q, w_q, bank, idxs[s], ...)`` bit for bit."""
    rows = bank_indices(idxs).tolist()
    if not rows:
        return torch.empty((0, x_q.shape[0], w_q.shape[1]),
                           dtype=torch.float32, device=x_q.device)
    return torch.stack([bank_matmul_int8_plain(x_q, w_q, bank, i, x_step,
                                               w_step) for i in rows])


def bank_out_scale(x_step: float, w_step: float) -> float:
    """``x_step * w_step`` in Python double, rounded to the nearest f32: the
    constant the JAX bank int8 kernels multiply by (``:687,808``); no
    ``1/(1-rate)`` here."""
    return int8_out_scale(x_step, w_step, 0.0)


def _check_bank(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                int8: bool, x_ndim: int = 2) -> None:
    if x.dim() != x_ndim or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        want = "(M, K)" if x_ndim == 2 else "(S, M, K)"
        raise ValueError(f"need x {want} and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if bank.dim() != 2 or bank.shape[1] != x.shape[-1] or bank.shape[0] < 1:
        raise ValueError(f"need bank (num_masks, K) with K={x.shape[-1]}; "
                         f"got {tuple(bank.shape)}")
    if int8 and (x.dtype != torch.int8 or w.dtype != torch.int8):
        raise TypeError(f"x_q and w_q must both be int8; got {x.dtype} and "
                        f"{w.dtype}")
    if not int8 and (x.dtype not in _DTYPES or w.dtype != torch.float32):
        raise TypeError(f"x must be float32 or bfloat16 and w float32; got "
                        f"{x.dtype} and {w.dtype}")
    if bank.dtype != torch.float32:
        raise TypeError(f"bank must be float32; got {bank.dtype}")
    if w.device != x.device or bank.device != x.device:
        raise ValueError(f"x, w and bank must be on one device; got "
                         f"{x.device}, {w.device} and {bank.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}: the port runs "
                         "its kernels on CUDA and their plain versions on "
                         "the CPU")


def _launch_bank(name: str, x: torch.Tensor, w: torch.Tensor,
                 bank: torch.Tensor, index, args: list,
                 x_stride: int | None = None, count: str | None = None
                 ) -> torch.Tensor:
    """Launch a bank kernel: ``index`` is the int row of a single kernel,
    (M, N) out, or the int32 index tensor (S,) of a samples kernel, (S, M,
    N) out; ``x_stride`` the samples' x stride of a samples entry (0: x
    shared, M·K: x (S, M, K) carries the sample axis); ``args`` are the
    trailing C arguments; ``count`` the counter to bump (default
    ``name``)."""
    m, k = x.shape[-2:]
    n = w.shape[1]
    tensors = {"x": x, "w": w, "bank": bank}
    if isinstance(index, int):
        shape, dims = (m, n), [m, k, n, index]
    else:
        if index.device != x.device:
            raise ValueError(f"sample indices must be on x's device "
                             f"{x.device}; got {index.device}")
        tensors["idxs"] = index
        shape, dims = (index.shape[0], m, n), [m, k, n, index.shape[0]]
    if x_stride is not None:
        dims.append(x_stride)
    dims.append(bank.shape[0])
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    tensors["out"] = out
    _call(name, x.device, tensors, dims + args, count)
    return out


def _launch_bank_xs(name: str, x: torch.Tensor, w: torch.Tensor,
                    bank: torch.Tensor, sample_idx, args: list, count: str
                    ) -> torch.Tensor:
    """One launch of the samples kernel ``name`` on an x (S, M, K) that
    carries the sample axis: sample s of x under index s, the S indices a
    1-D integer tensor on x's device; counted under ``count``."""
    _check_bank(x, w, bank, x.dtype == torch.int8, x_ndim=3)
    idxs = bank_indices(sample_idx)
    _check_carried(x, idxs)
    return _launch_bank(name, x, w, bank, idxs, args, x_stride=_x_stride(x),
                        count=count)


def bank_matmul(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                sample_idx) -> torch.Tensor:
    """``(x · bank[sample_idx % num_masks]) @ w``, the Masksembles fused
    head. x: (M, K) f32/bf16; w: (K, N) f32; bank: (num_masks, K) f32;
    sample_idx: an int. Returns (M, N) f32. Inference only, as in JAX. The
    kernel is the samples head's warp-specialised kernel at one sample,
    each output one serial f32 chain, so sample s of
    ``bank_matmul_samples`` equals it bit for bit."""
    _check_bank(x, w, bank, False)
    idx = bank_index(sample_idx, bank.shape[0])
    if x.device.type == "cpu":
        return bank_matmul_plain(x, w, bank, idx)
    return _launch_bank("bank_matmul", x, w, bank, idx,
                        [int(x.dtype == torch.bfloat16)])


def bank_matmul_samples(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                        idxs: torch.Tensor) -> torch.Tensor:
    """Every mask index in one launch: idxs (S,) integer on x's device.
    Returns (S, M, N) f32 with sample s bit-identical to ``bank_matmul(x, w,
    bank, idxs[s])`` on the same device: the kernel runs one block per (8
    rows, 16 columns, sample) and keeps the single kernel's summation
    chain."""
    _check_bank(x, w, bank, False)
    idxs = bank_indices(idxs)
    if x.device.type == "cpu":
        return bank_matmul_samples_plain(x, w, bank, idxs)
    return _launch_bank("bank_matmul_samples", x, w, bank, idxs,
                        [int(x.dtype == torch.bfloat16)], x_stride=0)


def bank_matmul_inference(x: torch.Tensor, w: torch.Tensor,
                          bank: torch.Tensor, sample_idx) -> torch.Tensor:
    """Inference entry of the Masksembles heads: an int ``sample_idx`` runs
    one sample, (M, N); a 1-D tensor of S indices runs every sample in one
    launch, (S, M, N) — what the JAX package's vmap rule does (it chunks S
    by 32; per-sample results do not depend on the chunking). An x of (S,
    M, K) with S indices (a tensor; on the CPU also a list of ints) →
    sample s of x under index s, as JAX's ``lax.map`` fallback
    (``:957-960``): one ``bank_matmul_xs`` launch of the samples kernel on
    the card, the single plain version per sample on the CPU."""
    if x.dim() == 3:
        if x.device.type == "cpu":
            return map_samples(lambda xs, i: bank_matmul(xs, w, bank, i), x,
                               host_indices(sample_idx))
        return _launch_bank_xs("bank_matmul_samples", x, w, bank,
                               sample_idx, [int(x.dtype == torch.bfloat16)],
                               "bank_matmul_xs")
    if is_index_vector(sample_idx):
        return bank_matmul_samples(x, w, bank, sample_idx)
    return bank_matmul(x, w, bank, sample_idx)


def bank_matmul_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                     bank: torch.Tensor, sample_idx, x_step: float,
                     w_step: float) -> torch.Tensor:
    """``dequant((x_q ⊙ (bank[sample_idx % num_masks] > 0.5)) @ w_q)``: x_q
    (M, K) and w_q (K, N) int8, bank (num_masks, K) f32, an int index.
    Returns (M, N) f32 rescaled by ``x_step·w_step``. The kernel is the int8
    samples heads' s8 tensor-core kernel at one sample, the K of each
    output tile split over a thread-block cluster."""
    _check_bank(x_q, w_q, bank, True)
    idx = bank_index(sample_idx, bank.shape[0])
    if x_q.device.type == "cpu":
        return bank_matmul_int8_plain(x_q, w_q, bank, idx, x_step, w_step)
    return _launch_bank("bank_matmul_int8", x_q, w_q, bank, idx,
                        [bank_out_scale(x_step, w_step)])


def bank_matmul_int8_samples(x_q: torch.Tensor, w_q: torch.Tensor,
                             bank: torch.Tensor, idxs: torch.Tensor,
                             x_step: float, w_step: float) -> torch.Tensor:
    """Every mask index of the int8 head in one launch: (S, M, N) f32 with
    sample s bit-identical to ``bank_matmul_int8(x_q, w_q, bank, idxs[s],
    ...)``; the kernel runs on the s8 tensor cores, one block per (16 rows,
    8 columns, sample)."""
    _check_bank(x_q, w_q, bank, True)
    idxs = bank_indices(idxs)
    if x_q.device.type == "cpu":
        return bank_matmul_int8_samples_plain(x_q, w_q, bank, idxs, x_step,
                                              w_step)
    return _launch_bank("bank_matmul_int8_samples", x_q, w_q, bank, idxs,
                        [bank_out_scale(x_step, w_step)], x_stride=0)


def bank_matmul_int8_inference(x_q: torch.Tensor, w_q: torch.Tensor,
                               bank: torch.Tensor, sample_idx,
                               x_step: float, w_step: float) -> torch.Tensor:
    """Inference entry of the int8 Masksembles heads: an int index → one
    sample (M, N); a 1-D tensor of S indices → every sample in one launch,
    (S, M, N); an x of (S, M, K) with S indices (a tensor; on the CPU also
    a list of ints) → sample s of x under index s, as JAX's ``lax.map``
    fallback (``:742-747``): one ``bank_matmul_int8_xs`` launch of the
    samples kernel on the card, the single plain version per sample on the
    CPU."""
    if x_q.dim() == 3:
        if x_q.device.type == "cpu":
            return map_samples(lambda xs, i: bank_matmul_int8(
                xs, w_q, bank, i, x_step, w_step), x_q,
                host_indices(sample_idx))
        return _launch_bank_xs("bank_matmul_int8_samples", x_q, w_q, bank,
                               sample_idx, [bank_out_scale(x_step, w_step)],
                               "bank_matmul_int8_xs")
    if is_index_vector(sample_idx):
        return bank_matmul_int8_samples(x_q, w_q, bank, sample_idx, x_step,
                                        w_step)
    return bank_matmul_int8(x_q, w_q, bank, sample_idx, x_step, w_step)
