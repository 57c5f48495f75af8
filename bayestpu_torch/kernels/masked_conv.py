"""Masked convolutions — MC dropout and Masksembles — with the mask and a
fused epilogue inside one kernel: plain PyTorch versions and the wrappers of
the CUDA kernels in ``bayestpu_torch/csrc/masked_conv.cu``.

Counterpart of ``bayestpu/kernels/masked_conv.py``: ``dropout_conv``
(trainable, with the backward that regenerates the mask, ``:591-640``),
``dropout_conv_samples``, ``dropout_conv_inference``, ``conv_fused`` and the
int8 twins ``dropout_conv_int8{,_samples,_inference}`` and
``conv_int8_fused`` (row 10 of the kernel table, ``_masked_conv_kernel``);
the Masksembles ``bank_conv{,_samples,_xs,_inference}`` and
``bank_conv_int8{,_samples,_xs,_inference}`` (row 11,
``_bank_conv_kernel``); and ``mask_apply_nhwc``.

Layouts are the port's: x is an NCHW tensor in ``channels_last`` memory
(the JAX package's NHWC array), w an OIHW kernel, and the output (N, F, Ho,
Wo) in ``channels_last`` memory; a samples function returns (S, N, F, Ho,
Wo), each sample in that layout. ``padding`` is "SAME" (XLA's: ``total =
max((ho-1)·stride + k - in, 0)``, ``lo = total // 2``, asymmetric at stride
2), "VALID" or explicit ``((lo, hi), (lo, hi))``; ``stride`` is 1 or 2.

The MC mask of x element (n, c, h, w) is that of ``dropout_apply`` on x
viewed as (N·H·W, C): the counter hash of ``masked_matmul`` on the global,
unpadded coordinate (n·H·W + h·W + w, c), which is why N·H·W must stay below
2³² and why a caller never folds a sample axis into the batch of a masked
conv (the mask rows would shift). Every MC function takes ``row0``, the hash
row of x's first pixel: ``b0·H·W`` when x holds the images from global
image b0 on (one rank's rows of a data-sharded batch; JAX's ``n0·hw``), 0
for the whole batch; the sum wraps at 2³², as JAX's uint32 rows do. A kept float value is ``x · scale`` in x's
dtype (bf16: 1.3359375 at rate 0.25, ``scale_of``), products accumulate in
f32; the int8 kernels keep the int8 value and return ``f32(acc) ·
out_scale``, ``out_scale`` the f32 of the double ``x_step·w_step/(1-rate)``.
The Masksembles functions take row ``idx % num_masks`` (floor) of an f32
bank: the float ones multiply x (widened to f32) by the row's value,
clipped at 0 when num_masks > 1 (JAX selects the row as a max over a
where, ``_bank_select_row``); the int8 ones keep x where the value > 0.5 and
rescale by the f32 of ``x_step·w_step``.

The epilogue (``_epi_apply``, ``:136-149``), in f32 and in this order: ``y
· scale + bias`` from ``bias`` — a (2, F) [scale, bias] stack, or an (F,)
bias with scale 1 — rounded once, as a fused multiply-add, and for the int8
functions with ``out_scale`` folded into the scale row first, ``fma(f32(acc),
f32(out_scale · scale), bias)``: the roundings of the JAX kernel on XLA's
CPU backend, which contracts and folds JAX's ``acc · out_scale · scale +
bias`` so (the plain version takes the f64 product and sum, rounded to
f32); then ``act="relu"``, then the store: f32, bf16 (``out_dtype``) or,
with ``out_step``, int8 ``clip(trunc(s ± 0.5), -128, 127)`` with ``s = y ·
f32(1/out_step)``.

At rate 0 the float ``dropout_conv*`` take the reference conv and the
epilogue (``_conv_ref``, which under bf16 rounds the conv to bf16), on any
device, as the JAX package takes XLA's; the int8 ones launch the kernel
without a mask, as JAX does.

Dispatch is by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel (or raise), any other device raises. Each launch
adds one to its entry of ``launch_counts``. On the card the routine follows
the dtypes (``tensor_core``): row 10 with bf16 x and w, or int8, and every
bank conv run the tensor-core implicit GEMM of ``masked_conv.cu`` (the
float bank convs stage the masked x and the weights in f32 and multiply
them as three TF32 products); an f32 or mixed-type MC conv runs its
CUDA-core routine.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from bayestpu_torch.core.quant import _round_ap_rnd, int8_conv2d
from bayestpu_torch.kernels.masked_matmul import (
    _check_carried, _check_rate_seeds, bank_index, bank_indices,
    bank_out_scale, dropout_apply, dropout_apply_plain,
    host_indices, int8_out_scale, is_index_vector, keep_mask,
    keep_threshold, map_samples, row_offset, scale_of)

_FLOAT = (torch.float32, torch.bfloat16)

# Launches of each CUDA kernel since the last reset; CPU calls do not count.
# conv_fused / conv_int8_fused are row 10's kernels without a mask; the _xs
# ones rows 10's and 11's launches on an x that carries the sample axis.
launch_counts: dict[str, int] = {"dropout_conv": 0,
                                 "dropout_conv_samples": 0,
                                 "dropout_conv_xs": 0,
                                 "dropout_conv_int8": 0,
                                 "dropout_conv_int8_samples": 0,
                                 "dropout_conv_int8_xs": 0,
                                 "bank_conv": 0,
                                 "bank_conv_samples": 0,
                                 "bank_conv_xs": 0,
                                 "bank_conv_int8": 0,
                                 "bank_conv_int8_samples": 0,
                                 "bank_conv_int8_xs": 0,
                                 "conv_fused": 0,
                                 "conv_int8_fused": 0}


# The operations those launches did, by the same names: 2 for each product
# that reads an input element (taps on the zero padding excluded), per
# sample (``conv_macs``); what ``utils.profiler`` adds to the ATen ops that
# PyTorch's flop counter sees, which does not see a ctypes launch.
work_counts: dict[str, int] = dict.fromkeys(launch_counts, 0)


def reset_launch_counts() -> None:
    """Set every launch and work count to 0."""
    for name in launch_counts:
        launch_counts[name] = work_counts[name] = 0


# -------------------------------------------------------------- geometry


class Geom(NamedTuple):
    """Zero padding (top, bottom, left, right) and the output size."""

    ph: int
    ph_hi: int
    pw: int
    pw_hi: int
    ho: int
    wo: int


def geometry(h: int, w: int, kh: int, kw: int, padding, stride: int
             ) -> Geom:
    """The padding and output size of ``_Geom`` (``masked_conv.py:
    175-189``): SAME is XLA's, lo = total // 2, so at stride 2 the extra
    row or column goes to the bottom or right (16 → 8 with k = 3 pads (0,
    1)). The masked convs take stride 1 or 2."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2; got {stride}")
    return conv_geometry(h, w, kh, kw, padding, stride)


def _taps(size: int, k: int, lo: int, stride: int, out: int) -> int:
    """(output position, tap) pairs along one axis that read an input
    element, not the zero padding."""
    return sum(0 <= o * stride + t - lo < size
               for o in range(out) for t in range(k))


def conv_macs(n: int, c: int, f: int, h: int, w: int, kh: int, kw: int,
              g: Geom, stride: int) -> int:
    """Products of one sample of a conv of n images (C, H, W) by (F, C, kh,
    kw) that read an input element, the taps on the zero padding
    excluded."""
    return (n * c * f * _taps(h, kh, g.ph, stride, g.ho)
            * _taps(w, kw, g.pw, stride, g.wo))


def conv_geometry(h: int, w: int, kh: int, kw: int, padding, stride: int
                  ) -> Geom:
    """``geometry`` at any stride: XLA's padding of a plain conv."""
    if padding == "SAME":
        ho, wo = -(-h // stride), -(-w // stride)
        th = max((ho - 1) * stride + kh - h, 0)
        tw = max((wo - 1) * stride + kw - w, 0)
        ph, ph_hi, pw, pw_hi = th // 2, th - th // 2, tw // 2, tw - tw // 2
    elif padding == "VALID":
        ph = ph_hi = pw = pw_hi = 0
    else:
        try:
            (ph, ph_hi), (pw, pw_hi) = ((int(a), int(b)) for a, b in padding)
        except (TypeError, ValueError):
            raise ValueError(f"padding must be SAME, VALID or ((lo, hi), "
                             f"(lo, hi)); got {padding!r}") from None
        if min(ph, ph_hi, pw, pw_hi) < 0:
            raise ValueError(f"negative padding {padding!r}")
    return Geom(ph, ph_hi, pw, pw_hi, (h + ph + ph_hi - kh) // stride + 1,
                (w + pw + pw_hi - kw) // stride + 1)


def conv2d_padded(x: torch.Tensor, w: torch.Tensor, g: Geom, stride: int
                  ) -> torch.Tensor:
    """``F.conv2d`` with the (possibly asymmetric) zero padding of ``g``."""
    if g.ph == g.ph_hi and g.pw == g.pw_hi:
        return F.conv2d(x, w, stride=stride, padding=(g.ph, g.pw))
    return F.conv2d(F.pad(x, (g.pw, g.pw_hi, g.ph, g.ph_hi)), w,
                    stride=stride)


# -------------------------------------------------------------- epilogue


class Epi(NamedTuple):
    """The fused epilogue (``_Epi``): an affine or not, the activation, the
    output type ("f32", "bf16" or "int8") and, for int8, 1/out_step."""

    affine: bool = False
    act: str | None = None
    out: str = "f32"
    inv_step: float = 0.0


_OUT = {"f32": (torch.float32, 0), "bf16": (torch.bfloat16, 1),
        "int8": (torch.int8, 2)}


def make_epi(bias, act, out_step, out_dtype) -> Epi:
    if act not in (None, "relu"):
        raise ValueError(f"act must be None or 'relu'; got {act!r}")
    if out_step is not None:
        return Epi(bias is not None, act, "int8", 1.0 / float(out_step))
    tag = {None: "f32", torch.float32: "f32", torch.bfloat16: "bf16"}[
        out_dtype]
    return Epi(bias is not None, act, tag, 0.0)


def affine_rows(bias: torch.Tensor | None, features: int
                ) -> torch.Tensor | None:
    """The (2, F) f32 [scale, bias] stack of the epilogue (``pad_b``): an
    (F,) bias gets a scale of ones, a (2, F) stack is taken as it is."""
    if bias is None:
        return None
    b = bias.float()
    if b.dim() == 1 and b.shape[0] == features:
        return torch.stack([torch.ones_like(b), b])
    if tuple(b.shape) != (2, features):
        raise ValueError(f"bias must be (F,) or (2, F) with F={features}; "
                         f"got {tuple(bias.shape)}")
    return b.contiguous()


def epilogue_plain(y: torch.Tensor, affine: torch.Tensor | None, epi: Epi,
                   out_scale: float | None = None) -> torch.Tensor:
    """``_epi_apply`` on an f32 NCHW y, the int8 kernels' ``f32(acc)`` when
    ``out_scale`` is given: the affine as one fused multiply-add, with
    ``out_scale`` folded into its scale row in f32 (the f32 product is
    exact in f64, so the f64 sum rounded to f32 is the fused result but for
    a double-rounding tie, p ≈ 2⁻²⁹), or ``y · out_scale`` without one;
    relu; then the store's rounding."""
    if affine is not None:
        a = affine.float()
        scale = a[0] if out_scale is None else a[0] * out_scale
        y = (y.double() * scale.double().view(1, -1, 1, 1)
             + a[1].double().view(1, -1, 1, 1)).float()
    elif out_scale is not None:
        y = y * out_scale
    if epi.act == "relu":
        y = torch.relu(y)
    if epi.out == "int8":
        y = torch.clamp(_round_ap_rnd(y * epi.inv_step), -128.0, 127.0)
    return y.to(_OUT[epi.out][0]).contiguous(
        memory_format=torch.channels_last)


# -------------------------------------------------------- plain versions


def conv_f32(x: torch.Tensor, w: torch.Tensor, g: Geom, stride: int
             ) -> torch.Tensor:
    """The kernels' float conv: both operands widened to f32 (bf16 values
    exactly), products summed in f32."""
    return conv2d_padded(x.float(), w.float(), g, stride)


def conv_ref(x: torch.Tensor, w: torch.Tensor, g: Geom, stride: int
             ) -> torch.Tensor:
    """``_conv_ref`` (``:575-588``): f32 x convolves in f32; a bf16 x
    convolves in bf16 and the result is widened, so it is bf16-rounded."""
    return conv2d_padded(x, w.to(x.dtype), g, stride).float()


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, g: Geom, stride: int
              ) -> torch.Tensor:
    """Exact int8 × int8 → int32 conv (``core.quant.int8_conv2d``)."""
    if g.ph == g.ph_hi and g.pw == g.pw_hi:
        return int8_conv2d(x_q, w_q, (stride, stride), (g.ph, g.pw))
    return int8_conv2d(F.pad(x_q, (g.pw, g.pw_hi, g.ph, g.ph_hi)), w_q,
                       (stride, stride), (0, 0))


def image_row0(b0: int, h: int, w: int) -> int:
    """The hash row of image b0's first pixel in an (N·H·W, C) view: the
    ``row0`` of a conv input or ``mask_apply_nhwc`` that starts at global
    image b0 (uint32, wrapping)."""
    return row_offset(int(b0) * h * w)


def int32_bits(row0: int) -> int:
    """``row0`` as the int32 whose bits are its uint32 (``row_offset``):
    the value ``dims[13]`` carries to the kernels."""
    r = row_offset(row0)
    return r - (r >> 31 << 32)


def keep_mask_nchw(seeds: torch.Tensor, x: torch.Tensor, rate: float,
                   row0: int = 0) -> torch.Tensor:
    """The (N, C, H, W) keep mask of x: ``keep_mask`` on (N·H·W, C)."""
    n, c, h, w = x.shape
    return keep_mask(seeds, n * h * w, c, rate, row0).view(
        n, h, w, c).permute(0, 3, 1, 2)


def _hash_masked(x: torch.Tensor, seeds: torch.Tensor, rate: float,
                 row0: int = 0) -> torch.Tensor:
    """x under the MC mask as the kernels stage it: a float x times the
    dtype's scale (rounded to x's dtype), an int8 x as it is."""
    keep = keep_mask_nchw(seeds, x, rate, row0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if x.dtype == torch.int8:
        return torch.where(keep, x, zero)
    scale = torch.tensor(scale_of(rate, x.dtype), dtype=x.dtype,
                         device=x.device)
    return torch.where(keep, x * scale, zero)


def _bank_row(bank: torch.Tensor, idx: int) -> torch.Tensor:
    """Row idx (already reduced modulo num_masks) as ``_bank_select_row``
    reads it: a max over a where, which clips a negative entry to 0 when
    there is more than one row."""
    row = bank[idx]
    return torch.clamp_min(row, 0.0) if bank.shape[0] > 1 else row


def dropout_conv_plain(x, w, seeds, rate, padding="SAME", stride=1,
                       bias=None, act=None, out_dtype=None, out_step=None,
                       row0: int = 0) -> torch.Tensor:
    """One MC sample of the float masked conv with its epilogue, in plain
    PyTorch on any device; rate 0 is the reference conv."""
    g = geometry(x.shape[2], x.shape[3], w.shape[2], w.shape[3], padding,
                 stride)
    epi = make_epi(bias, act, out_step, out_dtype)
    affine = affine_rows(bias, w.shape[0])
    if rate == 0.0:
        return epilogue_plain(conv_ref(x, w, g, stride), affine, epi)
    y = conv_f32(_hash_masked(x, seeds, rate, row0), w, g, stride)
    return epilogue_plain(y, affine, epi)


def dropout_conv_int8_plain(x_q, w_q, seeds, rate, x_step, w_step,
                            padding="SAME", stride=1, bias=None, act=None,
                            out_step=None, row0: int = 0) -> torch.Tensor:
    """One sample of the int8 masked conv: exact int32 sums, then ``f32(acc)
    · out_scale`` and the epilogue; rate 0 masks nothing."""
    g = geometry(x_q.shape[2], x_q.shape[3], w_q.shape[2], w_q.shape[3],
                 padding, stride)
    xm = _hash_masked(x_q, seeds, rate, row0) if rate > 0.0 else x_q
    return epilogue_plain(conv_int8(xm, w_q, g, stride).float(),
                          affine_rows(bias, w_q.shape[0]),
                          make_epi(bias, act, out_step, None),
                          int8_out_scale(x_step, w_step, rate))


def bank_conv_plain(x, w, bank, sample_idx, padding="SAME", stride=1,
                    bias=None, act=None, out_dtype=None, out_step=None
                    ) -> torch.Tensor:
    """``conv(x · bank[idx % n], w)`` in f32 plus the epilogue, plain."""
    g = geometry(x.shape[2], x.shape[3], w.shape[2], w.shape[3], padding,
                 stride)
    row = _bank_row(bank, bank_index(sample_idx, bank.shape[0]))
    y = conv_f32(x.float() * row.view(1, -1, 1, 1), w, g, stride)
    return epilogue_plain(y, affine_rows(bias, w.shape[0]),
                          make_epi(bias, act, out_step, out_dtype))


def bank_conv_int8_plain(x_q, w_q, bank, sample_idx, x_step, w_step,
                         padding="SAME", stride=1, bias=None, act=None,
                         out_step=None) -> torch.Tensor:
    """The int8 bank conv, plain: x_q kept where ``bank[idx % n] > 0.5``."""
    g = geometry(x_q.shape[2], x_q.shape[3], w_q.shape[2], w_q.shape[3],
                 padding, stride)
    keep = bank[bank_index(sample_idx, bank.shape[0])] > 0.5
    xm = torch.where(keep.view(1, -1, 1, 1), x_q,
                     torch.zeros((), dtype=torch.int8, device=x_q.device))
    return epilogue_plain(conv_int8(xm, w_q, g, stride).float(),
                          affine_rows(bias, w_q.shape[0]),
                          make_epi(bias, act, out_step, None),
                          bank_out_scale(x_step, w_step))


def stack_samples(ys: list[torch.Tensor]) -> torch.Tensor:
    """(S, N, F, Ho, Wo) from S (N, F, Ho, Wo) results, each sample in
    ``channels_last`` memory as the samples kernels write it."""
    return torch.stack([y.permute(0, 2, 3, 1) for y in ys]).permute(
        0, 1, 4, 2, 3)


def mask_apply_nhwc(x: torch.Tensor, seeds: torch.Tensor, rate: float,
                    apply=dropout_apply, row0: int = 0) -> torch.Tensor:
    """Dropout of an NCHW x alone with the conv kernels' exact mask,
    ``dropout_apply`` on the (N·H·W, C) view (``:566-572``) at ``row0``
    (``image_row0``): f32, scaled by the f32 ``1/(1-rate)``, in
    ``channels_last`` memory. ``apply`` is ``dropout_apply`` (the kernel on
    a CUDA tensor) or its plain version."""
    n, c, h, w = x.shape
    y = apply(x.permute(0, 2, 3, 1).reshape(-1, c), seeds, rate, row0)
    return y.view(n, h, w, c).permute(0, 3, 1, 2)


def _conv_vjp(x, w, seeds, rate, padding, stride, gy, apply, row0: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``conv(dropout(x), w)`` (``_dropout_conv_bwd``,
    ``:621-637``): the mask regenerated by ``mask_apply_nhwc`` and cast to
    x's dtype, the reference conv's transposes by autograd, dx masked
    again; both cast to the input dtypes."""
    g = geometry(x.shape[2], x.shape[3], w.shape[2], w.shape[3], padding,
                 stride)
    xm = mask_apply_nhwc(x, seeds, rate, apply, row0).to(x.dtype)
    with torch.enable_grad():
        a = xm.detach().requires_grad_(True)
        b = w.detach().requires_grad_(True)
        dxm, dw = torch.autograd.grad(conv_ref(a, b, g, stride), (a, b), gy)
    dx = mask_apply_nhwc(dxm, seeds, rate, apply, row0).to(x.dtype)
    return dx, dw.to(w.dtype)


def dropout_conv_vjp_plain(x, w, seeds, rate, gy, padding="SAME",
                           stride: int = 1, row0: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``DropoutConv``'s backward in plain PyTorch on any device: the masks
    from ``dropout_apply_plain``, the same conv transposes."""
    return _conv_vjp(x, w, seeds, rate, padding, stride, gy,
                     dropout_apply_plain, row0)


# -------------------------------------------------------------- wrappers


def _check(x: torch.Tensor, w: torch.Tensor, int8: bool) -> None:
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (N, C, H, W) and w (F, C, KH, KW); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if int8 and (x.dtype != torch.int8 or w.dtype != torch.int8):
        raise TypeError(f"x_q and w_q must both be int8; got {x.dtype} and "
                        f"{w.dtype}")
    if not int8 and (x.dtype not in _FLOAT or w.dtype not in _FLOAT):
        raise TypeError(f"x and w must be float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    n, _, h, wd = x.shape
    if n * h * wd >= 2 ** 32:
        raise ValueError("conv input too large for the 32-bit mask "
                         f"coordinate space: N·H·W = {n * h * wd} >= 2^32")
    if w.device != x.device:
        raise ValueError(f"x and w must be on one device; got {x.device} "
                         f"and {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}: the port runs "
                         "its kernels on CUDA and their plain versions on "
                         "the CPU")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be in channels_last memory (NHWC)")


def _check_bank(x: torch.Tensor, bank: torch.Tensor) -> None:
    if (bank.dim() != 2 or bank.shape[1] != x.shape[1]
            or bank.shape[0] < 1):
        raise ValueError(f"need bank (num_masks, C) with C={x.shape[1]}; "
                         f"got {tuple(bank.shape)}")
    if bank.dtype != torch.float32:
        raise TypeError(f"bank must be float32; got {bank.dtype}")
    if bank.device != x.device:
        raise ValueError(f"x and bank must be on one device; got "
                         f"{x.device} and {bank.device}")


def _check_carries(x: torch.Tensor, w: torch.Tensor, int8: bool) -> None:
    """x (S, N, C, H, W) that carries the sample axis, each sample in
    channels_last memory and the samples outermost, as ``stack_samples``
    leaves them (the _xs kernels read (S, N, H, W, C))."""
    if x.dim() != 5:
        raise ValueError(f"need x (S, N, C, H, W); got {tuple(x.shape)}")
    _check(x[0], w, int8)
    if not x.permute(0, 1, 3, 4, 2).is_contiguous():
        raise ValueError("x (S, N, C, H, W) must hold each sample in "
                         "channels_last memory, the samples outermost")


def _check_xs(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
              rate: float, int8: bool) -> None:
    """x (S, N, C, H, W) as ``_check_carries`` takes it; seeds (S, 2)."""
    _check_carries(x, w, int8)
    _check_rate_seeds(x, seeds, 2, rate)
    if seeds.shape[0] != x.shape[0]:
        raise ValueError(f"x carries {x.shape[0]} samples but "
                         f"{seeds.shape[0]} seed pairs came with it")


def _carried_indices(x: torch.Tensor, sample_idxs) -> torch.Tensor:
    """The S indices of an _xs launch (a 1-D integer tensor on x's device)
    as int32, one for each sample x carries."""
    idxs = bank_indices(sample_idxs)
    if idxs.device != x.device:
        raise ValueError(f"sample indices must be on x's device {x.device}")
    _check_carried(x, idxs)
    return idxs


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def tensor_core(entry: str, x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``bt_<entry>`` runs the tensor-core routine: the MC entries
    (``masked_conv*``) with bf16 x and w, or int8, and every bank entry
    (``bank_conv*``: int8 on the s8 tensor cores; float whatever the
    dtypes, as three TF32 products of f32 operands). An f32 or mixed-type
    MC conv runs the CUDA-core routine (bf16 or one TF32 product would
    round its products)."""
    return entry.startswith("bank_conv") or (
        x.dtype == w.dtype and x.dtype in (torch.bfloat16, torch.int8))


def staged_dtype(entry: str, w: torch.Tensor) -> torch.dtype:
    """The type ``bt_<entry>`` reads w in: f32 for the float bank entries
    (a bf16 w widens exactly), w's own for the others."""
    if entry.startswith("bank_conv") and w.dtype != torch.int8:
        return torch.float32
    return w.dtype


def conv_weights(w: torch.Tensor, mma: bool,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """The OIHW w in the layout a routine reads: (KH·KW, F, Cp) in
    ``dtype`` (default w's own) for the tensor-core one (K contiguous, C
    zero-padded to Cp, a multiple of 32 bytes of ``dtype``), (KH, KW, C,
    F) in w's type for the CUDA-core one."""
    f, c, kh, kw = w.shape
    if not mma:
        return w.permute(2, 3, 1, 0).contiguous()
    dtype = w.dtype if dtype is None else dtype
    ce = 32 // dtype.itemsize
    wk = torch.zeros((kh * kw, f, -(-c // ce) * ce), dtype=dtype,
                     device=w.device)
    wk[:, :, :c] = w.permute(2, 3, 0, 1).reshape(kh * kw, f, c)
    return wk


def _launch(entry: str, counter: str, x: torch.Tensor, w: torch.Tensor,
            head: list, num_samples: int, padding, stride: int,
            bias: torch.Tensor | None, epi: Epi, fscale: float,
            row0: int = 0) -> torch.Tensor:
    """Launch ``bt_<entry>`` of ``masked_conv.cu`` on PyTorch's current
    stream: x (NCHW, channels_last; (S, N, C, H, W) for an _xs entry), the
    OIHW w in the layout and type of the entry's routine (``conv_weights``,
    ``staged_dtype``), the
    entry's own ``head`` arguments (the mask tensors, or None, held here
    while the kernel is launched, and ints), then the common tail; the MC
    mask's ``row0`` rides in ``dims`` as its int32 bits. Returns (S, N, F,
    Ho, Wo), each sample in channels_last memory."""
    from bayestpu_torch.kernels import _build

    n, c, h, wd = x.shape[-4:]
    f, _, kh, kw = w.shape
    g = geometry(h, wd, kh, kw, padding, stride)
    out_dtype, out_kind = _OUT[epi.out]
    out = torch.empty((num_samples, n, g.ho, g.wo, f), dtype=out_dtype,
                      device=x.device)
    if out.numel():
        affine = affine_rows(bias, f)
        if affine is not None and affine.device != x.device:
            raise ValueError(f"bias must be on x's device {x.device}")
        w_k = conv_weights(w, tensor_core(entry, x, w),
                           staged_dtype(entry, w))
        head = [a.contiguous() if isinstance(a, torch.Tensor) else a
                for a in head]
        dims = (ctypes.c_int * 14)(n, h, wd, c, f, kh, kw, stride, g.ph,
                                   g.pw, g.ho, g.wo, num_samples,
                                   int32_bits(row0))
        lib = _build.library("masked_conv")
        with torch.cuda.device(x.device):
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            rc = getattr(lib, "bt_" + entry)(
                _ptr(x), _ptr(w_k),
                *(a if isinstance(a, int) else _ptr(a) for a in head),
                _ptr(affine), _ptr(out), dims,
                fscale, out_kind, int(epi.act == "relu"), epi.inv_step,
                int(x.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"{entry} kernel failed to launch: "
                               f"cudaError_t {rc}")
        launch_counts[counter] += 1
        work_counts[counter] += 2 * num_samples * conv_macs(
            n, c, f, h, wd, kh, kw, g, stride)
    return out.permute(0, 1, 4, 2, 3)


def _seeds_arg(seeds: torch.Tensor, rate: float) -> list:
    return [seeds, keep_threshold(rate)]


# ------------------------------------------------------- MC dropout, float


class DropoutConv(torch.autograd.Function):
    """``conv(dropout(x), w)`` whose backward regenerates the mask from the
    seeds instead of storing it (``_dropout_conv_fwd``/``_bwd``,
    ``:608-637``). Forward: the single masked-conv kernel, f32 out, no
    epilogue. Backward: ``xm = mask_apply_nhwc(x).to(x.dtype)``; ``dxm, dw``
    from the reference conv's transposes (cuDNN on the card, XLA's in JAX);
    ``dx = mask_apply_nhwc(dxm)``; both cast to the input dtypes."""

    @staticmethod
    def forward(ctx, x, w, seeds, rate, padding, stride, row0):
        ctx.save_for_backward(x, w, seeds)
        ctx.conf = (rate, padding, stride, row0)
        if x.device.type == "cpu":
            return dropout_conv_plain(x, w, seeds, rate, padding, stride,
                                      row0=row0)
        return _launch("masked_conv", "dropout_conv", x, w,
                       _seeds_arg(seeds, rate), 1, padding, stride, None,
                       Epi(), scale_of(rate, x.dtype), row0)[0]

    @staticmethod
    def backward(ctx, gy):
        x, w, seeds = ctx.saved_tensors
        rate, padding, stride, row0 = ctx.conf
        dx, dw = _conv_vjp(x, w, seeds, rate, padding, stride, gy,
                           dropout_apply, row0)
        return dx, dw, None, None, None, None, None


def dropout_conv(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                 rate: float, padding="SAME", stride: int = 1, row0: int = 0
                 ) -> torch.Tensor:
    """``conv(dropout(x), w)`` with the mask fused into the kernel;
    trainable through ``DropoutConv``. x (N, C, H, W) f32/bf16 in
    channels_last memory, w (F, C, KH, KW) f32/bf16, seeds (2,) int32 on
    x's device. Returns (N, F, Ho, Wo) f32 (channels_last), no epilogue.
    Rate 0 is the reference conv (autograd through it)."""
    _check(x, w, False)
    _check_rate_seeds(x, seeds, 1, rate)
    if rate == 0.0:
        g = geometry(x.shape[2], x.shape[3], w.shape[2], w.shape[3],
                     padding, stride)
        return conv_ref(x, w, g, stride)
    return DropoutConv.apply(x, w, seeds, rate, padding, stride, row0)


def _dropout_conv_one(x, w, seeds, rate, padding, stride, bias, act,
                      out_dtype, out_step, row0) -> torch.Tensor:
    """One MC sample with the epilogue (the single kernel)."""
    if x.device.type == "cpu" or rate == 0.0:
        return dropout_conv_plain(x, w, seeds, rate, padding, stride, bias,
                                  act, out_dtype, out_step, row0)
    return _launch("masked_conv", "dropout_conv", x, w,
                   _seeds_arg(seeds, rate), 1, padding, stride, bias,
                   make_epi(bias, act, out_step, out_dtype),
                   scale_of(rate, x.dtype), row0)[0]


def dropout_conv_samples(x: torch.Tensor, w: torch.Tensor,
                         seeds: torch.Tensor, rate: float, padding="SAME",
                         bias=None, act=None, out_dtype=None, out_step=None,
                         stride: int = 1, row0: int = 0) -> torch.Tensor:
    """Every MC sample in one launch: seeds (S, 2) int32; (S, N, F, Ho, Wo),
    sample s bit-identical to the single kernel with seeds[s] and the same
    epilogue. Rate 0 is the reference conv repeated S times."""
    _check(x, w, False)
    _check_rate_seeds(x, seeds, 2, rate)
    epi = make_epi(bias, act, out_step, out_dtype)
    if rate == 0.0:
        y = dropout_conv_plain(x, w, seeds, 0.0, padding, stride, bias, act,
                               out_dtype, out_step)
        return stack_samples([y] * seeds.shape[0])
    if x.device.type == "cpu":
        return stack_samples([
            dropout_conv_plain(x, w, seeds[s], rate, padding, stride, bias,
                               act, out_dtype, out_step, row0)
            for s in range(seeds.shape[0])])
    return _launch("masked_conv", "dropout_conv_samples", x, w,
                   _seeds_arg(seeds, rate), seeds.shape[0], padding, stride,
                   bias, epi, scale_of(rate, x.dtype), row0)


def dropout_conv_inference(x: torch.Tensor, w: torch.Tensor,
                           seeds: torch.Tensor, rate: float, padding="SAME",
                           bias=None, act=None, out_dtype=None,
                           out_step=None, stride: int = 1, row0: int = 0
                           ) -> torch.Tensor:
    """The inference entry of the MC conv sites (``:753-775`` and the vmap
    rule ``:732-748``): seeds (2,) → one sample, (N, F, Ho, Wo); seeds (S,
    2) with x (N, C, H, W) → every sample in one samples launch; seeds (S,
    2) with x (S, N, C, H, W) → sample s of x under seeds[s], as JAX's
    ``lax.map`` fallback runs the single kernel per sample: one _xs launch
    on the card, the single plain version per sample on the CPU. Rate 0
    without an epilogue is the reference conv alone."""
    if x.dim() == 5:
        _check_xs(x, w, seeds, rate, False)
        if x.device.type == "cpu" or rate == 0.0:
            return map_samples(
                lambda xs, sd: _dropout_conv_one(
                    xs, w, sd, rate, padding, stride, bias, act, out_dtype,
                    out_step, row0), x, seeds, stack_samples)
        return _launch("masked_conv_xs", "dropout_conv_xs", x, w,
                       _seeds_arg(seeds, rate), x.shape[0], padding, stride,
                       bias, make_epi(bias, act, out_step, out_dtype),
                       scale_of(rate, x.dtype), row0)
    if seeds.dim() == 2:
        return dropout_conv_samples(x, w, seeds, rate, padding, bias, act,
                                    out_dtype, out_step, stride, row0)
    _check(x, w, False)
    _check_rate_seeds(x, seeds, 1, rate)
    return _dropout_conv_one(x, w, seeds, rate, padding, stride, bias, act,
                             out_dtype, out_step, row0)


def conv_fused_plain(x, w, bias=None, act=None, out_dtype=None,
                     out_step=None, padding="SAME", stride: int = 1
                     ) -> torch.Tensor:
    """``conv_fused`` in plain PyTorch on any device: f32 sums of the
    widened operands (no bf16 rounding of the conv), then the epilogue."""
    g = geometry(x.shape[2], x.shape[3], w.shape[2], w.shape[3], padding,
                 stride)
    return epilogue_plain(conv_f32(x, w, g, stride),
                          affine_rows(bias, w.shape[0]),
                          make_epi(bias, act, out_step, out_dtype))


def conv_fused(x: torch.Tensor, w: torch.Tensor, bias=None, act=None,
               out_dtype=None, out_step=None, padding="SAME",
               stride: int = 1) -> torch.Tensor:
    """The mask-free conv with the fused epilogue (``:662-676``): row 10's
    kernel without a mask, f32 sums, inference only."""
    _check(x, w, False)
    if x.device.type == "cpu":
        return conv_fused_plain(x, w, bias, act, out_dtype, out_step,
                                padding, stride)
    return _launch("masked_conv", "conv_fused", x, w, [None, 0], 1,
                   padding, stride, bias,
                   make_epi(bias, act, out_step, out_dtype), 1.0)[0]


# --------------------------------------------------------- MC dropout, int8


def _int8_one(x_q, w_q, seeds, rate, x_step, w_step, padding, stride, bias,
              act, out_step, row0) -> torch.Tensor:
    if x_q.device.type == "cpu":
        return dropout_conv_int8_plain(x_q, w_q, seeds, rate, x_step, w_step,
                                       padding, stride, bias, act, out_step,
                                       row0)
    head = _seeds_arg(seeds, rate) if rate > 0.0 else [None, 0]
    return _launch("masked_conv_int8", "dropout_conv_int8", x_q, w_q, head,
                   1, padding, stride, bias,
                   make_epi(bias, act, out_step, None),
                   int8_out_scale(x_step, w_step, rate), row0)[0]


def dropout_conv_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                      seeds: torch.Tensor, rate: float, x_step: float,
                      w_step: float, padding="SAME", bias=None, act=None,
                      out_step=None, stride: int = 1, row0: int = 0
                      ) -> torch.Tensor:
    """``dequant(conv(dropout(x_q), w_q))`` in int8 (``:899-921``): x_q and
    w_q int8 on the ap_fixed grid, seeds (2,); the float kernels' mask,
    exact int32 sums, ``f32(acc) · f32(x_step·w_step/(1-rate))``, then the
    epilogue (an int8 output with ``out_step``). Inference only."""
    _check(x_q, w_q, True)
    _check_rate_seeds(x_q, seeds, 1, rate)
    return _int8_one(x_q, w_q, seeds, rate, x_step, w_step, padding, stride,
                     bias, act, out_step, row0)


def dropout_conv_int8_samples(x_q: torch.Tensor, w_q: torch.Tensor,
                              seeds: torch.Tensor, rate: float,
                              x_step: float, w_step: float, padding="SAME",
                              bias=None, act=None, out_step=None,
                              stride: int = 1, row0: int = 0
                              ) -> torch.Tensor:
    """Every int8 MC sample in one launch: seeds (S, 2); sample s
    bit-identical to ``dropout_conv_int8`` with seeds[s]."""
    _check(x_q, w_q, True)
    _check_rate_seeds(x_q, seeds, 2, rate)
    if x_q.device.type == "cpu":
        return stack_samples([
            dropout_conv_int8_plain(x_q, w_q, seeds[s], rate, x_step, w_step,
                                    padding, stride, bias, act, out_step,
                                    row0)
            for s in range(seeds.shape[0])])
    head = _seeds_arg(seeds, rate) if rate > 0.0 else [None, 0]
    return _launch("masked_conv_int8", "dropout_conv_int8_samples",
                   x_q, w_q, head, seeds.shape[0], padding, stride, bias,
                   make_epi(bias, act, out_step, None),
                   int8_out_scale(x_step, w_step, rate), row0)


def dropout_conv_int8_inference(x_q: torch.Tensor, w_q: torch.Tensor,
                                seeds: torch.Tensor, rate: float,
                                x_step: float, w_step: float, padding="SAME",
                                bias=None, act=None, out_step=None,
                                stride: int = 1, row0: int = 0
                                ) -> torch.Tensor:
    """The int8 twin of ``dropout_conv_inference`` (``:948-998``), with the
    same three dispatch cases (an x carrying the sample axis: one _xs
    launch on the card, at rate 0 without a mask)."""
    if x_q.dim() == 5:
        _check_xs(x_q, w_q, seeds, rate, True)
        if x_q.device.type == "cpu":
            return map_samples(
                lambda xs, sd: _int8_one(xs, w_q, sd, rate, x_step, w_step,
                                         padding, stride, bias, act,
                                         out_step, row0), x_q, seeds,
                stack_samples)
        head = _seeds_arg(seeds, rate) if rate > 0.0 else [None, 0]
        return _launch("masked_conv_int8_xs", "dropout_conv_int8_xs", x_q,
                       w_q, head, x_q.shape[0], padding, stride, bias,
                       make_epi(bias, act, out_step, None),
                       int8_out_scale(x_step, w_step, rate), row0)
    if seeds.dim() == 2:
        return dropout_conv_int8_samples(x_q, w_q, seeds, rate, x_step,
                                         w_step, padding, bias, act,
                                         out_step, stride, row0)
    return dropout_conv_int8(x_q, w_q, seeds, rate, x_step, w_step, padding,
                             bias, act, out_step, stride, row0)


def conv_int8_fused(x_q: torch.Tensor, w_q: torch.Tensor, x_step: float,
                    w_step: float, bias=None, act=None, out_step=None,
                    padding="SAME", stride: int = 1) -> torch.Tensor:
    """Plain int8 conv + epilogue (``:878-896``): ``f32(acc) ·
    f32(x_step·w_step)`` with no mask; its plain version is
    ``dropout_conv_int8_plain`` at rate 0."""
    _check(x_q, w_q, True)
    if x_q.device.type == "cpu":
        return dropout_conv_int8_plain(x_q, w_q, None, 0.0, x_step, w_step,
                                       padding, stride, bias, act, out_step)
    return _launch("masked_conv_int8", "conv_int8_fused", x_q, w_q,
                   [None, 0], 1, padding, stride, bias,
                   make_epi(bias, act, out_step, None),
                   bank_out_scale(x_step, w_step))[0]


# ------------------------------------------------------------ Masksembles


def bank_conv(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
              sample_idx, padding="SAME", bias=None, act=None,
              out_dtype=None, out_step=None, stride: int = 1
              ) -> torch.Tensor:
    """``conv(x · bank[sample_idx % n], w)`` in f32 plus the epilogue
    (``:781-798``): x f32/bf16, w f32/bf16 (a bf16 w widened exactly; the
    Masksembles branch passes the f32 folded kernel), bank (n, C) f32, an
    int index. On the card the tensor-core routine stages the masked value
    ``f32(x) · b`` and the f32 w and multiplies them as three TF32
    products (about 22 bits of each f32 product), summed in f32 a chunk of
    8 channels at a time."""
    _check(x, w, False)
    _check_bank(x, bank)
    idx = bank_index(sample_idx, bank.shape[0])
    if x.device.type == "cpu":
        return bank_conv_plain(x, w, bank, idx, padding, stride, bias, act,
                               out_dtype, out_step)
    return _launch("bank_conv", "bank_conv", x, w,
                   [bank, idx, bank.shape[0]], 1, padding,
                   stride, bias, make_epi(bias, act, out_step, out_dtype),
                   1.0)[0]


def bank_conv_samples(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                      sample_idxs: torch.Tensor, padding="SAME", bias=None,
                      act=None, out_dtype=None, out_step=None,
                      stride: int = 1) -> torch.Tensor:
    """Every mask index in one launch: sample_idxs (S,) integer on x's
    device; (S, N, F, Ho, Wo), sample s bit-identical to ``bank_conv`` at
    sample_idxs[s]."""
    _check(x, w, False)
    _check_bank(x, bank)
    idxs = bank_indices(sample_idxs)
    if x.device.type == "cpu":
        return stack_samples([
            bank_conv_plain(x, w, bank, i, padding, stride, bias, act,
                            out_dtype, out_step) for i in idxs.tolist()])
    if idxs.device != x.device:
        raise ValueError(f"sample indices must be on x's device {x.device}")
    return _launch("bank_conv_samples", "bank_conv_samples", x, w,
                   [bank, idxs, bank.shape[0]],
                   idxs.shape[0], padding, stride, bias,
                   make_epi(bias, act, out_step, out_dtype), 1.0)


def bank_conv_xs(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                 sample_idxs, padding="SAME", bias=None, act=None,
                 out_dtype=None, out_step=None, stride: int = 1
                 ) -> torch.Tensor:
    """S samples of an x (S, N, C, H, W) that carries the sample axis
    (``stack_samples``'s layout), sample s of x under index s, as JAX's
    vmap rule maps the single kernel (``lax.map``, ``:845-851``): one
    launch on the card, sample s bit-identical to ``bank_conv`` on x[s];
    the single plain version per sample on the CPU. ``sample_idxs``: S
    indices, a 1-D integer tensor (on the CPU also a list of ints)."""
    _check_carries(x, w, False)
    _check_bank(x[0], bank)
    if x.device.type == "cpu":
        return map_samples(
            lambda xs, i: bank_conv(xs, w, bank, i, padding, bias, act,
                                    out_dtype, out_step, stride),
            x, host_indices(sample_idxs), stack_samples)
    idxs = _carried_indices(x, sample_idxs)
    return _launch("bank_conv_xs", "bank_conv_xs", x, w,
                   [bank, idxs, bank.shape[0]], x.shape[0], padding, stride,
                   bias, make_epi(bias, act, out_step, out_dtype), 1.0)


def bank_conv_inference(x: torch.Tensor, w: torch.Tensor, bank: torch.Tensor,
                        sample_idx, padding="SAME", bias=None, act=None,
                        out_dtype=None, out_step=None, stride: int = 1
                        ) -> torch.Tensor:
    """The inference entry of the Masksembles conv sites (``:856-872`` and
    the vmap rule ``:833-851``): an int index → one sample; S indices with x
    (N, C, H, W) → one samples launch; S indices (a tensor, or a list of
    ints) with x (S, N, C, H, W) → ``bank_conv_xs``, sample s of x under
    index s."""
    if x.dim() == 5:
        return bank_conv_xs(x, w, bank, sample_idx, padding, bias, act,
                            out_dtype, out_step, stride)
    if is_index_vector(sample_idx):
        return bank_conv_samples(x, w, bank, sample_idx, padding, bias, act,
                                 out_dtype, out_step, stride)
    return bank_conv(x, w, bank, sample_idx, padding, bias, act, out_dtype,
                     out_step, stride)


def bank_conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, bank: torch.Tensor,
                   sample_idx, x_step: float, w_step: float, padding="SAME",
                   bias=None, act=None, out_step=None, stride: int = 1
                   ) -> torch.Tensor:
    """The int8 Masksembles conv (``:1001-1019``): x_q kept where
    ``bank[idx % n] > 0.5``, exact int32 sums (on the card row 10's s8
    tensor-core routine with a bank-row mask), ``f32(acc) ·
    f32(x_step·w_step)``, then the epilogue."""
    _check(x_q, w_q, True)
    _check_bank(x_q, bank)
    idx = bank_index(sample_idx, bank.shape[0])
    if x_q.device.type == "cpu":
        return bank_conv_int8_plain(x_q, w_q, bank, idx, x_step, w_step,
                                    padding, stride, bias, act, out_step)
    return _launch("bank_conv_int8", "bank_conv_int8", x_q, w_q,
                   [bank, idx, bank.shape[0]], 1, padding,
                   stride, bias, make_epi(bias, act, out_step, None),
                   bank_out_scale(x_step, w_step))[0]


def bank_conv_int8_samples(x_q: torch.Tensor, w_q: torch.Tensor,
                           bank: torch.Tensor, sample_idxs: torch.Tensor,
                           x_step: float, w_step: float, padding="SAME",
                           bias=None, act=None, out_step=None,
                           stride: int = 1) -> torch.Tensor:
    """Every mask index of the int8 conv in one launch; sample s
    bit-identical to ``bank_conv_int8`` at sample_idxs[s]."""
    _check(x_q, w_q, True)
    _check_bank(x_q, bank)
    idxs = bank_indices(sample_idxs)
    if x_q.device.type == "cpu":
        return stack_samples([
            bank_conv_int8_plain(x_q, w_q, bank, i, x_step, w_step, padding,
                                 stride, bias, act, out_step)
            for i in idxs.tolist()])
    if idxs.device != x_q.device:
        raise ValueError(f"sample indices must be on x's device {x_q.device}")
    return _launch("bank_conv_int8_samples", "bank_conv_int8_samples", x_q,
                   w_q, [bank, idxs, bank.shape[0]],
                   idxs.shape[0], padding, stride, bias,
                   make_epi(bias, act, out_step, None),
                   bank_out_scale(x_step, w_step))


def bank_conv_int8_xs(x_q: torch.Tensor, w_q: torch.Tensor,
                      bank: torch.Tensor, sample_idxs, x_step: float,
                      w_step: float, padding="SAME", bias=None, act=None,
                      out_step=None, stride: int = 1) -> torch.Tensor:
    """The int8 twin of ``bank_conv_xs`` (JAX's ``lax.map``,
    ``:1070-1076``): one launch on the card, sample s bit-identical to
    ``bank_conv_int8`` on x_q[s] at index s."""
    _check_carries(x_q, w_q, True)
    _check_bank(x_q[0], bank)
    if x_q.device.type == "cpu":
        return map_samples(
            lambda xs, i: bank_conv_int8(xs, w_q, bank, i, x_step, w_step,
                                         padding, bias, act, out_step,
                                         stride),
            x_q, host_indices(sample_idxs), stack_samples)
    idxs = _carried_indices(x_q, sample_idxs)
    return _launch("bank_conv_int8_xs", "bank_conv_int8_xs", x_q, w_q,
                   [bank, idxs, bank.shape[0]], x_q.shape[0], padding,
                   stride, bias, make_epi(bias, act, out_step, None),
                   bank_out_scale(x_step, w_step))


def bank_conv_int8_inference(x_q: torch.Tensor, w_q: torch.Tensor,
                             bank: torch.Tensor, sample_idx, x_step: float,
                             w_step: float, padding="SAME", bias=None,
                             act=None, out_step=None, stride: int = 1
                             ) -> torch.Tensor:
    """The int8 twin of ``bank_conv_inference`` (``:1081-1097``): an x
    (S, N, C, H, W) goes to ``bank_conv_int8_xs``."""
    if x_q.dim() == 5:
        return bank_conv_int8_xs(x_q, w_q, bank, sample_idx, x_step, w_step,
                                 padding, bias, act, out_step, stride)
    if is_index_vector(sample_idx):
        return bank_conv_int8_samples(x_q, w_q, bank, sample_idx, x_step,
                                      w_step, padding, bias, act, out_step,
                                      stride)
    return bank_conv_int8(x_q, w_q, bank, sample_idx, x_step, w_step,
                          padding, bias, act, out_step, stride)
