"""Kernel-level microbenchmarks: the port's CUDA kernels against their
library calls and the unfused paths they replace (counterpart of
``bench/kernels.py``).

On the card: ``python -m bayestpu_torch.bench.kernels`` (``--device cpu``
runs the plain versions, to check the harness). Shapes model the MC head
the reference replicates on fabric (backbone feature width K → classes N)
plus one compute-bound shape, and three vgg11-like convs. Prints one JSON
object a shape. Every entry has ``<name>_ms``, the per-call time of a
stream of calls (``utils.timing.pipelined_s``: CUDA-event windows, the
host's dispatch included where it is the bottleneck) and ``<name>_scan_ms``,
the device time of serially dependent calls replayed from a CUDA graph
(``utils.timing.scan_time_s``; the carry feeds each call through its
seeds, which adds a cast and an add, and the sum of the output, about
five small kernels a call).
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from bayestpu_torch.cli.common import add_device_arg
from bayestpu_torch.core.config import QuantConfig
from bayestpu_torch.core.quant import int_mm, quantize_int8
from bayestpu_torch.engine.engine import resolve_device
from bayestpu_torch.kernels import masked_conv as mc
from bayestpu_torch.kernels import masked_matmul as mm
from bayestpu_torch.utils.timing import pipelined_s, scan_time_s

RATE = 0.3
S = 10
INT8 = QuantConfig(total_bits=8, integer_bits=2, int8_infer=True)


def _seeds(n: int, device: torch.device) -> torch.Tensor:
    return (torch.arange(2 * n, dtype=torch.int32).reshape(n, 2) * 29
            + 5).to(device)


def _times(fns: dict, seeds: torch.Tensor, device: torch.device,
           min_diff_s: float) -> dict:
    """``<name>_ms`` and ``<name>_scan_ms`` of each ``fns[name](seeds)``;
    in the scan the carry feeds the seeds."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = pipelined_s(lambda: fn(seeds), device,
                                        min_diff_s=min_diff_s) * 1e3
        out[f"{name}_scan_ms"] = scan_time_s(
            lambda c: fn(seeds + c.to(torch.int32)), device,
            min_diff_s=min_diff_s).median_s * 1e3
    return out


def bench_shape(m: int, k: int, n: int, device="cuda",
                min_diff_s: float = 0.3) -> dict:
    """Rows 3, 2 and 4 (the samples head, the single f32 head, the single
    int8 head) at x (m, k) @ w (k, n), S samples, against S single launches,
    the unfused path (S masked copies of x, then one matmul) and the
    library call on a pre-masked input (``torch.matmul``, and ``_int_mm``
    for int8)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=gen).to(dev)
    w = (torch.randn(k, n, generator=gen) * 0.5).to(dev)
    seeds = _seeds(S, dev)
    xq, xs = quantize_int8(x, INT8)
    wq, ws = quantize_int8(w, INT8)
    masked = torch.stack([mm.dropout_apply(x, seeds[s], RATE)
                          for s in range(S)])
    masked_q = xq * mm.keep_mask(seeds[0], m, k, RATE).to(torch.int8)

    def unfused(sd):
        keep = torch.stack([mm.keep_mask(sd[s], m, k, RATE)
                            for s in range(S)])
        return torch.where(keep, x / (1 - RATE), 0.0) @ w

    fns = {
        "multi_sample_kernel": lambda sd: mm.dropout_matmul_samples(
            x, w, sd, RATE),
        "vmap_fused": lambda sd: [mm.dropout_matmul(x, w, sd[s], RATE)
                                  for s in range(S)],
        "vmap_unfused_hbm_masks": unfused,
        "library_matmul_premasked": lambda sd: masked @ w + sd[0, 0],
        "one_sample_int8": lambda sd: mm.dropout_matmul_int8(
            xq, wq, sd[0], RATE, xs, ws),
        "library_int_mm_premasked": lambda sd: int_mm(masked_q, wq)
        + sd[0, 0],
        "one_sample_f32": lambda sd: mm.dropout_matmul(x, w, sd[0], RATE),
    }
    with torch.no_grad():
        return {"shape": [m, k, n], "mc_samples": S, "device": str(dev),
                **_times(fns, seeds, dev, min_diff_s)}


def bench_conv_shape(b: int, h: int, w: int, c: int, f: int, k: int = 3,
                     device="cuda", min_diff_s: float = 0.3) -> dict:
    """Row 10 (the MC masked conv: one sample, four samples, int8) and
    row 11 (the bank conv) against the unfused path they replace (the
    mask kernel, the masked x through memory, then cuDNN) and the plain
    cuDNN conv. x (b, c, h, w) f32 channels_last, w (f, c, k, k)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, c, h, w, generator=gen).to(dev).contiguous(
        memory_format=torch.channels_last)
    wk = (torch.randn(f, c, k, k, generator=gen) * 0.1).to(dev)
    seeds = _seeds(S, dev)
    bank = ((torch.rand(4, c, generator=gen) > 0.5).float() * 2.0).to(dev)
    xq, xs = quantize_int8(x, INT8)
    xq = xq.contiguous(memory_format=torch.channels_last)
    wq, ws = quantize_int8(wk, INT8)

    def conv(a):
        return F.conv2d(a, wk, padding="same")

    fns = {
        "fused_dropout_conv": lambda sd: mc.dropout_conv(x, wk, sd[0], RATE),
        "unfused_mask_hbm_cudnn_conv": lambda sd: conv(
            mc.mask_apply_nhwc(x, sd[0], RATE)),
        "plain_cudnn_conv": lambda sd: conv(x) + sd[0, 0],
        "fused_4sample_conv": lambda sd: mc.dropout_conv_samples(
            x, wk, sd[:4], RATE),
        "fused_bank_conv": lambda sd: mc.bank_conv(x, wk, bank, 1)
        + sd[0, 0],
        "unfused_bank_cudnn_conv": lambda sd: conv(x * bank[1, :, None, None])
        + sd[0, 0],
        "fused_int8_conv": lambda sd: mc.dropout_conv_int8(
            xq, wq, sd[0], RATE, xs, ws),
    }
    gflop = 2 * b * h * w * c * f * k * k / 1e9
    with torch.no_grad():
        out = {"conv_shape": [b, h, w, c, f, k], "gflop_per_sample": gflop,
               "device": str(dev), **_times(fns, seeds, dev, min_diff_s)}
    out["fused_tflops"] = gflop / out["fused_dropout_conv_ms"]
    out["vs_unfused"] = (out["unfused_mask_hbm_cudnn_conv_ms"]
                         / out["fused_dropout_conv_ms"])
    return out


HEAD_SHAPES = [(128, 512, 10),       # vgg11 head (the reference's mc head)
               (1024, 512, 128),     # wide-batch head
               (1024, 2048, 1024)]   # compute-bound
CONV_SHAPES = [(128, 32, 32, 64, 128),    # vgg11 block-2 conv
               (128, 16, 16, 256, 256),   # mid-net conv
               (128, 8, 8, 512, 512)]     # deep conv


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = [bench_shape(*s, device=a.device) for s in HEAD_SHAPES]
    rows += [bench_conv_shape(*s, device=a.device) for s in CONV_SHAPES]
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
