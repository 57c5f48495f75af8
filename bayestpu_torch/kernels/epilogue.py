"""The bf16 epilogue of a conv without a mask at inference, in one pass:
the plain PyTorch version and the wrapper of the CUDA kernel in
``bayestpu_torch/csrc/epilogue.cu``.

In a bf16 float model at inference (no ``quant``) a conv that no masked
kernel takes is cuDNN's (``nn.layers.xla_conv_raw``, the JAX package's XLA
conv), and its epilogue follows the JAX package's roundings
(``bayestpu/nn/fused.py:465-474``): the conv's output rounded to bf16,
widened to f32, plus the f32 bias of the folded BatchNorm, relu when asked,
rounded to bf16; at a residual block's end, ``relu(y + residual)`` in bf16
(``bayestpu/nn/zoo/resnet.py``), which rounds the sum once more. It
replaces no TPU kernel: the JAX package leaves this epilogue to XLA's
fusion, where PyTorch would run five elementwise kernels over f32 copies
(28 bytes an element after a relu conv, 10 more for the residual). The
kernel reads the conv's bf16 output once and writes bf16 once, 4 bytes an
element or 6 with the residual: its bound is HBM bytes.

``bias_act_bf16(y, bias, act, residual=None)`` takes y, the conv's bf16
output, (..., C, H, W) with the channel innermost in memory (an NCHW tensor
in ``channels_last`` memory; an x (S, N, C, H, W) that carries the sample
axis as ``xla_conv_raw`` returns it), an f32 (C,) ``bias`` or None, ``act``
None or "relu", and a bf16 ``residual`` of y's shape or None, and returns a
new bf16 tensor in y's layout, equal to ``bias_act_bf16_plain`` bit for
bit. A tensor whose channel is not innermost in memory (a channel slice) is
copied into that layout first; an unaligned one takes the kernel's scalar
path.

Dispatch is by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel (or raise), any other device raises. Each launch
of the kernel adds one to ``launch_counts``, as ``masked_conv``'s and
``masked_matmul``'s launches do theirs. The profiler counters
``epilogue.launches`` and, with a residual, ``epilogue.residual_launches``
(``utils.profiler.count``) count the route's passes instead, on every
device, as a forward runs them (at capture for a served graph), as
``sites.conv_launches`` counts the masked convs: the CPU tests read them.
"""

from __future__ import annotations

import ctypes

import torch

from bayestpu_torch.kernels.masked_conv import _ptr
from bayestpu_torch.utils.profiler import count

# Launches of the CUDA kernel since the last reset; CPU calls do not count.
launch_counts: dict[str, int] = {"bias_act_bf16": 0}


def reset_launch_counts() -> None:
    """Zero ``launch_counts``."""
    for name in launch_counts:
        launch_counts[name] = 0


def bias_act_bf16_plain(y: torch.Tensor, bias: torch.Tensor | None,
                        act: str | None = None,
                        residual: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The epilogue as PyTorch ops, in the kernel's order: ``y.float()``,
    plus ``bias`` over the channels, relu, ``.to(bfloat16)``, then
    ``relu(t + residual)`` in bf16."""
    t = y.float()
    if bias is not None:
        t = t + bias[:, None, None]
    if act == "relu":
        t = torch.relu(t)
    t = t.to(torch.bfloat16)
    if residual is not None:
        t = torch.relu(t + residual)
    return t


def _check(y: torch.Tensor, bias: torch.Tensor | None, act: str | None,
           residual: torch.Tensor | None) -> None:
    if act not in (None, "relu"):
        raise ValueError(f"act must be None or 'relu'; got {act!r}")
    if y.dtype != torch.bfloat16 or y.dim() < 3:
        raise ValueError(f"y must be bf16 (..., C, H, W); got {y.dtype} "
                         f"{tuple(y.shape)}")
    if bias is not None and tuple(bias.shape) != (y.shape[-3],):
        raise ValueError(f"bias must be ({y.shape[-3]},); got "
                         f"{tuple(bias.shape)}")
    if residual is not None and (residual.dtype != torch.bfloat16
                                 or residual.shape != y.shape):
        raise ValueError(f"residual must be bf16 {tuple(y.shape)}; got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    for t in (bias, residual):
        if t is not None and t.device != y.device:
            raise ValueError(f"every operand must be on y's device "
                             f"{y.device}; got {t.device}")


def bias_act_bf16(y: torch.Tensor, bias: torch.Tensor | None,
                  act: str | None = None,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """The conv's bf16 output y with the f32 ``bias``, ``act`` and the
    block's ``residual`` (see the module docstring): one launch of
    ``bt_bias_act_bf16`` on the card, the plain version on the CPU."""
    _check(y, bias, act, residual)
    count("epilogue.launches")
    if residual is not None:
        count("epilogue.residual_launches")
    if y.device.type == "cpu":
        return bias_act_bf16_plain(y, bias, act, residual)
    if y.device.type != "cuda":
        raise ValueError(f"bias_act_bf16 runs on the CPU or a CUDA card; "
                         f"got {y.device}")
    return _launch(y, bias, act, residual)


def _channels_inner(t: torch.Tensor) -> torch.Tensor:
    """t (..., C, H, W) itself when its channel is innermost in memory and
    the rest dense ((…, H, W, C) contiguous), else such a copy."""
    v = t.movedim(-3, -1)
    return t if v.is_contiguous() else v.contiguous().movedim(-1, -3)


def _launch(y: torch.Tensor, bias: torch.Tensor | None, act: str | None,
            residual: torch.Tensor | None) -> torch.Tensor:
    """Launch ``bt_bias_act_bf16`` on PyTorch's current stream over y as
    (rows, C); the output is fresh, in y's layout."""
    from bayestpu_torch.kernels import _build

    y = _channels_inner(y)
    res = None if residual is None else _channels_inner(residual)
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty_like(y)
    c = y.shape[-3]
    rows = y.numel() // c if c else 0
    lib = _build.library("epilogue")
    with torch.cuda.device(y.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.bt_bias_act_bf16(
            _ptr(y), _ptr(b), _ptr(res), _ptr(out), rows, c,
            int(act == "relu"), stream)
    if rc != 0:
        raise RuntimeError(f"bias_act_bf16 kernel failed to launch: "
                           f"cudaError_t {rc}")
    launch_counts["bias_act_bf16"] += 1
    return out
