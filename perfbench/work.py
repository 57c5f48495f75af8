"""Operations and bytes from a configuration's shapes, the peaks of the
card, and the groups of kernel names the trace readers sort kernels into.

The counts are of the work the configuration needs, whatever the program
launches to do it: a conv is 2·Cin·Cout·k²·pixels operations an image, a
dense layer 2·K·N a row, an MC head 2·K·N a row and a sample. A spatial
predictive runs the layers before the heads once and each head S times; a
training step is three times the forward (the forward, and the backward's
two products a layer). Bytes of a head are its inputs read once and its
output written once.

Peaks are NVIDIA's for one H100 SXM at 700 W, dense: 989 TFLOP/s bf16,
1,979 TOP/s int8, 495 TFLOP/s TF32, 67 TFLOP/s f32, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "tf32": 495e12,
            "float32": 67e12}
PEAK_BYTES = 3.35e12
ELT_BYTES = {"bfloat16": 2, "int8": 1, "float32": 4}

# the program's own CUDA kernels (``bayestpu_torch/csrc``)
PORT_KERNELS = ("chain_samples_kernel", "int8_samples_mma_kernel",
                "conv_mma_kernel", "dropout_apply_kernel")
# the MC heads' kernels: the float and the int8 samples kernel
HEAD_KERNELS = ("chain_samples_kernel", "int8_samples_mma_kernel")
# cuBLAS(Lt) and cuDNN GEMM and conv kernels
LIBRARY_MATH = ("gemm", "gemv", "xmma", "cutlass", "cudnn", "conv", "nvjet",
                "implicit", "winograd", "fft", "dgrad", "wgrad", "fprop",
                "splitk")


def kernel_group(name: str) -> str:
    """"port", "library" or "elementwise" for a kernel's name."""
    if any(k in name for k in PORT_KERNELS):
        return "port"
    low = name.lower()
    if any(k in low for k in LIBRARY_MATH):
        return "library"
    return "elementwise"


def is_head_kernel(name: str) -> bool:
    return any(k in name for k in HEAD_KERNELS)


def layer_ops(layer: dict) -> int:
    """Operations of one layer for one image (a head: for one sample)."""
    if layer["op"] == "conv":
        return 2 * layer["cin"] * layer["cout"] * layer["k"] ** 2 * (
            layer["pixels"])
    return 2 * layer["k"] * layer["n"]


def conv_macs(shapes: list[dict], prefix: str = "") -> int:
    """Multiply-adds of one image's convs whose names start with
    ``prefix``."""
    return sum(layer_ops(s) // 2 for s in shapes
               if s["op"] == "conv" and s["name"].startswith(prefix))


def predict_ops(shapes: list[dict], batch: int, samples: int) -> int:
    """Operations of one spatial predictive of ``batch`` images at S
    samples: the backbone once, each head S times."""
    once = sum(layer_ops(s) for s in shapes if s["op"] != "head")
    heads = sum(layer_ops(s) for s in shapes if s["op"] == "head")
    return batch * (once + samples * heads)


def train_ops(shapes: list[dict], batch: int) -> int:
    """Operations of one training step: three times one forward."""
    return 3 * batch * sum(layer_ops(s) for s in shapes)


def head_bound_s(head: dict, batch: int, samples: int, compute: str
                 ) -> float:
    """The least time of one samples launch of an MC head: x (batch, K)
    and w (K, N) in the compute type and an f32 bias read once, the f32
    (S, batch, N) output written once, against 2·S·batch·K·N operations
    at the type's peak."""
    k, n = head["k"], head["n"]
    elt = ELT_BYTES[compute]
    nbytes = batch * k * elt + k * n * elt + 4 * n + 4 * samples * batch * n
    ops = 2 * samples * batch * k * n
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[compute])
