"""elementwise_ms.predict: device ms a traced request in kernels that are
neither the program's own nor cuBLAS/cuDNN GEMM or conv kernels
(``perfbench.work.kernel_group``): elementwise, reduction, copy and
im2col kernels of PyTorch, the int8 path's quantization among them."""


def read(run):
    r = run.record
    if r.kind != "predict" or r.trace is None:
        return None
    secs, _ = r.trace.kernel_time(
        lambda n: run.work.kernel_group(n) == "elementwise")
    return secs / r.trace.units * 1e3
