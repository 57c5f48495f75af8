"""Build and load the port's CUDA kernels.

Each ``bayestpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface,
``build/bayestpu_torch/lib<name>-<hash>.so`` under the repository root, and
loaded with ``ctypes``. The hash covers the source, every header in
``csrc/`` and the compiler flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. Sources build at first use; ``build_all``
starts one ``nvcc`` per source, all at once. A failed build or load raises.

Nothing here runs at import: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bayestpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, \
    ctypes.c_float
# affine, out, dims (int array), fscale, out_kind, relu, inv_step, x_bf16,
# w_bf16, stream
_CONV_TAIL = [_P, _P, ctypes.POINTER(ctypes.c_int), _F, _I, _I, _F, _I, _I,
              _P]
# argtypes of every exported C function, by source name
_SIGNATURES: dict[str, dict[str, list]] = {
    "masked_matmul": {
        # x, w, seeds, out, M, K, N, thresh, scale, is_bf16, row0, stream
        "bt_dropout_matmul": [_P, _P, _P, _P, _I, _I, _I, _U32, _F, _I, _U32,
                              _P],
        # x, w, seeds, out, M, K, N, S, x_stride (0: x shared), thresh,
        # scale, is_bf16, row0, stream
        "bt_dropout_matmul_samples": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _U32, _F, _I, _U32, _P],
        # x, seeds, out, M, K, thresh, scale, is_bf16, row0, stream
        "bt_dropout_apply": [_P, _P, _P, _I, _I, _U32, _F, _I, _U32, _P],
        # x_q, w_q, seeds, out, M, K, N, thresh, out_scale, row0, stream
        "bt_dropout_matmul_int8": [_P, _P, _P, _P, _I, _I, _I, _U32, _F,
                                   _U32, _P],
        # x_q, w_q, seeds, out, M, K, N, S, x_stride (0: x shared), thresh,
        # out_scale, row0, stream
        "bt_dropout_matmul_int8_samples": [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _U32, _F, _U32, _P],
        # x, w, bank, out, M, K, N, idx, num_masks, is_bf16, stream
        "bt_bank_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, w, bank, idxs, out, M, K, N, S, x_stride (0: x shared),
        # num_masks, is_bf16, stream
        "bt_bank_matmul_samples": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _P],
        # x_q, w_q, bank, out, M, K, N, idx, num_masks, out_scale, stream
        "bt_bank_matmul_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        # x_q, w_q, bank, idxs, out, M, K, N, S, x_stride (0: x shared),
        # num_masks, out_scale, stream
        "bt_bank_matmul_int8_samples": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _F, _P],
    },
    # every masked_conv entry ends in the same arguments (masked_conv.cu)
    "masked_conv": {name: head + _CONV_TAIL for name, head in {
        # x, w, seeds (or null), thresh; one sample or S, from dims; the
        # _xs entries take x (S, N, H, W, C), sample s under seeds[s]
        "bt_masked_conv": [_P, _P, _P, _U32],
        "bt_masked_conv_xs": [_P, _P, _P, _U32],
        "bt_masked_conv_int8": [_P, _P, _P, _U32],
        "bt_masked_conv_int8_xs": [_P, _P, _P, _U32],
        # x, w, bank, idx, num_masks
        "bt_bank_conv": [_P, _P, _P, _I, _I],
        "bt_bank_conv_int8": [_P, _P, _P, _I, _I],
        # x, w, bank, idxs, num_masks; the _xs entries take x (S, N, H, W,
        # C), sample s under idxs[s]
        "bt_bank_conv_samples": [_P, _P, _P, _P, _I],
        "bt_bank_conv_xs": [_P, _P, _P, _P, _I],
        "bt_bank_conv_int8_samples": [_P, _P, _P, _P, _I],
        "bt_bank_conv_int8_xs": [_P, _P, _P, _P, _I],
    }.items()},
}

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "bayestpu_torch build only where the CUDA toolkit "
                           "is installed")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [_CSRC / f"{name}.cu"] + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict:
    """Compile every source (or ``names``) whose library is missing, one
    ``nvcc`` process each, started together. Returns the seconds taken and
    the compiler's resource report (``-Xptxas -v``) per source."""
    names = sources() if names is None else names
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    report: dict[str, str] = {}
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            report[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(todo),
            "ptxas": report}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    every exported function's argtypes and restype declared."""
    if name in _loaded:
        return _loaded[name]
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
