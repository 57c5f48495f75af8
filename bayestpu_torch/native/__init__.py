"""Native (C++) host-side components, built on demand with g++ (counterpart
of ``bayestpu/native/__init__.py``).

``kde_ece.cc`` (the KDE-ECE finalizer) and ``data_pipeline.cc`` (the fused
batch assembler) are copies of the JAX package's sources, kept byte for
byte. They build into one shared library under the repository root,
``build/bayestpu_torch/libbayestpu_native-<hash>.so``, where the hash
covers both sources, the compiler flags and the host's CPU (``-march=
native`` compiles for it), so a changed source is rebuilt, an unchanged one
is loaded as it is, and a library built for another CPU is never loaded. The build runs at first use, under
an ``fcntl`` lock on a file beside the library, into a temporary name that
``os.replace`` moves into place: processes that start together (test
workers) wait for one build and load its result, never a half-written
file. A failed build or load raises; nothing falls back to numpy. The
numpy twins are ``metrics.kde.ece_kde(native=False)`` and
``data.pipeline.augment_gather_ref``.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "kde_ece.cc", _DIR / "data_pipeline.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bayestpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-fopenmp")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _host_cpu() -> bytes:
    """The machine and the first processor's vendor, model and flags in
    ``/proc/cpuinfo`` (where there is one): what ``-march=native`` reads."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                if line.split(":", 1)[0].strip() in ("vendor_id",
                                                     "model name", "flags"):
                    ident.append(line.strip())
    except OSError:
        pass
    return "\n".join(ident).encode()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbayestpu_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the library into ``out`` unless another process has."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every entry point's
    argtypes and restype declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.bayestpu_kde_ece.restype = ctypes.c_double
        lib.bayestpu_kde_ece.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int]
        lib.bayestpu_augment_gather.restype = None
        lib.bayestpu_augment_gather.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        _lib = lib
        return lib


def augment_gather(src: np.ndarray, idx: np.ndarray, mean: np.ndarray,
                   std: np.ndarray, pad: int, seed: int, train: bool
                   ) -> np.ndarray:
    """Fused gather + pad-crop + flip + normalize of one batch (NHWC f32);
    the contract of ``data.pipeline.augment_gather_ref``, bit for bit, for
    rows ``idx`` in [0, len(src)); the C code reads them unchecked."""
    lib = load()
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    if src.ndim != 4:
        raise ValueError(f"src must be (n, h, w, c); got {src.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(f"batch rows outside [0, {src.shape[0]})")
    b = idx.shape[0]
    _, h, w, c = src.shape
    mean = np.ascontiguousarray(mean, np.float32).reshape(c)
    std = np.ascontiguousarray(std, np.float32).reshape(c)
    out = np.empty((b, h, w, c), np.float32)
    lib.bayestpu_augment_gather(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, h, w, c,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pad, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), int(train))
    return out


def kde_ece(probs: np.ndarray, labels: np.ndarray, order: int = 1
            ) -> float:
    """KDE ECE in C++; the contract of ``metrics.kde.ece_kde``."""
    lib = load()
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = labels.argmax(-1)
    probs = np.clip(probs, 1e-256, 1 - 1e-256)
    pred = probs.argmax(-1)
    conf = np.ascontiguousarray(
        probs[np.arange(len(probs)), pred] / probs.sum(-1))
    correct = np.ascontiguousarray((pred == labels).astype(np.uint8))
    return float(lib.bayestpu_kde_ece(
        conf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        correct.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(conf), order))
