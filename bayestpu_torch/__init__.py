"""bayestpu_torch — the PyTorch/CUDA port of ``bayestpu`` for NVIDIA Hopper.

It trains and serves the same multi-exit MC-dropout Bayesian networks as
the JAX package, with the fused dropout-matmul kernels and the backward's
mask kernel written by hand in CUDA C++ for ``sm_90a``
(``bayestpu_torch/csrc``). The port imports torch and numpy only; it never
imports JAX or any module of ``bayestpu``.

Importing the package has no side effects beyond importing torch: kernels
are compiled at their first launch (``bayestpu_torch.kernels._build``).
"""

from __future__ import annotations

import torch  # noqa: F401

__all__ = ["core", "data", "engine", "interop", "kernels", "metrics", "nn",
           "train"]
