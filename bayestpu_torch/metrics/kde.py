"""KDE-based ECE (Mix-n-Match style), a host-side finalizer (a numpy copy of
``bayestpu/metrics/kde.py``).

The semantics of ``ece_kde_binary`` in
``Software_Artifact/software/train/results_analyzer.py:351-443`` (Zhang et
al.'s "Mix-n-Match" estimator): a triweight-kernel FFT KDE of the
confidences of the correct predictions and of all confidences, with
reflecting boundaries at [0, 1], integrated to
``∫ |conf − accu(conf)| · density(conf) dconf``. The FFT KDE bins the data
linearly onto a 2^14-point grid over [-0.6, 1.6] and convolves it with the
triweight kernel; ``bw`` is the kernel's standard deviation (KDEpy's
convention), so the kernel's half-width is ``3·bw``.

``ece_kde`` runs the C++ implementation (``bayestpu_torch.native``) unless
``native=False``. Unlike the JAX package it never drops to numpy quietly: a
library that does not build or load raises.
"""

from __future__ import annotations

import numpy as np

_GRID_N = 2 ** 14
_GRID_LO, _GRID_HI = -0.6, 1.6


def _mirror_1d(d: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Reflecting boundary conditions (``results_analyzer.py:339-349``)."""
    mid = (lo + hi) / 2
    return np.concatenate([(2 * lo - d[d < mid]).reshape(-1, 1),
                           d.reshape(-1, 1),
                           (2 * hi - d[d >= mid]).reshape(-1, 1)])


def _fft_kde_triweight(data: np.ndarray, bw: float, grid: np.ndarray
                       ) -> np.ndarray:
    """FFT KDE with the triweight kernel, bw = the kernel's std."""
    from scipy.signal import fftconvolve

    data = np.asarray(data, np.float64).reshape(-1)
    n = grid.shape[0]
    dx = grid[1] - grid[0]
    # linear binning of the data onto the grid
    pos = (data - grid[0]) / dx
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 2)
    frac = pos - i0
    hist = np.zeros(n)
    np.add.at(hist, i0, 1.0 - frac)
    np.add.at(hist, i0 + 1, frac)
    # the triweight kernel sampled on the grid; half-width 3·bw
    half = 3.0 * bw
    m = max(int(np.ceil(half / dx)), 1)
    u = (np.arange(-m, m + 1) * dx) / half
    kern = np.where(np.abs(u) <= 1.0, (35.0 / 32.0) * (1 - u ** 2) ** 3, 0.0)
    kern = kern / half
    dens = fftconvolve(hist, kern, mode="same") / data.size
    return np.maximum(dens, 0.0)


def ece_kde(probs: np.ndarray, labels: np.ndarray, order: int = 1,
            native: bool | None = None) -> float:
    """KDE ECE over top-1 confidences.

    probs: (N, C) predictive probabilities (renormalized here); labels:
    (N,) int labels or (N, C) one-hot. native: None or True → the C++
    implementation, raising if it cannot be built or loaded; False →
    numpy.
    """
    if native is not False:
        from bayestpu_torch import native as native_mod
        return native_mod.kde_ece(probs, labels, order)
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = labels.argmax(-1)
    probs = np.clip(probs, 1e-256, 1 - 1e-256)

    pred = probs.argmax(-1)
    conf = probs[np.arange(len(probs)), pred] / probs.sum(-1)
    correct = (pred == labels).astype(np.float64)

    x_int = np.linspace(_GRID_LO, _GRID_HI, num=_GRID_N)
    conf_correct = conf[correct == 1].reshape(-1, 1)
    if conf_correct.size and np.std(conf_correct) != 0:
        kbw = np.std(conf_correct) * (len(conf) * 2) ** -0.2
    else:
        kbw = 1e-16 * (len(conf) * 2) ** -0.2

    pp1 = _fft_kde_triweight(_mirror_1d(conf_correct), kbw, x_int)
    pp2 = _fft_kde_triweight(_mirror_1d(conf.reshape(-1, 1)), kbw, x_int)
    inside = (x_int > 0.0) & (x_int < 1.0)
    pp1 = np.where(inside, pp1, 0.0) * 2
    pp2 = np.where(inside, pp2, 0.0) * 2

    perc = correct.mean()
    integral = np.zeros_like(x_int)
    with np.errstate(divide="ignore", invalid="ignore"):
        accu = np.minimum(perc * pp1 / pp2, 1.0)
    valid = (np.maximum(pp1, pp2) > 1e-6) & ~np.isnan(accu)
    integral[valid] = (np.abs(x_int - accu) ** order * pp2)[valid]
    # forward-fill where both densities vanish (reference :437-439): each
    # index i ≥ 2 takes the value at the latest source index ≤ i, the
    # sources being the valid positions and {0, 1} (the loop starts at 2)
    src = valid.copy()
    src[:2] = True
    last_src = np.maximum.accumulate(np.where(src, np.arange(len(x_int)), 0))
    integral = integral[last_src]

    dom = (x_int >= 0.0) & (x_int <= 1.0)
    # np.trapezoid is numpy >= 2.0; an older numpy fails here, loudly
    denom = np.trapezoid(pp2[dom], x_int[dom])
    if denom <= 0:
        return 0.0
    return float(np.trapezoid(integral[dom], x_int[dom]) / denom)
