"""Masksembles fixed-mask bank generation (host side, numpy): a copy of
``bayestpu/kernels/mask_bank.py:30-129``.

A bank holds ``n`` binary masks over ``c`` channels. Each mask has ``m``
ones drawn without replacement from ``round(m*s)`` positions, all-zero
columns are dropped, and draws repeat until the bank is exactly as wide as
the closed-form expectation ``round(m*s*(1-(1-1/s)^n))``. To hit ``c``
channels the scale is re-solved from ``m*s*(1-(1-1/s)^n) = c`` by a
bracketed Brent root-find. A ``numpy.random.Generator`` seed is threaded
through, so one ``(seed, c, n, scale)`` always gives the same bank — the
same bank as the JAX package's, which ``tests/test_torch_port_masksembles.py``
pins. The copy exists because the port never imports ``bayestpu`` (its
``__init__`` imports JAX).
"""

from __future__ import annotations

import numpy as np


def _expected_width(m: int, n: int, s: float) -> int:
    return round(m * s * (1 - (1 - 1 / s) ** n))


def _draw_bank(m: int, n: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """One stochastic draw: n masks with m ones over round(m*s) positions,
    all-zero columns dropped."""
    total = round(m * s)
    bank = np.zeros((n, total), dtype=np.float32)
    for i in range(n):
        idx = rng.choice(total, size=m, replace=False)
        bank[i, idx] = 1.0
    used = ~np.all(bank == 0.0, axis=0)
    return bank[:, used]


def generate_masks(m: int, n: int, s: float,
                   rng: np.random.Generator | int | None = 0,
                   max_tries: int = 10_000) -> np.ndarray:
    """Draw until the bank width equals the closed-form expected width."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    want = _expected_width(m, n, s)
    for _ in range(max_tries):
        bank = _draw_bank(m, n, s, rng)
        if bank.shape[1] == want:
            return bank
    raise RuntimeError(
        f"mask bank generation did not converge (m={m}, n={n}, s={s})")


def _solve_scale(m: int, n: int, c: int, near: float) -> float:
    """Solve ``m*s*(1-(1-1/s)^n) = c`` for s, picking the root nearest
    ``near``."""
    from scipy.optimize import brentq

    def f(s: float) -> float:
        return m * s * (1 - (1 - 1 / s) ** n) - c

    # The LHS is monotone increasing in s on (1, inf) for fixed m, n; bracket
    # outward from s=1 until a sign change.
    lo, hi = 1.0 + 1e-9, max(near, 1.5)
    flo = f(lo)
    if abs(flo) < 1e-12:
        return lo
    while f(hi) * flo > 0:
        hi *= 2.0
        if hi > 1e6:
            raise ValueError(f"no scale solves m*s*(1-(1-1/s)^n)={c} "
                             f"(m={m}, n={n})")
    return float(brentq(f, lo, hi, xtol=1e-12, rtol=1e-14))


def generation_wrapper(c: int, n: int, scale: float,
                       rng: np.random.Generator | int | None = 0,
                       ) -> tuple[float, np.ndarray]:
    """Generate an ``(n, c)`` bank for a layer with exactly ``c`` channels.

    Returns ``(solved_scale, bank)``. Validation: c >= 10, scale in [1, 6],
    and ``active_features * n >= c``.
    """
    if c < 10:
        raise ValueError(
            f"Masksembles requires at least 10 channels, got {c}")
    if scale > 6.0 or scale < 1.0:
        raise ValueError(f"Masksembles scale must be in [1, 6], got {scale}")

    active = round(c / (scale * (1 - (1 - 1 / scale) ** n)))
    if active * n < c:
        raise ValueError("scale too large for this channel count")

    solved = _solve_scale(active, n, c, near=scale)
    if _expected_width(active, n, solved) != c:
        raise ValueError(
            f"failed to generate masks with exactly {c} features; "
            "try a different scale")
    bank = generate_masks(active, n, solved, rng=rng)
    assert bank.shape == (n, c), bank.shape
    return solved, bank


def bank_stats(bank: np.ndarray) -> dict:
    """Overlap and coverage statistics of a bank."""
    n, c = bank.shape
    ones = bank.sum(axis=1)
    pair_overlap = []
    for i in range(n):
        for j in range(i + 1, n):
            pair_overlap.append(float((bank[i] * bank[j]).sum()))
    return {
        "num_masks": n,
        "channels": c,
        "ones_per_mask": ones.tolist(),
        "coverage": float((bank.sum(axis=0) > 0).mean()),
        "mean_pair_overlap": float(np.mean(pair_overlap)) if pair_overlap else 0.0,
    }
