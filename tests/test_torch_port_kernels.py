"""The port's fused dropout-matmul functions against the JAX package's Pallas
kernels, on the CPU.

The JAX side runs its kernels in the Pallas interpreter (``interpret=True``,
as ``tests/test_pallas_kernels.py`` does); the port's wrappers take their
plain PyTorch versions because the tensors lie on the CPU. Inputs are made
with numpy from a seed and handed to both. The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bayestpu.kernels import masked_matmul as jmm
from bayestpu_torch.kernels import _build
from bayestpu_torch.kernels import masked_matmul as tmm

from port_threads import thread_budget  # noqa: F401

I = dict(interpret=True)
RAGGED = [(37, 45, 19), (130, 200, 9)]    # M, K, N: not multiples of blocks


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _seeds(num, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.integers(-2 ** 31, 2 ** 31, size=(num, 2), dtype=np.int64)
    s[0] = (-5, -2 ** 31)                      # negative seeds, int32 min
    return s.astype(np.int32)


def _jax(a, bf16):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _torch(a, bf16):
    return torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)


# ----------------------------------------------------------------- bits


def test_coord_bits_and_seed_stream_equal_jax():
    """Exact uint32 equality on random coordinates, including coordinates
    near 2^32 and negative seeds."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
    cols = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
    rows[:4] = [0, 1, 2 ** 32 - 1, 2 ** 32 - 2]
    cols[:4] = [2 ** 32 - 1, 0, 2 ** 32 - 1, 7]
    for s0, s1 in _seeds(6).tolist() + [[0, 0], [2 ** 31 - 1, -1]]:
        js = jmm._seed_stream(jnp.asarray(s0, jnp.int32),
                              jnp.asarray(s1, jnp.int32))
        ts = tmm.seed_stream(torch.tensor(s0, dtype=torch.int32),
                             torch.tensor(s1, dtype=torch.int32))
        assert int(ts) == int(js)
        jb = np.asarray(jmm._coord_bits(jnp.asarray(rows, jnp.uint32),
                                        jnp.asarray(cols, jnp.uint32), js))
        tb = tmm.coord_bits(torch.from_numpy(rows.astype(np.int64)),
                            torch.from_numpy(cols.astype(np.int64)), ts)
        np.testing.assert_array_equal(tb.numpy(), jb.astype(np.int64))


def test_mix_equals_jax():
    vals = np.random.default_rng(3).integers(0, 2 ** 32, size=1000,
                                             dtype=np.uint64)
    jm = np.asarray(jmm._mix(jnp.asarray(vals, jnp.uint32)))
    tm = tmm.mix(torch.from_numpy(vals.astype(np.int64)))
    np.testing.assert_array_equal(tm.numpy(), jm.astype(np.int64))


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 0.9])
def test_keep_threshold_exact(rate):
    assert tmm.keep_threshold(rate) == jmm._keep_threshold(rate)


@pytest.mark.parametrize("rate,want", [(0.25, 1.3359375), (0.5, 2.0)])
def test_bf16_scale_is_rounded_first(rate, want):
    """JAX turns the Python scale into a bf16 constant before multiplying."""
    assert tmm.scale_of(rate, torch.bfloat16) == want
    assert tmm.scale_of(rate, torch.float32) == float(
        np.float32(1.0 / (1.0 - rate)))


# ------------------------------------------------------ kernel functions


@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_matmul_matches_jax(m, k, n, bf16):
    """f32: rtol 1e-5 (accumulation order differs). bf16: the masked,
    scaled x is rounded to bf16 on both sides and products are exact in f32,
    so the same rtol holds; atol 1e-5 covers sums near zero."""
    x, w = _inputs(m, k, n)
    seeds = _seeds(1)[0]
    want = np.asarray(jmm.dropout_matmul(_jax(x, bf16), _jax(w, bf16),
                                         jnp.asarray(seeds), 0.25, **I))
    got = tmm.dropout_matmul(_torch(x, bf16), _torch(w, bf16),
                             torch.from_numpy(seeds), 0.25)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_matmul_samples_matches_jax(m, k, n, bf16):
    x, w = _inputs(m, k, n, seed=2)
    seeds = _seeds(3)
    want = np.asarray(jmm.dropout_matmul_samples(
        _jax(x, bf16), _jax(w, bf16), jnp.asarray(seeds), 0.25, **I))
    got = tmm.dropout_matmul_samples(_torch(x, bf16), _torch(w, bf16),
                                     torch.from_numpy(seeds), 0.25)
    assert got.shape == (3, m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_mask_readout_exact(bf16):
    """x = ones, w = eye(K): every output is 0 or the dtype's 1/keep, and
    the port equals JAX bit for bit, single and all samples."""
    m, k = 40, 150
    x = np.ones((m, k), np.float32)
    w = np.eye(k, dtype=np.float32)
    seeds = _seeds(3, seed=5)
    want = np.asarray(jmm.dropout_matmul_samples(
        _jax(x, bf16), _jax(w, bf16), jnp.asarray(seeds), 0.3, **I))
    got = tmm.dropout_matmul_samples(_torch(x, bf16), _torch(w, bf16),
                                     torch.from_numpy(seeds), 0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    scale = tmm.scale_of(0.3, torch.bfloat16 if bf16 else torch.float32)
    assert set(np.unique(want).tolist()) == {0.0, scale}
    want1 = np.asarray(jmm.dropout_matmul(_jax(x, bf16), _jax(w, bf16),
                                          jnp.asarray(seeds[1]), 0.3, **I))
    got1 = tmm.dropout_matmul(_torch(x, bf16), _torch(w, bf16),
                              torch.from_numpy(seeds[1]), 0.3)
    np.testing.assert_array_equal(got1.numpy(), want1)


@pytest.mark.parametrize("bf16", [False, True])
def test_sample_s_equals_single_bitwise(bf16):
    x, w = _inputs(33, 70, 12, seed=4)
    seeds = torch.from_numpy(_seeds(4, seed=9))
    xs, ws = _torch(x, bf16), _torch(w, bf16)
    all_s = tmm.dropout_matmul_samples(xs, ws, seeds, 0.25)
    for s in range(4):
        assert torch.equal(all_s[s], tmm.dropout_matmul(xs, ws, seeds[s],
                                                        0.25))


def test_inference_dispatches_on_seed_shape():
    x, w = _inputs(9, 16, 5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    seeds = torch.from_numpy(_seeds(2))
    one = tmm.dropout_matmul_inference(xt, wt, seeds[1], 0.25)
    both = tmm.dropout_matmul_inference(xt, wt, seeds, 0.25)
    assert one.shape == (9, 5) and both.shape == (2, 9, 5)
    assert torch.equal(both[1], one)


def test_rate_zero_is_plain_matmul():
    x, w = _inputs(21, 34, 6)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    seeds = torch.from_numpy(_seeds(3))
    y = tmm.dropout_matmul(xt, wt, seeds[0], 0.0)
    ys = tmm.dropout_matmul_samples(xt, wt, seeds, 0.0)
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-5, atol=1e-6)
    assert ys.shape == (3, 21, 6)
    for s in range(3):
        assert torch.equal(ys[s], y)
    jy = np.asarray(jmm.dropout_matmul_samples(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(seeds.numpy()), 0.0, **I))
    np.testing.assert_allclose(ys.numpy(), jy, rtol=1e-5, atol=1e-6)


def test_cpu_calls_launch_nothing():
    tmm.reset_launch_counts()
    x, w = _inputs(8, 8, 8)
    tmm.dropout_matmul_samples(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(_seeds(2)), 0.5)
    tmm.dropout_apply(torch.from_numpy(x), torch.from_numpy(_seeds(1)[0]),
                      0.5)
    xq = torch.ones(8, 8, dtype=torch.int8)
    tmm.dropout_matmul_int8_inference(xq, xq, torch.from_numpy(_seeds(2)),
                                      0.5, 1.0, 1.0)
    tmm.dropout_matmul_int8_inference(xq, xq, torch.from_numpy(_seeds(1)[0]),
                                      0.5, 1.0, 1.0)
    assert tmm.launch_counts == {"dropout_matmul": 0,
                                 "dropout_matmul_samples": 0,
                                 "dropout_matmul_xs": 0,
                                 "dropout_apply": 0,
                                 "dropout_matmul_int8": 0,
                                 "dropout_matmul_int8_samples": 0,
                                 "dropout_matmul_int8_xs": 0,
                                 "bank_matmul": 0,
                                 "bank_matmul_samples": 0,
                                 "bank_matmul_xs": 0,
                                 "bank_matmul_int8": 0,
                                 "bank_matmul_int8_samples": 0,
                                 "bank_matmul_int8_xs": 0}


# ---------------------------------------------------------------- guards


def test_wrapper_rejects_bad_inputs():
    x, w = torch.randn(4, 6), torch.randn(6, 3)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):            # inner dims differ
        tmm.dropout_matmul(x, torch.randn(5, 3), seeds, 0.25)
    with pytest.raises(TypeError):             # mixed dtypes
        tmm.dropout_matmul(x, w.bfloat16(), seeds, 0.25)
    with pytest.raises(ValueError):            # int64 seeds
        tmm.dropout_matmul(x, w, seeds.long(), 0.25)
    with pytest.raises(ValueError):            # (S, 2) seeds to the single
        tmm.dropout_matmul(x, w, seeds[None], 0.25)
    with pytest.raises(ValueError):            # rate out of range
        tmm.dropout_matmul(x, w, seeds, 1.0)


def test_wrapper_refuses_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken; there
    is no fallback for any other device."""
    x = torch.empty(4, 6, device="meta")
    w = torch.empty(6, 3, device="meta")
    seeds = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tmm.dropout_matmul(x, w, seeds, 0.25)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No silent fallback when the toolkit is missing: building raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["masked_matmul"])


def test_build_hash_tracks_sources():
    """The library name carries a hash of the source, headers and flags."""
    path = _build._lib_path("masked_matmul")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libmasked_matmul-")
    assert _build.sources() == ["epilogue", "masked_conv", "masked_matmul"]
    assert _build._lib_path("masked_conv").name.startswith("libmasked_conv-")
    assert _build._lib_path("epilogue").name.startswith("libepilogue-")


# ------------------------------------------------- row0: one rank's rows

# rows [R0, R0 + ROWS) of an M_ALL-row readout; K odd, so a piece is ragged
M_ALL, K_RO, R0, ROWS = 40, 37, 13, 19


def _readout(kind, x, w, seeds, row0=None):
    """The masked readout of row ``kind`` (1-5), the JAX kernel in the
    interpreter (``row0`` None) or the port at ``row0``; (M, K) or (S, M,
    K)."""
    if row0 is None:
        if kind == 1:
            return np.asarray(jmm._dropout_apply(x, jnp.asarray(seeds[0]),
                                                 0.3, 128, 128, **I))
        if kind == 2:
            return np.asarray(jmm.dropout_matmul(x, w, jnp.asarray(seeds[0]),
                                                 0.3, **I))
        if kind == 3:
            return np.asarray(jmm.dropout_matmul_samples(
                x, w, jnp.asarray(seeds), 0.3, **I))
        if kind == 4:
            return np.asarray(jmm.dropout_matmul_int8(
                x, w, jnp.asarray(seeds[0]), 0.3, 0.5, 0.25, **I))
        return np.asarray(jmm.dropout_matmul_int8_samples(
            x, w, jnp.asarray(seeds), 0.3, 0.5, 0.25, **I))
    sd = torch.from_numpy(seeds)
    if kind == 1:
        return tmm.dropout_apply(x, sd[0], 0.3, row0).numpy()
    if kind == 2:
        return tmm.dropout_matmul(x, w, sd[0], 0.3, row0).numpy()
    if kind == 3:
        return tmm.dropout_matmul_samples(x, w, sd, 0.3, row0).numpy()
    if kind == 4:
        return tmm.dropout_matmul_int8(x, w, sd[0], 0.3, 0.5, 0.25,
                                       row0).numpy()
    return tmm.dropout_matmul_int8_samples(x, w, sd, 0.3, 0.5, 0.25,
                                           row0).numpy()


@pytest.mark.parametrize("kind,bf16", [(1, False), (1, True), (2, False),
                                       (2, True), (3, False), (3, True),
                                       (4, False), (5, False)])
def test_row0_rows_equal_the_whole_launch(kind, bf16):
    """Rows 1-5 at ``row0 = r`` on rows [r, r + m) of a readout (x of ones,
    w = eye(K)) equal those rows of the JAX kernel's launch on the whole
    tensor, bit for bit: the mask is keyed on the global row. Row 3 (and
    its ``_xs`` launch) and row 5 per sample; rows 4-5 in int8."""
    int8 = kind >= 4
    seeds = _seeds(3, seed=11)
    if int8:
        xa = np.ones((M_ALL, K_RO), np.int8)
        wa = np.eye(K_RO, dtype=np.int8)
        jx, jw = jnp.asarray(xa), jnp.asarray(wa)
        tx, tw = torch.from_numpy(xa), torch.from_numpy(wa)
    else:
        xa = np.ones((M_ALL, K_RO), np.float32)
        wa = np.eye(K_RO, dtype=np.float32)
        jx, jw = _jax(xa, bf16), _jax(wa, bf16)
        tx, tw = _torch(xa, bf16), _torch(wa, bf16)
    want = _readout(kind, jx, jw, seeds)[..., R0:R0 + ROWS, :]
    got = _readout(kind, tx[R0:R0 + ROWS].contiguous(), tw, seeds, R0)
    np.testing.assert_array_equal(got, want)
    assert 0 < np.count_nonzero(want) < want.size
    if kind == 3:                                   # 3x: x carries S
        x3 = tx[R0:R0 + ROWS].expand(3, ROWS, K_RO).contiguous()
        got3 = tmm.dropout_matmul_inference(x3, tw, torch.from_numpy(seeds),
                                            0.3, R0).numpy()
        np.testing.assert_array_equal(got3, want)


def test_row0_wraps_as_uint32():
    """``row0`` is uint32 arithmetic, wrapping as JAX's row counters do:
    rows past 2^32 hash as their residue, and row0 + 2^32 is row0."""
    seeds = torch.from_numpy(_seeds(1, seed=13)[0])
    r0 = 2 ** 32 - 3
    got = tmm.keep_mask(seeds, 6, 9, 0.3, r0)
    rows = jnp.asarray((np.arange(6, dtype=np.uint64) + r0) % 2 ** 32,
                       jnp.uint32)[:, None]
    bits = jmm._coord_bits(rows, jnp.arange(9, dtype=jnp.uint32)[None, :],
                           jmm._seed_stream(jnp.int32(int(seeds[0])),
                                            jnp.int32(int(seeds[1]))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(bits) < jmm._keep_threshold(0.3))
    assert torch.equal(tmm.keep_mask(seeds, 6, 9, 0.3, 5 + 2 ** 32),
                       tmm.keep_mask(seeds, 6, 9, 0.3, 5))
