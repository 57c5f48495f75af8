"""The port's Masksembles bank and bank-matmul functions (rows 6–9 of the
kernel table) against the JAX package's, on the CPU.

- ``bayestpu_torch.kernels.mask_bank`` is a copy of
  ``bayestpu/kernels/mask_bank.py``: the same ``(c, n, scale, seed)`` gives
  the same solved scale and an equal bank, and the same bad inputs raise
  the same errors.
- ``bank_matmul``, ``bank_matmul_samples``, their int8 twins and the
  ``*_inference`` dispatch (the port's plain versions, because the tensors
  lie on the CPU) against the JAX kernels in the Pallas interpreter
  (``interpret=True``, as ``tests/test_pallas_kernels.py`` runs them): the
  float rows to rtol 1e-5 of max|ref| (f32 sums in another order; the
  products are exact), the int8 rows bit for bit (exact int32 sums, then
  one f32 multiply by the same constant).

``chip_smoke.py`` holds the CUDA kernels against the same plain versions
on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bayestpu.kernels import mask_bank as jbank
from bayestpu.kernels import masked_matmul as jmm
from bayestpu_torch.kernels import mask_bank as tbank
from bayestpu_torch.kernels import masked_matmul as tmm

from port_threads import thread_budget  # noqa: F401

I = dict(interpret=True)
# M, K, N: the vgg11_me head, and a ragged one (no multiple of any block)
SHAPES = [(128, 512, 10), (37, 150, 13)]
# negative and wrapping indices: JAX takes idx % num_masks, floor semantics
IDXS = np.array([0, 1, 2, 3, -1, 5, -6, 7], np.int32)
STEPS = (2.0 ** -7, 2.0 ** -5)
FLOAT_RTOL = 1e-5


def _bank(k, seed=0, non_binary=False):
    _, bank = jbank.generation_wrapper(k, 4, 2.0, rng=seed)
    bank = bank.copy()
    if non_binary:          # the float kernels multiply by the value
        bank[0, ::3] *= 2.0
        bank[2, 1::5] *= 0.5
    return bank


def _float_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _int8_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, size=(m, k)).astype(np.int8),
            rng.integers(-128, 128, size=(k, n)).astype(np.int8))


def _close(got, want):
    """Float rows: max |got - want| within FLOAT_RTOL of max |want|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FLOAT_RTOL * np.abs(want).max()


# ------------------------------------------------------------- the bank


@pytest.mark.parametrize("c,n,scale,seed", [
    (512, 4, 2.0, 0),           # the vgg11_me head
    (700, 4, 2.0, 0),           # ragged
    (64, 4, 2.0, 1),
    (100, 3, 1.5, 7),
    (256, 8, 3.0, 2),
])
def test_mask_bank_copy_equals_original(c, n, scale, seed):
    js, jb = jbank.generation_wrapper(c, n, scale, rng=seed)
    ts, tb = tbank.generation_wrapper(c, n, scale, rng=seed)
    assert ts == js
    np.testing.assert_array_equal(tb, jb)
    assert tb.dtype == np.float32 and tb.shape == (n, c)
    assert tbank.bank_stats(tb) == jbank.bank_stats(jb)
    # a Generator threads through as the seed does
    _, tg = tbank.generation_wrapper(c, n, scale,
                                     rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(tg, jb)


def test_mask_bank_helpers_equal_original():
    for m, n, s in ((128, 4, 2.0), (37, 3, 1.7), (300, 8, 4.5)):
        assert tbank._expected_width(m, n, s) == jbank._expected_width(m, n, s)
        assert tbank._solve_scale(m, n, 2 * m, 2.0) == jbank._solve_scale(
            m, n, 2 * m, 2.0)
        np.testing.assert_array_equal(tbank.generate_masks(m, n, s, rng=3),
                                      jbank.generate_masks(m, n, s, rng=3))


@pytest.mark.parametrize("c,n,scale", [
    (9, 4, 2.0),                # fewer than 10 channels
    (64, 4, 0.5), (64, 4, 7.0),  # scale outside [1, 6]
    (10, 2, 1.0),               # no scale solves the width equation
])
def test_mask_bank_copy_raises_like_original(c, n, scale):
    with pytest.raises(Exception) as want:
        jbank.generation_wrapper(c, n, scale)
    with pytest.raises(type(want.value)) as got:
        tbank.generation_wrapper(c, n, scale)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------- rows 8 and 9: f32


@pytest.mark.parametrize("non_binary", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bank_matmul_samples_equals_jax(m, k, n, bf16, non_binary):
    """Row 8 and its inference dispatch: every index of IDXS in one call,
    x in f32 or bf16 (promoted to f32), a {0, 1} bank or one with other
    values."""
    x, w = _float_inputs(m, k, n, seed=m)
    bank = _bank(k, non_binary=non_binary)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(jmm.bank_matmul_samples(
        jx, jnp.asarray(w), jnp.asarray(bank), jnp.asarray(IDXS), **I))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)
    tw, tb, ti = (torch.from_numpy(a) for a in (w, bank, IDXS))
    got = tmm.bank_matmul_samples(tx, tw, tb, ti)
    assert got.dtype == torch.float32
    _close(got, want)
    assert torch.equal(tmm.bank_matmul_inference(tx, tw, tb, ti), got)
    assert torch.equal(tmm.bank_matmul_inference(tx, tw, tb, ti.long()), got)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bank_matmul_equals_jax(m, k, n, bf16):
    """Row 9 at an int index (negative and wrapping ones included), and
    sample s of row 8 bit-equal to it at IDXS[s]."""
    x, w = _float_inputs(m, k, n, seed=k)
    bank = _bank(k, seed=1, non_binary=True)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(bank)
    samples = tmm.bank_matmul_samples(tx, tw, tb, torch.from_numpy(IDXS))
    for i in (0, -1, 5):
        want = np.asarray(jmm.bank_matmul(jx, jnp.asarray(w),
                                          jnp.asarray(bank), int(i), **I))
        got = tmm.bank_matmul(tx, tw, tb, int(i))
        assert got.shape == (m, n)
        _close(got, want)
        assert torch.equal(tmm.bank_matmul_inference(tx, tw, tb, int(i)),
                           got)
        assert torch.equal(tmm.bank_matmul(tx, tw, tb, torch.tensor(i)), got)
    for s, i in enumerate(IDXS):
        assert torch.equal(samples[s], tmm.bank_matmul(tx, tw, tb, int(i)))


def test_bank_matmul_is_x_times_row_at_f32():
    """ones @ eye(K) reads the row back exactly, bf16 x included; an index
    wraps modulo num_masks as Python's % (floor) does."""
    k = 40
    bank = _bank(k, non_binary=True)
    eye = torch.eye(k)
    for dtype in (torch.float32, torch.bfloat16):
        ones = torch.ones(3, k, dtype=dtype)
        got = tmm.bank_matmul_samples(ones, eye, torch.from_numpy(bank),
                                      torch.tensor([2, -3, 9]))
        for s, i in enumerate((2, -3, 9)):
            np.testing.assert_array_equal(got[s].numpy(),
                                          np.tile(bank[i % 4], (3, 1)))


def test_bank_rows_are_taken_directly():
    """The port takes bank row idx directly in both float functions, as
    JAX's single kernel does (``bank_ref[pl.ds(idx, 1), :]``). JAX's
    samples kernel selects it as a max over a where (``:876-877``), which
    equals the row for a non-negative bank (every bank ``generation_wrapper``
    makes) and clips a negative entry to 0: a known difference that no
    bank of the port's models can show."""
    m, k, n = 16, 40, 6
    x, w = _float_inputs(m, k, n, seed=3)
    bank = _bank(k)
    bank[1, :5] = -1.0
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, bank))
    got = tmm.bank_matmul_samples(tx, tw, tb, torch.tensor([1]))[0]
    single = np.asarray(jmm.bank_matmul(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(bank), 1, **I))
    samples = np.asarray(jmm.bank_matmul_samples(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bank),
        jnp.asarray([1], jnp.int32), **I))[0]
    _close(got, single)
    assert not np.allclose(samples, single, rtol=1e-3)
    clipped = bank.copy()
    clipped[1, :5] = 0.0
    _close(tmm.bank_matmul(tx, tw, torch.from_numpy(clipped), 1), samples)


# ---------------------------------------------------- rows 6 and 7: int8


@pytest.mark.parametrize("non_binary", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bank_matmul_int8_samples_equals_jax(m, k, n, non_binary):
    """Row 6 and its inference dispatch, bit for bit; the bank binarized at
    0.5 (a 2.0 entry keeps, a 0.5 one drops, as ``bank > 0.5``)."""
    xq, wq = _int8_inputs(m, k, n, seed=m + 1)
    bank = _bank(k, seed=2, non_binary=non_binary)
    want = np.asarray(jmm.bank_matmul_int8_samples(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bank),
        jnp.asarray(IDXS), *STEPS, **I))
    txq, twq, tb, ti = (torch.from_numpy(a) for a in (xq, wq, bank, IDXS))
    got = tmm.bank_matmul_int8_samples(txq, twq, tb, ti, *STEPS)
    assert got.dtype == torch.float32 and got.shape == (len(IDXS), m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tmm.bank_matmul_int8_inference(txq, twq, tb, ti,
                                                      *STEPS), got)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bank_matmul_int8_equals_jax(m, k, n):
    """Row 7 at int indices, bit for bit, and sample s of row 6 bit-equal
    to it at IDXS[s]."""
    xq, wq = _int8_inputs(m, k, n, seed=k + 1)
    bank = _bank(k, seed=3, non_binary=True)
    txq, twq, tb = (torch.from_numpy(a) for a in (xq, wq, bank))
    for i in (1, -1, 6):
        want = np.asarray(jmm.bank_matmul_int8(
            jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bank), i, *STEPS,
            **I))
        got = tmm.bank_matmul_int8(txq, twq, tb, i, *STEPS)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(tmm.bank_matmul_int8_inference(
            txq, twq, tb, i, *STEPS), got)
    samples = tmm.bank_matmul_int8_samples(txq, twq, tb,
                                           torch.from_numpy(IDXS), *STEPS)
    for s, i in enumerate(IDXS):
        assert torch.equal(samples[s], tmm.bank_matmul_int8(
            txq, twq, tb, int(i), *STEPS))


def test_bank_int8_out_scale_is_the_f32_of_the_double():
    """x_step·w_step in double, rounded once to f32, with no dropout
    rescale; the readout of ones @ eye is exactly that or 0, where the
    row's binarized bank keeps or drops."""
    xs, ws = 0.1, 0.3
    assert tmm.bank_out_scale(xs, ws) == float(np.float32(xs * ws))
    assert tmm.bank_out_scale(xs, ws) != xs * ws
    k = 24
    bank = _bank(k, non_binary=True)
    got = tmm.bank_matmul_int8(torch.ones(2, k, dtype=torch.int8),
                               torch.eye(k, dtype=torch.int8),
                               torch.from_numpy(bank), 2, xs, ws)
    want = np.where(bank[2] > 0.5, np.float32(xs * ws), 0).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), np.tile(want, (2, 1)))


# ------------------------------------------------------------- routing


def test_bank_cpu_calls_launch_nothing():
    tmm.reset_launch_counts()
    bank = torch.from_numpy(_bank(16))
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    xq = torch.ones(8, 16, dtype=torch.int8)
    wq = torch.ones(16, 4, dtype=torch.int8)
    idxs = torch.tensor([0, 3])
    tmm.bank_matmul_inference(x, w, bank, idxs)
    tmm.bank_matmul_inference(x.bfloat16(), w, bank, 1)
    tmm.bank_matmul_int8_inference(xq, wq, bank, idxs, 1.0, 1.0)
    tmm.bank_matmul_int8_inference(xq, wq, bank, 2, 1.0, 1.0)
    assert set(tmm.launch_counts.values()) == {0}
    assert {"bank_matmul", "bank_matmul_samples", "bank_matmul_int8",
            "bank_matmul_int8_samples"} <= set(tmm.launch_counts)


def test_bank_wrappers_refuse_other_devices():
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="device"):
        tmm.bank_matmul(meta(4, 16), meta(16, 3), meta(4, 16), 0)
    with pytest.raises(ValueError, match="device"):
        tmm.bank_matmul_int8_samples(
            meta(4, 16, dtype=torch.int8), meta(16, 3, dtype=torch.int8),
            meta(4, 16), torch.tensor([0, 1]), 1.0, 1.0)


def test_bank_wrappers_reject_bad_inputs():
    bank = torch.from_numpy(_bank(16))
    x, w = torch.randn(4, 16), torch.randn(16, 3)
    with pytest.raises(TypeError):              # w must be f32
        tmm.bank_matmul(x, w.bfloat16(), bank, 0)
    with pytest.raises(TypeError):              # the bank must be f32
        tmm.bank_matmul(x, w, bank.double(), 0)
    with pytest.raises(ValueError):             # bank width != K
        tmm.bank_matmul(x, w, bank[:, :8], 0)
    with pytest.raises(ValueError):             # inner dims differ
        tmm.bank_matmul(x, torch.randn(15, 3), bank, 0)
    with pytest.raises(ValueError):             # float indices
        tmm.bank_matmul_samples(x, w, bank, torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError):             # (S,) indices to the single
        tmm.bank_matmul(x, w, bank, torch.tensor([0, 1]))
    with pytest.raises(TypeError):              # float x to the int8 head
        tmm.bank_matmul_int8(x, w, bank, 0, 1.0, 1.0)
