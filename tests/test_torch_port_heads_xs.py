"""The port's masked heads on an x that carries the sample axis, against
the JAX package's vmap over (x, seeds) or (x, index), on the CPU.

``dropout_matmul_inference`` and ``dropout_matmul_int8_inference`` with x
(S, M, K) and seeds (S, 2), and ``bank_matmul_inference`` and
``bank_matmul_int8_inference`` with x (S, M, K) and S indices, mask sample
s of x with seeds[s] or index s on its own coordinates: JAX's custom vmap
rules (``masked_matmul.py:407-411``, ``:618-622``, ``:957-960`` and
``:742-747``) send such a call to their ``lax.map`` fallback, one single
kernel per sample. On the card the port makes one launch of the samples
kernel with a per-sample x stride (``dropout_matmul_xs``,
``dropout_matmul_int8_xs``, ``bank_matmul_xs``, ``bank_matmul_int8_xs``);
here, on the CPU, it runs the single plain version per sample, and this
file holds that against JAX with the Pallas kernels in the interpreter
(``interpret=True``), on numpy inputs made from a seed. ``chip_smoke.py``
holds the CUDA launches against the same plain versions on the card, and
each of their samples against the single launch on x[s].

Tolerances: the MC float head to rtol 1e-5, atol 1e-5, as in
``test_torch_port_kernels.py`` (f32 sums in another order; bf16 products
are exact in f32); the float bank head to 3e-7 of max|ref| (the products
x · bank value are exact in f32 on both sides, only the sums' order
differs: measured 5.5e-8 here); the int8 heads bit for bit (exact int32
sums, then one f32 multiply by the same constant).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.kernels import mask_bank as jbank
from bayestpu.kernels import masked_matmul as jmm
from bayestpu_torch.kernels import masked_matmul as tmm

RATE = 0.25
STEPS = (2.0 ** -7, 2.0 ** -5)
# M, K, N of one sample: ragged, no multiple of any block
SHAPES = [(37, 45, 19), (20, 130, 9)]
# one seed pair per sample of x, the first negative
SEEDS = np.array([[-123456789, -7], [5, 99], [2 ** 31 - 1, 0]], np.int32)
# one bank index per sample of x: wrapping and negative (JAX's idx % n)
IDXS = np.array([2, -1, 5, 0, 7, -6], np.int32)
NUM_MASKS = 4
# the float bank head against JAX, relative to max|ref|
BANK_RTOL = 3e-7


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def float_data(request):
    m, k, n = request.param
    rng = np.random.default_rng(m * k)
    x3 = rng.normal(size=(len(SEEDS), m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return x3, w


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def int8_data(request):
    m, k, n = request.param
    rng = np.random.default_rng(m + k)
    xq3 = rng.integers(-128, 128, size=(len(IDXS), m, k)).astype(np.int8)
    wq = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    _, bank = jbank.generation_wrapper(k, NUM_MASKS, 2.0, rng=1)
    bank = bank.copy()
    bank[0, ::3] = 2.0          # kept: > 0.5
    bank[2, 1::5] = 0.5         # dropped: not > 0.5
    return xq3, wq, np.ascontiguousarray(bank)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def bank_float_data(request):
    m, k, n = request.param
    rng = np.random.default_rng(m * k + 1)
    x3 = rng.normal(size=(len(IDXS), m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    _, bank = jbank.generation_wrapper(k, NUM_MASKS, 2.0, rng=2)
    bank = bank.copy()
    bank[0, ::3] *= 2.0         # the float head multiplies by the value
    bank[2, 1::5] *= 0.5
    return x3, w, np.ascontiguousarray(bank)


@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_matmul_xs_equals_jax_vmap(float_data, bf16):
    """x (S, M, K) in f32 or bf16 under seeds (S, 2): equal to JAX's vmap
    over (x, seeds) to rtol 1e-5, atol 1e-5; sample s bit-equal to the
    single call on x[s] with seeds[s]; no launch counted on the CPU."""
    x3, w = float_data
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx, jw = jnp.asarray(x3, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jax.vmap(lambda xs, sd: jmm.dropout_matmul_inference(
        xs, jw, sd, RATE, interpret=True))(jx, jnp.asarray(SEEDS)))
    tdt = torch.bfloat16 if bf16 else torch.float32
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    seeds = torch.from_numpy(SEEDS)
    tmm.reset_launch_counts()
    got = tmm.dropout_matmul_inference(tx, tw, seeds, RATE)
    assert set(tmm.launch_counts.values()) == {0}
    assert got.dtype == torch.float32
    assert got.shape == (len(SEEDS), x3.shape[1], w.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for s in range(len(SEEDS)):
        assert torch.equal(got[s], tmm.dropout_matmul(tx[s], tw, seeds[s],
                                                      RATE))


@pytest.mark.parametrize("as_list", [False, True], ids=["tensor", "list"])
def test_bank_matmul_int8_xs_equals_jax_vmap(int8_data, as_list):
    """x_q (S, M, K) under S indices, negative and >= num_masks, as a
    tensor or as the list of ints a caller that maps several sites passes:
    bit-equal to JAX's vmap over (x_q, index) and, per sample, to the
    single call on x_q[s] at IDXS[s]; no launch counted on the CPU."""
    xq3, wq, bank = int8_data
    want = np.asarray(jax.vmap(
        lambda xs, i: jmm.bank_matmul_int8_inference(
            xs, jnp.asarray(wq), jnp.asarray(bank), i, *STEPS,
            interpret=True))(jnp.asarray(xq3), jnp.asarray(IDXS)))
    txq, twq, tb = (torch.from_numpy(a) for a in (xq3, wq, bank))
    idx = IDXS.tolist() if as_list else torch.from_numpy(IDXS)
    tmm.reset_launch_counts()
    got = tmm.bank_matmul_int8_inference(txq, twq, tb, idx, *STEPS)
    assert set(tmm.launch_counts.values()) == {0}
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for s, i in enumerate(IDXS.tolist()):
        assert torch.equal(got[s], tmm.bank_matmul_int8(txq[s], twq, tb, i,
                                                        *STEPS))


@pytest.mark.parametrize("as_list", [False, True], ids=["tensor", "list"])
@pytest.mark.parametrize("bf16", [False, True])
def test_bank_matmul_xs_equals_jax_vmap(bank_float_data, bf16, as_list):
    """x (S, M, K) in f32 or bf16 under S indices, negative and >=
    num_masks, as a tensor or as a list of ints, on a bank with values
    other than 0 and 1: within BANK_RTOL of JAX's vmap over (x, index) and,
    per sample, bit-equal to the single call on x[s] at IDXS[s]; no launch
    counted on the CPU."""
    x3, w, bank = bank_float_data
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx = jnp.asarray(x3, jdt)
    want = np.asarray(jax.vmap(lambda xs, i: jmm.bank_matmul_inference(
        xs, jnp.asarray(w), jnp.asarray(bank), i, interpret=True))(
        jx, jnp.asarray(IDXS)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(bank)
    idx = IDXS.tolist() if as_list else torch.from_numpy(IDXS)
    tmm.reset_launch_counts()
    got = tmm.bank_matmul_inference(tx, tw, tb, idx)
    assert set(tmm.launch_counts.values()) == {0}
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= BANK_RTOL * np.abs(want).max()
    for s, i in enumerate(IDXS.tolist()):
        assert torch.equal(got[s], tmm.bank_matmul(tx[s], tw, tb, i))


def test_dropout_matmul_int8_xs_equals_jax_vmap(int8_data):
    """x_q (S, M, K) under seeds (S, 2), the first negative: bit-equal to
    JAX's vmap over (x_q, seeds) and, per sample, to the single call on
    x_q[s] with seeds[s]; no launch counted on the CPU."""
    xq3, wq, _ = int8_data
    xq3 = np.ascontiguousarray(xq3[:len(SEEDS)])
    want = np.asarray(jax.vmap(
        lambda xs, sd: jmm.dropout_matmul_int8_inference(
            xs, jnp.asarray(wq), sd, RATE, *STEPS, interpret=True))(
        jnp.asarray(xq3), jnp.asarray(SEEDS)))
    txq, twq = torch.from_numpy(xq3), torch.from_numpy(wq)
    seeds = torch.from_numpy(SEEDS)
    tmm.reset_launch_counts()
    got = tmm.dropout_matmul_int8_inference(txq, twq, seeds, RATE, *STEPS)
    assert set(tmm.launch_counts.values()) == {0}
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for s in range(len(SEEDS)):
        assert torch.equal(got[s], tmm.dropout_matmul_int8(
            txq[s], twq, seeds[s], RATE, *STEPS))


def test_xs_launch_counters_exist():
    assert {"dropout_matmul_xs", "dropout_matmul_int8_xs", "bank_matmul_xs",
            "bank_matmul_int8_xs"} <= set(tmm.launch_counts)
    for name in ("dropout_matmul_xs", "dropout_matmul_int8_xs",
                 "bank_matmul_xs"):
        tmm.launch_counts[name] = 3
    tmm.reset_launch_counts()
    assert tmm.launch_counts["dropout_matmul_xs"] == 0
    assert tmm.launch_counts["dropout_matmul_int8_xs"] == 0
    assert tmm.launch_counts["bank_matmul_xs"] == 0


def _mc_call(x3, seeds):
    return tmm.dropout_matmul_inference(x3, torch.randn(x3.shape[-1], 3),
                                        seeds, RATE)


def _mc_int8_call(x3, seeds):
    return tmm.dropout_matmul_int8_inference(
        x3.to(torch.int8), torch.ones(x3.shape[-1], 3, dtype=torch.int8),
        seeds, RATE, 1.0, 1.0)


def _bank_call(idx):
    def call(x3, _):
        k = x3.shape[-1]
        return tmm.bank_matmul_int8_inference(
            x3.to(torch.int8), torch.ones(k, 3, dtype=torch.int8),
            torch.ones(NUM_MASKS, k), idx, 1.0, 1.0)
    return call


def _bank_float_call(idx):
    def call(x3, _):
        k = x3.shape[-1]
        return tmm.bank_matmul_inference(x3, torch.ones(k, 3),
                                         torch.ones(NUM_MASKS, k), idx)
    return call


@pytest.mark.parametrize("call", [
    _mc_call, _mc_int8_call,
    _bank_call(torch.tensor([0, 1], dtype=torch.int32)),
    _bank_call([0, 1, 2, 3]),
    _bank_float_call(torch.tensor([0, 1], dtype=torch.int32)),
    _bank_float_call([0, 1, 2, 3])],
    ids=["mc", "mc_int8", "bank_tensor", "bank_list", "bank_float_tensor",
         "bank_float_list"])
def test_xs_sample_count_mismatch_raises(call):
    """x carries 3 samples; 2 seed pairs, or 2 or 4 indices, raise."""
    x3 = torch.randn(3, 4, 8)
    seeds = torch.from_numpy(SEEDS[:2].copy())
    with pytest.raises(ValueError, match="carries 3 samples"):
        call(x3, seeds)


def test_xs_refuse_other_devices():
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="device"):
        tmm.dropout_matmul_inference(meta(2, 4, 16), meta(16, 3),
                                     meta(2, 2, dtype=torch.int32), RATE)
    with pytest.raises(ValueError, match="device"):
        tmm.bank_matmul_int8_inference(
            meta(2, 4, 16, dtype=torch.int8), meta(16, 3, dtype=torch.int8),
            meta(4, 16), meta(2, dtype=torch.int32), 1.0, 1.0)
    with pytest.raises(ValueError, match="device"):
        tmm.dropout_matmul_int8_inference(
            meta(2, 4, 16, dtype=torch.int8), meta(16, 3, dtype=torch.int8),
            meta(2, 2, dtype=torch.int32), RATE, 1.0, 1.0)
    with pytest.raises(ValueError, match="device"):
        tmm.bank_matmul_inference(meta(2, 4, 16), meta(16, 3), meta(4, 16),
                                  meta(2, dtype=torch.int32))


def test_xs_stride_must_fit_int32():
    tmm._x_stride(torch.empty(2, 2 ** 15, 2 ** 16 - 1, device="meta"))
    with pytest.raises(ValueError, match="int32"):
        tmm._x_stride(torch.empty(2, 2 ** 15, 2 ** 16, device="meta"))


@pytest.mark.parametrize("bf16", [False, True])
def test_xs_launch_passes_the_sample_stride(monkeypatch, bf16):
    """What the MC ``_xs`` launch hands the C entry
    ``bt_dropout_matmul_samples`` (``_build._SIGNATURES`` order: M, K, N,
    S, x_stride, thresh, scale, is_bf16, row0), and the counter it bumps;
    the samples launch passes x_stride 0. ``_call`` is replaced here: the CPU
    has no kernel to call."""
    calls = []
    monkeypatch.setattr(tmm, "_call", lambda name, device, tensors, args,
                        count=None: calls.append((name, list(tensors), args,
                                                  count)))
    dt = torch.bfloat16 if bf16 else torch.float32
    x3, w = torch.ones(3, 5, 7, dtype=dt), torch.ones(7, 2, dtype=dt)
    seeds = torch.from_numpy(SEEDS)
    out = tmm._launch("dropout_matmul_samples", x3, w, seeds,
                      [tmm._x_stride(x3)] + tmm._float_args(x3, RATE),
                      "dropout_matmul_xs")
    tmm._launch("dropout_matmul_samples", x3[0], w, seeds,
                [0] + tmm._float_args(x3, RATE))
    assert out.shape == (3, 5, 2)
    tail = [tmm.keep_threshold(RATE), tmm.scale_of(RATE, dt), int(bf16), 0]
    assert calls == [
        ("dropout_matmul_samples", ["x", "w", "seeds", "out"],
         [5, 7, 2, 3, 35] + tail, "dropout_matmul_xs"),
        ("dropout_matmul_samples", ["x", "w", "seeds", "out"],
         [5, 7, 2, 3, 0] + tail, None)]


def test_bank_xs_launch_passes_the_sample_stride(monkeypatch):
    """The int8 bank ``_xs`` launch: ``bt_bank_matmul_int8_samples`` gets
    M, K, N, S, x_stride, num_masks, out_scale and counts as
    ``bank_matmul_int8_xs``; the samples launch passes x_stride 0."""
    calls = []
    monkeypatch.setattr(tmm, "_call", lambda name, device, tensors, args,
                        count=None: calls.append((name, list(tensors), args,
                                                  count)))
    xq3 = torch.ones(2, 5, 7, dtype=torch.int8)
    wq = torch.ones(7, 3, dtype=torch.int8)
    bank = torch.ones(NUM_MASKS, 7)
    idxs = torch.tensor([1, -1], dtype=torch.int32)
    scale = [tmm.bank_out_scale(*STEPS)]
    tmm._launch_bank_xs("bank_matmul_int8_samples", xq3, wq, bank, idxs,
                        scale, "bank_matmul_int8_xs")
    tmm._launch_bank("bank_matmul_int8_samples", xq3[0], wq, bank, idxs,
                     scale, x_stride=0)
    names = ["x", "w", "bank", "idxs", "out"]
    assert calls == [
        ("bank_matmul_int8_samples", names, [5, 7, 3, 2, 35, NUM_MASKS]
         + scale, "bank_matmul_int8_xs"),
        ("bank_matmul_int8_samples", names, [5, 7, 3, 2, 0, NUM_MASKS]
         + scale, None)]


def _recorder(monkeypatch) -> list:
    """Replace ``_call`` (the CPU has no kernel to call) by a recorder of
    (C entry, tensor names, trailing C arguments, counter)."""
    calls = []
    monkeypatch.setattr(tmm, "_call", lambda name, device, tensors, args,
                        count=None: calls.append((name, list(tensors), args,
                                                  count)))
    return calls


@pytest.mark.parametrize("bf16", [False, True])
def test_bank_float_xs_launch_passes_the_sample_stride(monkeypatch, bf16):
    """The float bank ``_xs`` launch: ``bt_bank_matmul_samples`` gets M, K,
    N, S, x_stride, num_masks, is_bf16 and counts as ``bank_matmul_xs``;
    the samples launch passes x_stride 0 and counts as itself."""
    calls = _recorder(monkeypatch)
    dt = torch.bfloat16 if bf16 else torch.float32
    x3, w = torch.ones(2, 5, 7, dtype=dt), torch.ones(7, 3)
    bank = torch.ones(NUM_MASKS, 7)
    idxs = torch.tensor([1, -1], dtype=torch.int32)
    out = tmm._launch_bank_xs("bank_matmul_samples", x3, w, bank, idxs,
                              [int(bf16)], "bank_matmul_xs")
    tmm._launch_bank("bank_matmul_samples", x3[0], w, bank, idxs, [int(bf16)],
                     x_stride=0)
    assert out.shape == (2, 5, 3)
    names = ["x", "w", "bank", "idxs", "out"]
    assert calls == [
        ("bank_matmul_samples", names, [5, 7, 3, 2, 35, NUM_MASKS, int(bf16)],
         "bank_matmul_xs"),
        ("bank_matmul_samples", names, [5, 7, 3, 2, 0, NUM_MASKS, int(bf16)],
         None)]


def test_int8_xs_launch_passes_the_sample_stride(monkeypatch):
    """The int8 MC ``_xs`` launch: ``bt_dropout_matmul_int8_samples`` gets
    M, K, N, S, x_stride, thresh, out_scale, row0 and counts as
    ``dropout_matmul_int8_xs``; the samples launch passes x_stride 0."""
    calls = _recorder(monkeypatch)
    xq3 = torch.ones(3, 5, 7, dtype=torch.int8)
    wq = torch.ones(7, 2, dtype=torch.int8)
    seeds = torch.from_numpy(SEEDS)
    tail = tmm._int8_args(RATE, *STEPS)
    assert tail == [tmm.keep_threshold(RATE),
                    tmm.int8_out_scale(*STEPS, RATE), 0]
    out = tmm._launch("dropout_matmul_int8_samples", xq3, wq, seeds,
                      [tmm._x_stride(xq3)] + tail, "dropout_matmul_int8_xs")
    tmm._launch("dropout_matmul_int8_samples", xq3[0], wq, seeds, [0] + tail)
    assert out.shape == (3, 5, 2)
    names = ["x", "w", "seeds", "out"]
    assert calls == [
        ("dropout_matmul_int8_samples", names, [5, 7, 2, 3, 35] + tail,
         "dropout_matmul_int8_xs"),
        ("dropout_matmul_int8_samples", names, [5, 7, 2, 3, 0] + tail, None)]


@pytest.mark.parametrize("sample_idx", [3, -1, 9])
def test_bank_int8_launch_arguments(monkeypatch, sample_idx):
    """Row 7's launch: ``bt_bank_matmul_int8`` gets M, K, N, the index as
    ``bank_matmul_int8`` reduces it (modulo num_masks, floored, as JAX's
    ``idx % num_masks``), num_masks and out_scale, and nothing more (its K
    split is the kernel's own constant); it counts as itself."""
    calls = _recorder(monkeypatch)
    xq, wq = torch.ones(5, 7, dtype=torch.int8), torch.ones(7, 3,
                                                          dtype=torch.int8)
    bank = torch.ones(NUM_MASKS, 7)
    scale = tmm.bank_out_scale(*STEPS)
    idx = tmm.bank_index(sample_idx, NUM_MASKS)
    assert idx == sample_idx % NUM_MASKS and 0 <= idx < NUM_MASKS
    out = tmm._launch_bank("bank_matmul_int8", xq, wq, bank, idx, [scale])
    assert out.shape == (5, 3)
    assert calls == [("bank_matmul_int8", ["x", "w", "bank", "out"],
                      [5, 7, 3, idx, NUM_MASKS, scale], None)]
