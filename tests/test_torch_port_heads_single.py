"""The port's single-sample MC heads, ``dropout_matmul`` (row 2) and
``dropout_matmul_int8`` (row 4), and the float Masksembles single head
``bank_matmul`` (row 9), on the CPU: the summation order of the float
kernels against the JAX package, and what the MC wrappers hand their C
entries.

On the card row 2 is the MC samples kernel (row 3) at one sample,
``chain_samples_kernel<HashChain<T>>`` in
``bayestpu_torch/csrc/masked_matmul.cu``: each output is summed as one
serial f32 chain, one fused multiply-add a term, in ascending k. No CUDA
kernel runs here, so a numpy model of that order (``chain_order``) stands
in for it, and is held against JAX's ``dropout_matmul`` with the Pallas
kernel in the interpreter (``interpret=True``, as
``test_torch_port_kernels.py`` runs it) and against the port's plain
version, to 1e-5 of max|ref|, the ``KERNEL_RTOL`` that ``chip_smoke.py``
holds the card to. So the order the kernel keeps cannot leave that
tolerance at the head shape, the ragged one, a single block with a tail
of K shorter than a chunk, or an odd K. Row 9 is the Masksembles samples
kernel (row 8) at one sample, ``chain_samples_kernel<BankChain<T>>``: the
same serial chain over the masked value ``f32(x) · bank[idx]``, held to
JAX's ``bank_matmul`` the same way. Row 4 sums exactly in int32 in any
order and is held bit for bit elsewhere (``test_torch_port_int8.py``,
``chip_smoke.py``).

The launch tests replace ``_call`` (the CPU has no kernel to call) and run
the public wrappers on tensors on PyTorch's ``meta`` device, which take the
kernel path as a CUDA tensor does; the device check of
``_check_rate_seeds`` is the only check mapped to the CPU for that.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bayestpu.kernels import masked_matmul as jmm
from bayestpu_torch.kernels import masked_matmul as tmm
from bayestpu_torch.kernels.mask_bank import generation_wrapper

RATE = 0.25
RTOL = 1e-5                     # of max|ref|: chip_smoke.py's KERNEL_RTOL
STEPS = (2.0 ** -7, 2.0 ** -5)
# M, K, N: the vgg11_me head; chip_smoke.py's ragged shape (K = 700: a
# last chunk of 60 terms, shorter than the 64 (f32) or 128 (bf16) of a
# chunk); one block of the kernel (8 rows, 16 columns) over that K; K odd
SHAPES = {"head": (128, 512, 10), "ragged": (300, 700, 130),
          "block_k700": (8, 700, 16), "odd_k": (37, 45, 19)}
SEEDS = np.array([-123456789, -7], np.int32)       # negative, as on the card


def chain_order(xm: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(M, N) f32 sums of xm (M, K) @ w (K, N) in the kernel's order: one
    chain an output, term k after term k - 1, each term one fused
    multiply-add (the exact product plus the chain in float64, rounded once
    to f32; float64 holds the product exactly and rounds the sum before f32
    only in rare ties)."""
    m, k = xm.shape
    acc = np.zeros((m, w.shape[1]), np.float32)
    x64, w64 = xm.astype(np.float64), w.astype(np.float64)
    for kk in range(k):
        acc = (acc + x64[:, kk, None] * w64[None, kk, :]).astype(np.float32)
    return acc


@pytest.fixture(scope="module", params=list(SHAPES))
def data(request):
    """For one shape, f32 and bf16: the masked x and w as the kernel's
    chains read them (x * scale rounded to x's dtype, or 0; both widened
    exactly to f32), JAX's ``dropout_matmul`` and the port's plain
    version."""
    m, k, n = SHAPES[request.param]
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    seeds = torch.from_numpy(SEEDS)
    out = {}
    for bf16 in (False, True):
        tdt = torch.bfloat16 if bf16 else torch.float32
        jdt = jnp.bfloat16 if bf16 else jnp.float32
        xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
        keep = tmm.keep_mask(seeds, m, k, RATE)
        scale = torch.tensor(tmm.scale_of(RATE, tdt), dtype=tdt)
        xm = torch.where(keep, xt * scale, torch.zeros((), dtype=tdt))
        out[bf16] = dict(
            xm=xm.float().numpy(), w=wt.float().numpy(),
            jax=np.asarray(jmm.dropout_matmul(
                jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                jnp.asarray(SEEDS), RATE, interpret=True)),
            plain=tmm.dropout_matmul_plain(xt, wt, seeds, RATE).numpy())
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_chain_order_within_tolerance_of_jax_and_plain(data, bf16):
    d = data[bf16]
    got = chain_order(d["xm"], d["w"])
    for name in ("jax", "plain"):
        ref = d[name]
        err = np.abs(got - ref).max()
        assert err <= RTOL * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("odd", [False, True], ids=["bank", "bank_odd"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bank_chain_order_within_tolerance_of_jax(shape, bf16, odd):
    """Row 9's order, the serial chain over ``f32(x) · bank[idx % n]``
    (one f32 multiply, then one fused multiply-add a term in ascending k),
    within 1e-5 of max|ref| of JAX's ``bank_matmul`` (Pallas interpreter)
    and of the port's plain version, at a wrapping and a negative index;
    on the generated {0, 1} bank and on one with 2.0 and 0.25 entries."""
    m, k, n = SHAPES[shape]
    rng = np.random.default_rng(m + k * n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    _, bank = generation_wrapper(k, 4, 2.0, rng=0)
    bank = np.ascontiguousarray(bank, np.float32)
    if odd:
        bank[0, ::7] = 2.0
        bank[1, 1::5] = 0.25
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xw = np.array(jx.astype(jnp.float32))          # x as the kernel widens it
    tx = torch.from_numpy(xw).to(torch.bfloat16 if bf16 else torch.float32)
    for idx in (5, -1):
        row = bank[idx % 4]
        xm = (xw.astype(np.float64) * row).astype(np.float32)
        got = chain_order(xm, w)
        for ref in (np.asarray(jmm.bank_matmul(jx, jnp.asarray(w),
                                               jnp.asarray(bank), idx,
                                               interpret=True)),
                    tmm.bank_matmul_plain(tx, torch.from_numpy(w),
                                          torch.from_numpy(bank),
                                          idx).numpy()):
            err = np.abs(got - ref).max()
            assert err <= RTOL * np.abs(ref).max(), (idx, err)


def _recorder(monkeypatch) -> list:
    """Replace ``_call`` by a recorder of (C entry, tensors, trailing C
    arguments, counter), and map the device of ``_check_rate_seeds`` to
    the CPU so that ``meta`` tensors pass its other checks."""
    calls = []
    monkeypatch.setattr(tmm, "_call", lambda name, device, tensors, args,
                        count=None: calls.append((name, tensors, args,
                                                  count)))
    real = tmm._check_rate_seeds
    monkeypatch.setattr(tmm, "_check_rate_seeds", lambda x, seeds, ndim,
                        rate: real(torch.empty(x.shape, dtype=x.dtype),
                                   torch.empty(seeds.shape,
                                               dtype=seeds.dtype),
                                   ndim, rate))
    return calls


def _meta(*shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _seed_pair(tensors):
    sd = tensors["seeds"]
    return tuple(sd.shape), sd.dtype, sd.is_contiguous()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_dropout_matmul_launch_arguments(monkeypatch, bf16):
    """``dropout_matmul`` hands ``bt_dropout_matmul`` x, w, the seed pair
    as one contiguous (1, 2) int32 and out, then M, K, N, thresh, the
    dtype's scale, is_bf16 and row0 (``_build._SIGNATURES`` order; row0
    taken modulo 2^32), and counts as ``dropout_matmul``; at rate 0 it
    launches nothing."""
    calls = _recorder(monkeypatch)
    dt = torch.bfloat16 if bf16 else torch.float32
    x, w = _meta(5, 7, dtype=dt), _meta(7, 3, dtype=dt)
    seeds = _meta(4, 2, dtype=torch.int32)[2]
    out = tmm.dropout_matmul(x, w, seeds, RATE)
    assert out.shape == (5, 3) and out.dtype == torch.float32
    tmm.dropout_matmul(x, w, seeds, 0.0)
    tmm.dropout_matmul(x, w, seeds, RATE, row0=2 ** 32 + 6)
    assert len(calls) == 2
    name, tensors, args, count = calls[0]
    assert (name, list(tensors), count) == (
        "dropout_matmul", ["x", "w", "seeds", "out"], None)
    assert _seed_pair(tensors) == ((1, 2), torch.int32, True)
    assert args == [5, 7, 3, tmm.keep_threshold(RATE),
                    tmm.scale_of(RATE, dt), int(bf16), 0]
    assert calls[1][2] == args[:-1] + [6]


def test_dropout_matmul_int8_launch_arguments(monkeypatch):
    """``dropout_matmul_int8`` hands ``bt_dropout_matmul_int8`` x_q, w_q,
    the seed pair as one contiguous (1, 2) int32 and out, then M, K, N,
    thresh, out_scale and row0 (no dtype flag: int8 only; its K split is
    the kernel's own constant), and counts as ``dropout_matmul_int8``; at
    rate 0 it launches nothing."""
    calls = _recorder(monkeypatch)
    xq, wq = _meta(5, 7, dtype=torch.int8), _meta(7, 3, dtype=torch.int8)
    seeds = _meta(2, dtype=torch.int32)
    out = tmm.dropout_matmul_int8(xq, wq, seeds, RATE, *STEPS)
    assert out.shape == (5, 3) and out.dtype == torch.float32
    tmm.dropout_matmul_int8(xq, wq, seeds, 0.0, *STEPS)
    assert len(calls) == 1
    name, tensors, args, count = calls[0]
    assert (name, list(tensors), count) == (
        "dropout_matmul_int8", ["x", "w", "seeds", "out"], None)
    assert _seed_pair(tensors) == ((1, 2), torch.int32, True)
    assert args == [5, 7, 3, tmm.keep_threshold(RATE),
                    tmm.int8_out_scale(*STEPS, RATE), 0]


@pytest.mark.parametrize("call", ["float", "int8"])
def test_single_heads_refuse_a_seed_batch(monkeypatch, call):
    """The single heads take one (2,) pair; (S, 2) seeds are the samples
    heads' and are refused before any launch."""
    calls = _recorder(monkeypatch)
    seeds = _meta(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        if call == "float":
            tmm.dropout_matmul(_meta(5, 7, dtype=torch.float32),
                               _meta(7, 3, dtype=torch.float32), seeds, RATE)
        else:
            tmm.dropout_matmul_int8(_meta(5, 7, dtype=torch.int8),
                                    _meta(7, 3, dtype=torch.int8), seeds,
                                    RATE, *STEPS)
    assert calls == []
