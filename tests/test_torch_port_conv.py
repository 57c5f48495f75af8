"""The port's masked-conv family (rows 10 and 11 of the kernel table)
against the JAX package's, on the CPU.

Every entry point of ``bayestpu_torch.kernels.masked_conv`` — its plain
version, because the tensors lie on the CPU — against the JAX function
with the Pallas kernels in the interpreter (``interpret=True``, as
``tests/test_fused_conv.py`` runs them), on one set of numpy inputs made
from a seed: x NHWC ↔ NCHW in ``channels_last`` memory, w HWIO ↔ OIHW.

Tolerances: masks are compared exactly (the readout ``conv(ones, 1×1
identity)``); int8 results bit for bit (exact int32 sums, then the same f32
multiplies and adds); f32 results to FLOAT_RTOL of max|ref| (the products
are exact, the f32 sums run in another order); a bf16 output one bf16 ulp
(2⁻⁸ relative) where an f32 sum a few ulps away rounds the other way.
``chip_smoke.py`` holds the CUDA kernels against the same plain versions on
the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.kernels import masked_conv as jmc
from bayestpu.kernels import mask_bank as jbank
from bayestpu_torch.kernels import masked_conv as tmc
from bayestpu_torch.kernels import masked_matmul as tmm

from port_threads import thread_budget  # noqa: F401

I = dict(interpret=True)
RATE = 0.25
FLOAT_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8
STEPS = (2.0 ** -7, 2.0 ** -6)
# x NHWC, kernel size, F, padding, stride: stride 1 SAME, stride 2 SAME
# (asymmetric: 8 → 4 pads (0, 1)), VALID, explicit asymmetric pairs at
# stride 2, a 1×1 stride-2 conv; F not a multiple of 8
GEOMS = {
    "same_s1": ((2, 6, 5, 33), 3, 13, "SAME", 1),
    "same_s2": ((2, 8, 8, 34), 3, 12, "SAME", 2),
    "valid": ((2, 7, 6, 32), 3, 9, "VALID", 1),
    "explicit_s2": ((2, 9, 7, 35), 3, 11, ((2, 1), (0, 2)), 2),
    "1x1_s2": ((3, 6, 6, 36), 1, 10, "SAME", 2),
}
# the first pair negative
SEEDS = np.array([[-123456789, -7], [5, 99], [2 ** 31 - 1, 0]], np.int32)
IDXS = np.array([2, -1, 5], np.int32)


def _data(name, seed=0):
    shape, k, f, _, _ = GEOMS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], f))
         / np.sqrt(k * k * shape[-1])).astype(np.float32)
    affine = np.stack([rng.uniform(0.5, 1.5, f),
                       rng.normal(scale=0.3, size=f)]).astype(np.float32)
    return x, w, affine


def _int8_data(name, seed=0):
    shape, k, f, _, _ = GEOMS[name]
    rng = np.random.default_rng(seed + 100)
    return (rng.integers(-128, 128, size=shape).astype(np.int8),
            rng.integers(-128, 128, size=(k, k, shape[-1], f)).astype(
                np.int8))


def _bank(c, non_binary=False):
    _, bank = jbank.generation_wrapper(c, 4, 2.0, rng=0)
    bank = bank.copy()
    if non_binary:          # the float kernels multiply by the value
        bank[0, ::3] *= 2.0
        bank[2, 1::5] *= 0.25
    return bank


def _x(a, dtype=None):
    """NHWC numpy → NCHW torch in channels_last memory."""
    t = torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
    return t if dtype is None else t.to(dtype)


def _w(a, dtype=None):
    t = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1)))
    return t if dtype is None else t.to(dtype)


def _np(t):
    """Port result → NHWC numpy, (S,) samples included."""
    t = t.detach()
    t = t.permute(0, 2, 3, 1) if t.dim() == 4 else t.permute(0, 1, 3, 4, 2)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want, rtol=FLOAT_RTOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = _np(got) if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


def _jx(a, bf16):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _tx(a, bf16):
    return _x(np.asarray(_jx(a, bf16).astype(jnp.float32)),
              torch.bfloat16 if bf16 else torch.float32)


# ------------------------------------------------------------- geometry


@pytest.mark.parametrize("h,k,padding,stride", [
    (16, 3, "SAME", 1), (16, 3, "SAME", 2), (15, 3, "SAME", 2),
    (8, 1, "SAME", 2), (7, 3, "VALID", 1), (9, 3, "VALID", 2),
    (9, 3, ((2, 1), (0, 2)), 2), (6, 5, ((1, 1), (1, 1)), 1)])
def test_geometry_equals_jax(h, k, padding, stride):
    g = jmc._Geom((1, h, h + 1, 4), (k, k, 4, 4), padding, 0, 128, 0,
                  stride=stride)
    got = tmc.geometry(h, h + 1, k, k, padding, stride)
    assert got == (g.ph, g.ph_hi, g.pw, g.pw_hi, g.ho, g.wo)


def test_same_stride_2_is_asymmetric():
    assert tmc.geometry(16, 16, 3, 3, "SAME", 2)[:4] == (0, 1, 0, 1)


# ------------------------------------------------------ row 10: float


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_dropout_conv_samples_equals_jax(geom, bf16):
    """Every sample in one call with the full epilogue ((2, F) affine,
    relu), f32 out; and with a bf16 store. Sample s equals the single call
    with SEEDS[s] bit for bit, and the single call without an epilogue
    equals JAX's trainable ``dropout_conv``."""
    x, w, affine = _data(geom)
    _, _, _, padding, stride = GEOMS[geom]
    jx, jw = _jx(x, bf16), _jx(w, bf16)
    tx = _tx(x, bf16)
    tw = _w(np.asarray(jw.astype(jnp.float32))).to(tx.dtype)
    kw = dict(bias=jnp.asarray(affine), act="relu", stride=stride)
    want = jmc.dropout_conv_samples(jx, jw, jnp.asarray(SEEDS), RATE,
                                    padding, **I, **kw)
    tkw = dict(kw, bias=torch.from_numpy(affine))
    got = tmc.dropout_conv_samples(tx, tw, torch.from_numpy(SEEDS), RATE,
                                   padding, **tkw)
    assert got.dtype == torch.float32 and got.shape[0] == len(SEEDS)
    _close(got, want)
    want16 = jmc.dropout_conv_samples(jx, jw, jnp.asarray(SEEDS), RATE,
                                      padding, out_dtype=jnp.bfloat16, **I,
                                      **kw)
    got16 = tmc.dropout_conv_samples(tx, tw, torch.from_numpy(SEEDS), RATE,
                                     padding, out_dtype=torch.bfloat16, **tkw)
    assert got16.dtype == torch.bfloat16
    _close(got16, want16, BF16_RTOL)
    for s in range(len(SEEDS)):
        one = tmc.dropout_conv_inference(tx, tw, torch.from_numpy(SEEDS[s]),
                                         RATE, padding, **tkw)
        assert torch.equal(one, got[s])
    plain = tmc.dropout_conv(tx, tw, torch.from_numpy(SEEDS[0]), RATE,
                             padding, stride)
    _close(plain, jmc.dropout_conv(jx, jw, jnp.asarray(SEEDS[0]), RATE,
                                   padding, interpret=True, stride=stride))
    assert plain.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("bf16", [False, True])
def test_mask_readout_equals_dropout_apply(bf16):
    """``conv(ones, 1×1 identity)`` reads the mask back: exactly JAX's, the
    kept value the dtype's scale (1.3359375 in bf16); its nonzero pattern
    is ``mask_apply_nhwc``'s, which equals JAX's bit for bit."""
    n, h, w, c = 2, 5, 4, 40
    ones = np.ones((n, h, w, c), np.float32)
    eye = np.eye(c, dtype=np.float32)[None, None]
    dt = torch.bfloat16 if bf16 else torch.float32
    want = np.asarray(jmc.dropout_conv_samples(
        _jx(ones, bf16), _jx(eye, bf16), jnp.asarray(SEEDS), RATE, "VALID",
        **I))
    got = _np(tmc.dropout_conv_samples(_x(ones, dt), _w(eye, dt),
                                       torch.from_numpy(SEEDS), RATE,
                                       "VALID"))
    np.testing.assert_array_equal(got, want)
    assert sorted(set(np.unique(got))) == [0.0, tmm.scale_of(RATE, dt)]
    for s in range(len(SEEDS)):
        applied = tmc.mask_apply_nhwc(_x(ones), torch.from_numpy(SEEDS[s]),
                                      RATE)
        japplied = np.asarray(jmc.mask_apply_nhwc(
            jnp.asarray(ones), jnp.asarray(SEEDS[s]), RATE, interpret=True))
        np.testing.assert_array_equal(_np(applied), japplied)
        np.testing.assert_array_equal(_np(applied) != 0, got[s] != 0)


def test_rate_zero_takes_the_reference_conv():
    """At rate 0 JAX's float entries take ``_conv_ref`` (bf16: the conv is
    rounded to bf16) and the epilogue; the port's do the same."""
    x, w, affine = _data("same_s2")
    for bf16 in (False, True):
        jx, jw = _jx(x, bf16), _jx(w, bf16)
        dt = torch.bfloat16 if bf16 else torch.float32
        tx, tw = _tx(x, bf16), _w(np.asarray(jw.astype(jnp.float32))).to(dt)
        want = jmc.dropout_conv(jx, jw, jnp.asarray(SEEDS[0]), 0.0, "SAME",
                                interpret=True, stride=2)
        got = tmc.dropout_conv(tx, tw, torch.from_numpy(SEEDS[0]), 0.0,
                               "SAME", 2)
        _close(got, want)
        if bf16:     # bf16-rounded values, widened
            assert torch.equal(got, got.bfloat16().float())
        want = jmc.dropout_conv_inference(jx, jw, jnp.asarray(SEEDS[0]), 0.0,
                                          "SAME", interpret=True, stride=2)
        _close(tmc.dropout_conv_inference(tx, tw, torch.from_numpy(SEEDS[0]),
                                          0.0, "SAME", stride=2), want)
        want = jmc.dropout_conv_samples(jx, jw, jnp.asarray(SEEDS), 0.0,
                                        "SAME", **I, bias=affine[1],
                                        act="relu", stride=2)
        got = tmc.dropout_conv_samples(tx, tw, torch.from_numpy(SEEDS), 0.0,
                                       "SAME", bias=torch.from_numpy(
                                           affine[1]), act="relu", stride=2)
        _close(got, want)
        assert torch.equal(got[0], got[2])


def test_conv_fused_equals_jax():
    """Row 10 without a mask: f32 sums of the bf16 products, the (F,) bias
    and relu, a bf16 store; and an int8 store."""
    x, w, affine = _data("same_s1")
    jx, jw = _jx(x, True), _jx(w, True)
    tx = _tx(x, True)
    tw = _w(np.asarray(jw.astype(jnp.float32))).bfloat16()
    want = jmc.conv_fused(jx, jw, bias=jnp.asarray(affine[1]), act="relu",
                          out_dtype=jnp.bfloat16, interpret=True)
    got = tmc.conv_fused(tx, tw, bias=torch.from_numpy(affine[1]),
                         act="relu", out_dtype=torch.bfloat16)
    _close(got, want, BF16_RTOL)
    want = np.asarray(jmc.conv_fused(jx, jw, bias=jnp.asarray(affine),
                                     out_step=STEPS[0], interpret=True))
    got = _np(tmc.conv_fused(tx, tw, bias=torch.from_numpy(affine),
                             out_step=STEPS[0]))
    assert got.dtype == np.int8
    # an f32 sum a few ulps off JAX's may round one grid step the other way
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 1e-3


# ------------------------------------------------------- row 10: int8


EPILOGUES = {
    "f32": dict(),
    "affine_relu_int8": dict(bias="affine", act="relu", out_step=STEPS[0]),
    "bias_int8": dict(bias="bias", out_step=STEPS[1]),
    "affine_f32": dict(bias="affine"),
}


def _epi(name, affine, torch_side):
    kw = dict(EPILOGUES[name])
    if "bias" in kw:
        b = affine if kw["bias"] == "affine" else affine[1]
        kw["bias"] = torch.from_numpy(b) if torch_side else jnp.asarray(b)
    return kw


@pytest.mark.parametrize("epi", list(EPILOGUES))
@pytest.mark.parametrize("geom", ["same_s1", "same_s2", "explicit_s2"])
def test_dropout_conv_int8_equals_jax(geom, epi):
    """Row 10 in int8, every epilogue: the samples entry and the single one
    bit-equal to JAX (the mask of the float kernels, exact int32 sums, one
    f32 rescale, the f32 epilogue); sample s bit-equal to the single call
    with SEEDS[s]."""
    xq, wq = _int8_data(geom)
    _, _, affine = _data(geom)
    stride = GEOMS[geom][4]
    padding = GEOMS[geom][3]
    want = np.asarray(jmc.dropout_conv_int8_samples(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(SEEDS), RATE, *STEPS,
        padding, **I, stride=stride, **_epi(epi, affine, False)))
    tkw = dict(stride=stride, **_epi(epi, affine, True))
    got = tmc.dropout_conv_int8_samples(_x(xq), _w(wq),
                                        torch.from_numpy(SEEDS), RATE,
                                        *STEPS, padding, **tkw)
    np.testing.assert_array_equal(_np(got), want)
    for s in (0, 2):
        one = tmc.dropout_conv_int8_inference(
            _x(xq), _w(wq), torch.from_numpy(SEEDS[s]), RATE, *STEPS,
            padding, **tkw)
        assert torch.equal(one, got[s])
    if epi == "f32":
        jone = jmc.dropout_conv_int8(jnp.asarray(xq), jnp.asarray(wq),
                                     jnp.asarray(SEEDS[1]), RATE, *STEPS,
                                     padding, interpret=True, stride=stride)
        np.testing.assert_array_equal(_np(got[1:2])[0], np.asarray(jone))


def test_int8_readout_and_rate_zero():
    """The int8 readout keeps exactly where the float kernel keeps, with
    value out_scale; at rate 0 the int8 kernel masks nothing and scales by
    x_step·w_step (JAX launches it unmasked too); ``conv_int8_fused``
    equals JAX's."""
    c = 36
    ones = np.ones((2, 4, 5, c), np.int8)
    eye = np.eye(c, dtype=np.int8)[None, None]
    got = tmc.dropout_conv_int8_samples(_x(ones), _w(eye),
                                        torch.from_numpy(SEEDS), RATE,
                                        *STEPS, "VALID")
    fl = tmc.dropout_conv_samples(_x(ones.astype(np.float32)),
                                  _w(eye.astype(np.float32)),
                                  torch.from_numpy(SEEDS), RATE, "VALID")
    assert torch.equal(got != 0, fl != 0)
    assert sorted(set(torch.unique(got).tolist())) == [
        0.0, tmm.int8_out_scale(*STEPS, RATE)]
    xq, wq = _int8_data("same_s2")
    _, _, affine = _data("same_s2")
    want = np.asarray(jmc.dropout_conv_int8(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(SEEDS[0]), 0.0, *STEPS,
        "SAME", interpret=True, stride=2))
    np.testing.assert_array_equal(_np(tmc.dropout_conv_int8(
        _x(xq), _w(wq), torch.from_numpy(SEEDS[0]), 0.0, *STEPS, "SAME",
        stride=2)), want)
    want = np.asarray(jmc.conv_int8_fused(
        jnp.asarray(xq), jnp.asarray(wq), *STEPS, bias=jnp.asarray(affine),
        act="relu", out_step=STEPS[0], interpret=True, stride=2))
    got = tmc.conv_int8_fused(_x(xq), _w(wq), *STEPS,
                              bias=torch.from_numpy(affine), act="relu",
                              out_step=STEPS[0], stride=2)
    np.testing.assert_array_equal(_np(got), want)


# --------------------------------------------------------- row 11: bank


@pytest.mark.parametrize("non_binary", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("geom", ["same_s1", "same_s2", "1x1_s2"])
def test_bank_conv_equals_jax(geom, bf16, non_binary):
    """Row 11 in float: x (f32, or bf16 widened) times the bank's value, the
    f32 kernel never cast, the epilogue; the samples entry at wrapping and
    negative indices, and the single entry at each, sample s bit-equal."""
    x, w, affine = _data(geom, seed=1)
    _, _, _, padding, stride = GEOMS[geom]
    bank = _bank(x.shape[-1], non_binary)
    jx, tx = _jx(x, bf16), _tx(x, bf16)
    kw = dict(act="relu", stride=stride)
    want = jmc.bank_conv_samples(jx, jnp.asarray(w), jnp.asarray(bank),
                                 jnp.asarray(IDXS), padding, **I,
                                 bias=jnp.asarray(affine[1]), **kw)
    tkw = dict(kw, bias=torch.from_numpy(affine[1]))
    tb = torch.from_numpy(bank)
    got = tmc.bank_conv_samples(tx, _w(w), tb, torch.from_numpy(IDXS),
                                padding, **tkw)
    assert got.dtype == torch.float32
    _close(got, want)
    for s, i in enumerate(IDXS):
        one = tmc.bank_conv_inference(tx, _w(w), tb, int(i), padding, **tkw)
        assert torch.equal(one, got[s])
    jone = jmc.bank_conv(jx, jnp.asarray(w), jnp.asarray(bank), -1, padding,
                         **I, bias=jnp.asarray(affine[1]), **kw)
    _close(tmc.bank_conv(tx, _w(w), tb, -1, padding, **tkw), jone)


@pytest.mark.parametrize("epi", ["f32", "affine_relu_int8", "bias_int8"])
def test_bank_conv_int8_equals_jax(epi):
    """Row 11 in int8, bit for bit: the bank binarized at 0.5 (a 2.0 entry
    keeps, a 0.5 one drops), every epilogue; sample s bit-equal to the
    single call."""
    xq, wq = _int8_data("same_s2")
    _, _, affine = _data("same_s2")
    bank = _bank(xq.shape[-1], non_binary=True)
    want = np.asarray(jmc.bank_conv_int8_samples(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bank),
        jnp.asarray(IDXS), *STEPS, "SAME", **I, stride=2,
        **_epi(epi, affine, False)))
    tkw = dict(stride=2, **_epi(epi, affine, True))
    tb = torch.from_numpy(bank)
    got = tmc.bank_conv_int8_samples(_x(xq), _w(wq), tb,
                                     torch.from_numpy(IDXS), *STEPS, "SAME",
                                     **tkw)
    np.testing.assert_array_equal(_np(got), want)
    for s, i in enumerate(IDXS):
        assert torch.equal(tmc.bank_conv_int8_inference(
            _x(xq), _w(wq), tb, int(i), *STEPS, "SAME", **tkw), got[s])


def test_bank_row_select_clips_negative_entries():
    """JAX selects a bank row as a max over a where (``_bank_select_row``),
    in the single kernel and the samples kernel alike: a negative entry
    reads as 0 when there is more than one row, and as itself when there
    is one. The port reproduces both."""
    x, w, _ = _data("same_s1", seed=2)
    c = x.shape[-1]
    bank = _bank(c)
    bank[1, :7] = -1.5
    for b in (bank, bank[1:2]):
        want = jmc.bank_conv_samples(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), jnp.asarray([1, 0]),
                                     **I)
        got = tmc.bank_conv_samples(_x(x), _w(w), torch.from_numpy(b),
                                    torch.tensor([1, 0]))
        _close(got, want)
        jone = jmc.bank_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             1, **I)
        _close(tmc.bank_conv(_x(x), _w(w), torch.from_numpy(b), 1), jone)
    clipped = bank.copy()
    clipped[1, :7] = 0.0
    assert torch.equal(
        tmc.bank_conv(_x(x), _w(w), torch.from_numpy(bank), 1),
        tmc.bank_conv(_x(x), _w(w), torch.from_numpy(clipped), 1))


# ------------------------------------------------ dispatch and training


def test_inference_dispatch_follows_the_vmap_rules():
    """seeds (S, 2) with a shared x: one samples call, equal to JAX's vmap
    over the seeds; x carrying the sample axis (S, N, C, H, W): sample s of
    x under seeds[s], equal to JAX's vmap over (x, seeds) (its ``lax.map``
    fallback) and to the single call on x[s] (on the card one _xs launch
    for the S samples, here the single plain version per sample); the
    Masksembles entries alike over indices (one single call per sample)."""
    x, w, affine = _data("same_s1", seed=3)
    x5 = np.stack([x, 2.0 * x, -x])
    jw, tw = jnp.asarray(w), _w(w)
    kw = dict(bias=jnp.asarray(affine), act="relu")
    tkw = dict(bias=torch.from_numpy(affine), act="relu")
    f = jax.vmap(lambda xs, sd: jmc.dropout_conv_inference(
        xs, jw, sd, RATE, interpret=True, **kw))
    want = f(jnp.asarray(x5), jnp.asarray(SEEDS))
    t5 = torch.from_numpy(x5).permute(0, 1, 4, 2, 3)
    got = tmc.dropout_conv_inference(t5, tw, torch.from_numpy(SEEDS), RATE,
                                     **tkw)
    _close(got, want)
    for s in range(3):
        assert torch.equal(got[s], tmc.dropout_conv_inference(
            _x(x5[s]), tw, torch.from_numpy(SEEDS[s]), RATE, **tkw))
    shared = jax.vmap(lambda sd: jmc.dropout_conv_inference(
        jnp.asarray(x), jw, sd, RATE, interpret=True, **kw))(
        jnp.asarray(SEEDS))
    _close(tmc.dropout_conv_inference(_x(x), tw, torch.from_numpy(SEEDS),
                                      RATE, **tkw), shared)
    bank = _bank(x.shape[-1])
    fb = jax.vmap(lambda xs, i: jmc.bank_conv_inference(
        xs, jw, jnp.asarray(bank), i, interpret=True, **kw))
    want = fb(jnp.asarray(x5), jnp.asarray(IDXS))
    got = tmc.bank_conv_inference(t5, tw, torch.from_numpy(bank),
                                  torch.from_numpy(IDXS), **tkw)
    _close(got, want)


def test_host_index_list_equals_index_tensor():
    """With x carrying the sample axis a Masksembles site also takes its S
    indices as a list of ints (the model copies them to the host once a
    predict): the float and int8 conv sites, both heads and the unfused row
    multiply give what they give for the index tensor, bit for bit."""
    from bayestpu_torch.nn.bayes import apply_row
    x, w, affine = _data("same_s1", seed=4)
    x5 = np.stack([x, 2.0 * x, -x])
    t5 = torch.from_numpy(x5).permute(0, 1, 4, 2, 3)
    bank = torch.from_numpy(_bank(x.shape[-1]))
    idxs, listed = torch.from_numpy(IDXS), [int(i) for i in IDXS]
    tw, tb = _w(w), torch.from_numpy(affine)
    assert tmm.host_indices(listed) == tmm.host_indices(idxs) == listed
    for got, want in (
            (tmc.bank_conv_inference(t5, tw, bank, listed, bias=tb),
             tmc.bank_conv_inference(t5, tw, bank, idxs, bias=tb)),
            (apply_row(t5, bank, listed, -3, carries_samples=True),
             apply_row(t5, bank, idxs, -3, carries_samples=True))):
        assert torch.equal(got, want)
    q5 = torch.from_numpy(np.clip(np.round(x5 * 40), -128, 127).astype(
        np.int8)).permute(0, 1, 4, 2, 3)
    wq = _w(np.clip(np.round(w * 60), -128, 127).astype(np.int8))
    assert torch.equal(
        tmc.bank_conv_int8_inference(q5, wq, bank, listed, 0.025, 0.016),
        tmc.bank_conv_int8_inference(q5, wq, bank, idxs, 0.025, 0.016))
    h3 = torch.from_numpy(x5.reshape(3, x.shape[0], -1)[..., :40].copy())
    hq = torch.from_numpy(np.clip(np.round(x5 * 40), -128, 127).astype(
        np.int8).reshape(3, x.shape[0], -1)[..., :40].copy())
    rng = np.random.default_rng(5)
    wh = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    whq = torch.from_numpy(rng.integers(-128, 128, (40, 6), dtype=np.int8))
    hb = torch.from_numpy(_bank(40))
    assert torch.equal(tmm.bank_matmul_inference(h3, wh, hb, listed),
                       tmm.bank_matmul_inference(h3, wh, hb, idxs))
    assert torch.equal(
        tmm.bank_matmul_int8_inference(hq, whq, hb, listed, 0.025, 0.016),
        tmm.bank_matmul_int8_inference(hq, whq, hb, idxs, 0.025, 0.016))


@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_conv_vjp_equals_jax(bf16):
    """``DropoutConv``'s backward against ``jax.vjp(dropout_conv)``: the
    mask regenerated by ``mask_apply_nhwc`` (f32 scale, as JAX's), the
    conv transposes by autograd, dx and dw cast to the input dtypes. f32:
    FLOAT_RTOL of max|ref|; bf16: the transposes round to bf16, one bf16
    ulp."""
    x, w, _ = _data("same_s2", seed=4)
    rng = np.random.default_rng(5)
    _, _, _, padding, stride = GEOMS["same_s2"]
    y_shape = (2, 4, 4, w.shape[-1])
    cot = rng.normal(size=y_shape).astype(np.float32)
    jx, jw = _jx(x, bf16), _jx(w, bf16)
    _, vjp = jax.vjp(lambda a, b: jmc.dropout_conv(
        a, b, jnp.asarray(SEEDS[0]), RATE, padding, interpret=True,
        stride=stride), jx, jw)
    jdx, jdw = vjp(jnp.asarray(cot))
    dt = torch.bfloat16 if bf16 else torch.float32
    tx = _tx(x, bf16).requires_grad_(True)
    tw = _w(np.asarray(jw.astype(jnp.float32))).to(dt).requires_grad_(True)
    y = tmc.dropout_conv(tx, tw, torch.from_numpy(SEEDS[0]), RATE, padding,
                         stride)
    dx, dw = torch.autograd.grad(y, (tx, tw), _x(cot))
    assert dx.dtype == dw.dtype == dt
    rtol = BF16_RTOL if bf16 else FLOAT_RTOL
    _close(dx, jdx, rtol)
    np.testing.assert_allclose(
        dw.float().numpy().transpose(2, 3, 1, 0),
        np.asarray(jdw.astype(jnp.float32)),
        atol=rtol * np.abs(np.asarray(jdw.astype(jnp.float32))).max())
    keep = tmc.keep_mask_nchw(torch.from_numpy(SEEDS[0]), tx, RATE)
    assert bool((dx[~keep] == 0).all())


# ---------------------------------------------------------------- guards


def test_mask_coordinate_limit():
    """N·H·W must stay below 2³² (the uint32 row coordinate), as JAX
    asserts (``:238-242``)."""
    big = torch.empty(2 ** 16, 1, 2 ** 8, 2 ** 8,
                      device="meta").contiguous(
        memory_format=torch.channels_last)
    w = torch.empty(4, 1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="2\\^32"):
        tmc.dropout_conv_samples(big, w, torch.zeros(2, 2, dtype=torch.int32,
                                                     device="meta"), RATE)
    with pytest.raises(AssertionError, match="32-bit"):
        jax.eval_shape(lambda a: jmc.dropout_conv_samples(
            a, jnp.zeros((3, 3, 1, 4)), jnp.zeros((2, 2), jnp.int32), RATE,
            interpret=True), jax.ShapeDtypeStruct((2 ** 16, 2 ** 8, 2 ** 8,
                                                   1), jnp.float32))


def test_cpu_calls_launch_nothing_and_guards():
    tmc.reset_launch_counts()
    x, w, _ = _data("same_s1")
    tx, tw = _x(x), _w(w)
    seeds = torch.from_numpy(SEEDS)
    tmc.dropout_conv_inference(tx, tw, seeds, RATE)
    tmc.bank_conv_inference(tx, tw, torch.from_numpy(_bank(x.shape[-1])), 1)
    assert set(tmc.launch_counts.values()) == {0}
    with pytest.raises(ValueError, match="channels_last"):
        tmc.dropout_conv(tx.contiguous(), tw, seeds[0], RATE)
    with pytest.raises(TypeError):
        tmc.dropout_conv_int8(tx, tw, seeds[0], RATE, *STEPS)
    with pytest.raises(ValueError):               # (S, 2) seeds to the single
        tmc.dropout_conv(tx, tw, seeds, RATE)
    with pytest.raises(ValueError, match="stride"):
        tmc.dropout_conv(tx, tw, seeds[0], RATE, stride=3)
    with pytest.raises(ValueError, match="device"):
        tmc.dropout_conv(tx.to("meta"), tw.to("meta"), seeds[0].to("meta"),
                         RATE)


def test_bayes_conv_input_equals_jax():
    """``BayesConvInput``: the site's dropout in one pass,
    ``dropout_apply`` on the (N·H·W, C) view cast back to x's dtype, on the
    seeds JAX's site drew; rate 0 is the identity; the unfused site
    (``fused=False``: ``BayesianDropout``, threefry) bit-equal to the
    jitted JAX site on the key it drew."""
    from bayestpu.nn import fused as jfused
    from bayestpu_torch.nn.fused import BayesConvInput
    x, _, _ = _data("same_s1", seed=6)
    seen = []
    orig = jfused._dropout_apply

    def spy(flat, seeds, *a, **kw):
        seen.append(np.asarray(seeds))
        return orig(flat, seeds, *a, **kw)

    jfused._dropout_apply = spy
    try:
        want = jfused.BayesConvInput(rate=RATE).apply(
            {}, jnp.asarray(x, jnp.bfloat16),
            rngs={"bayes": jax.random.key(3)})
    finally:
        jfused._dropout_apply = orig
    got = BayesConvInput(RATE)(_x(x, torch.bfloat16),
                               torch.from_numpy(seen[0].astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(
        jnp.float32)))
    tx = _x(x)
    assert BayesConvInput(0.0)(tx) is tx
    keys = []
    orig_b = jax.random.bernoulli

    def spy_b(key, p, shape):
        keys.append(np.asarray(jax.random.key_data(key)).astype(np.uint32))
        return orig_b(key, p, shape)

    unfused = jfused.BayesConvInput(rate=RATE, fused=False)
    jax.random.bernoulli = spy_b
    try:
        unfused.apply({}, jnp.asarray(x), rngs={"bayes": jax.random.key(3)})
    finally:
        jax.random.bernoulli = orig_b
    want = jax.jit(lambda xx: unfused.apply(
        {}, xx, rngs={"bayes": jax.random.key(3)}))(jnp.asarray(x))
    got = BayesConvInput(RATE, fused=False)(
        tx, torch.from_numpy(keys[0].view(np.int32)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ------------------------------------------------------ BayesConv branches

BRANCHES = {
    # name: (bayes kind, fused, stride, padding, quant, train)
    "mc_fused_s2_explicit": ("mc", True, 2, ((1, 1), (1, 1)), None, False),
    "mc_fused_train": ("mc", True, 1, "SAME", None, True),
    "mc_unfused": ("mc", False, 1, "SAME", None, False),
    "mc_unfused_s3_train": ("mc", True, 3, "SAME", None, True),
    "mask_fused_s2": ("mask", True, 2, "SAME", None, False),
    "mask_unfused": ("mask", False, 1, "SAME", None, False),
    "mask_train": ("mask", True, 1, "SAME", None, True),
    "int8_det_pallas": ("none", True, 1, "SAME", "det", False),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_bayes_conv_branches_match_flax(branch):
    """``nn.fused.BayesConv`` against the Flax ``BayesConv`` on one set of
    variables, per branch: the fused MC conv at stride 2 with explicit
    padding (BN fold and relu in the epilogue) and in training, the fused
    Masksembles conv at stride 2 with asymmetric SAME (index -1), the
    unfused Masksembles row multiply, the batch split, the unfused MC site
    (``BayesianDropout`` on the threefry key JAX drew, then the conv; at
    stride 3 the JAX package routes a fused site unfused too), and a
    deterministic int8 conv through ``conv_int8_fused``
    (``int8_det_pallas``). f32: rtol/atol 1e-5 (the eager JAX site divides
    by keep where the port multiplies, one ulp); int8: bit for bit."""
    from bayestpu.core.config import BayesConfig as JB
    from bayestpu.core.config import DropoutKind as JK
    from bayestpu.core.config import QuantConfig as JQ
    from bayestpu.nn import fused as jfused
    from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                            QuantConfig)
    from bayestpu_torch.nn.fused import BayesConv
    kind, fused, stride, padding, quant, train = BRANCHES[branch]
    rng = np.random.default_rng(21)
    c, f = 40, 12
    x = rng.uniform(0, 1, size=(4, 8, 8, c)).astype(np.float32)
    jb, tb = {"mc": (JB(rate=RATE), BayesConfig(rate=RATE)),
              "mask": (JB(kind=JK.MASK, num_masks=4, scale=2.0),
                       BayesConfig(kind=DropoutKind.MASK, num_masks=4,
                                   scale=2.0)),
              "none": (JB(kind=JK.NONE), BayesConfig(kind=DropoutKind.NONE))
              }[kind]
    jq = JQ(8, 0, int8_infer=True, int8_det_pallas=True, int8_conv_min_ch=32) \
        if quant else None
    tq = QuantConfig(8, 0, int8_infer=True, int8_det_pallas=True,
                     int8_conv_min_ch=32) if quant else None
    if quant:                         # an int8 input on the grid
        x = np.round(x * 127).astype(np.int8)
    jl = jfused.BayesConv(f, strides=(stride, stride), padding=padding,
                          bayes=jb, use_bias=False, fused=fused, quant=jq)
    v = jax.tree.map(np.asarray, jl.init(
        {"params": jax.random.key(1), "bayes": jax.random.key(2)},
        jnp.asarray(x)))
    params = {"kernel": v["params"]["kernel"]}
    variables = {**v, "params": params}
    fold = None if train else (
        rng.uniform(0.5, 1.5, f).astype(np.float32),
        rng.normal(scale=0.2, size=f).astype(np.float32))
    kw = dict(act="relu", act_quant=bool(quant), sample_idx=-1)
    seen = []
    name = "dropout_conv" if train else "dropout_conv_inference"
    orig = getattr(jfused, name)
    orig_b = jax.random.bernoulli

    def spy(xx, w, seeds, *a, **k):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, *a, **k)

    def spy_b(key, p, shape):             # the unfused site's threefry key
        seen.append(np.asarray(jax.random.key_data(key)).astype(np.uint32))
        return orig_b(key, p, shape)

    setattr(jfused, name, spy)
    jax.random.bernoulli = spy_b
    try:
        want = jl.apply(variables, jnp.asarray(x), train=train,
                        fold_scale=None if fold is None else jnp.asarray(
                            fold[0]),
                        fold_bias=None if fold is None else jnp.asarray(
                            fold[1]),
                        rngs={"bayes": jax.random.key(3)}, **kw)
    finally:
        setattr(jfused, name, orig)
        jax.random.bernoulli = orig_b
    tl = BayesConv(c, f, strides=(stride, stride), padding=padding,
                   bayes=tb, fused=fused, quant=tq).train(train)
    with torch.no_grad():
        tl.kernel.copy_(torch.from_numpy(np.array(
            params["kernel"].transpose(3, 2, 0, 1))))
        if kind == "mask":
            tl.bank.copy_(torch.from_numpy(np.array(v["masks"]["bank"])))
    seeds = (torch.from_numpy(seen[0].view(np.int32) if seen[0].dtype
                              == np.uint32 else seen[0].astype(np.int32))
             if kind == "mc" else None)
    got = tl(_x(x), seeds=seeds,
             fold_scale=None if fold is None else torch.from_numpy(fold[0]),
             fold_bias=None if fold is None else torch.from_numpy(fold[1]),
             **kw)
    want = np.asarray(want)
    if quant:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- row0: one rank's images

# images [B0, B0 + NB) of a batch of N_ALL (one rank's rows of a data-sharded
# batch): the port at row0 = image_row0(B0, H, W)
N_ALL, B0, NB = 5, 2, 2


@pytest.mark.parametrize("entry", [
    "single_f32", "single_bf16", "samples_bf16", "xs_bf16", "int8",
    "int8_samples", "int8_xs", "mask_apply"])
def test_row0_images_equal_the_whole_launch(entry):
    """Row 10 (and ``mask_apply_nhwc``) at ``row0 = b0·H·W`` on images
    [b0, b0 + n) of the readout ``conv(ones, 1×1 identity)`` equals those
    images of the JAX kernel's launch on the whole batch, bit for bit: the
    mask row is JAX's ``(n0 + b)·hw + h·W + w``. The ``_xs`` entries carry
    the sample axis, sample s on its own images at the same row0."""
    h, w, c = 4, 3, 40
    row0 = tmc.image_row0(B0, h, w)
    seeds = torch.from_numpy(SEEDS)
    part = slice(B0, B0 + NB)
    int8 = entry.startswith("int8")
    bf16 = entry.endswith("bf16")
    ones = np.ones((N_ALL, h, w, c), np.int8 if int8 else np.float32)
    eye = np.eye(c, dtype=ones.dtype)[None, None]
    if entry == "mask_apply":
        want = np.asarray(jmc.mask_apply_nhwc(
            jnp.asarray(ones), jnp.asarray(SEEDS[1]), RATE, **I))[part]
        got = tmc.mask_apply_nhwc(_x(ones[part]), seeds[1], RATE, row0=row0)
        np.testing.assert_array_equal(_np(got), want)
        return
    if int8:
        jx, jw = jnp.asarray(ones), jnp.asarray(eye)
        tx, tw = _x(ones[part]), _w(eye)
        args = (RATE, *STEPS, "VALID")
        if entry == "int8":
            want = jmc.dropout_conv_int8(jx, jw, jnp.asarray(SEEDS[0]), *args,
                                         **I)
            got = tmc.dropout_conv_int8(tx, tw, seeds[0], *args, row0=row0)
        else:
            want = jmc.dropout_conv_int8_samples(jx, jw, jnp.asarray(SEEDS),
                                                 *args, **I)
            if entry == "int8_xs":
                tx = torch.stack([tx] * len(SEEDS))
            got = tmc.dropout_conv_int8_inference(tx, tw, seeds, *args,
                                                  row0=row0)
    else:
        dt = torch.bfloat16 if bf16 else torch.float32
        jx, jw = _jx(ones, bf16), _jx(eye, bf16)
        tx, tw = _x(ones[part], dt), _w(eye, dt)
        if entry.startswith("single"):
            want = jmc.dropout_conv(jx, jw, jnp.asarray(SEEDS[0]), RATE,
                                    "VALID", **I)
            got = tmc.dropout_conv(tx, tw, seeds[0], RATE, "VALID", row0=row0)
        else:
            want = jmc.dropout_conv_samples(jx, jw, jnp.asarray(SEEDS), RATE,
                                            "VALID", **I)
            if entry == "xs_bf16":
                tx = torch.stack([tx] * len(SEEDS))
            got = tmc.dropout_conv_inference(tx, tw, seeds, RATE, "VALID",
                                             row0=row0)
    want = np.asarray(jnp.asarray(want, jnp.float32))[..., part, :, :, :]
    np.testing.assert_array_equal(_np(got), want)
    assert 0 < np.count_nonzero(want) < want.size


@pytest.mark.parametrize("int8", [False, True])
def test_row0_values_at_stride_2(int8):
    """A 3×3 stride-2 SAME conv of random data with the epilogue (affine,
    relu) at ``row0``: images [b0, b0 + n) of JAX's whole-batch samples
    launch, int8 bit for bit, f32 to FLOAT_RTOL."""
    x, w, affine = _data("same_s2")
    x = np.concatenate([x, x[::-1] * 0.5, x * -1.5])[:N_ALL]
    n, h, wd, c = x.shape
    part = slice(B0, B0 + NB)
    row0 = tmc.image_row0(B0, h, wd)
    seeds = torch.from_numpy(SEEDS)
    epi = dict(bias=affine, act="relu", stride=2)
    tepi = dict(bias=torch.from_numpy(affine), act="relu", stride=2)
    if int8:
        xq, wq = _int8_data("same_s2")
        xq = np.concatenate([xq, -xq, xq[::-1]])[:N_ALL]
        want = jmc.dropout_conv_int8_samples(
            jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(SEEDS), RATE,
            *STEPS, "SAME", **I, **epi)
        got = tmc.dropout_conv_int8_samples(_x(xq[part]), _w(wq), seeds,
                                            RATE, *STEPS, "SAME", **tepi,
                                            row0=row0)
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want)[:, part])
        return
    want = jmc.dropout_conv_samples(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(SEEDS), RATE, "SAME", **I,
                                    **epi)
    got = tmc.dropout_conv_samples(_x(x[part]), _w(w), seeds, RATE, "SAME",
                                   **tepi, row0=row0)
    _close(got, np.asarray(want)[:, part])


# ------------------------------------------- row 10: the 1x1 routine's route


def test_pointwise_route_follows_the_shape_and_dtypes():
    """``takes_pointwise`` mirrors ``takes_1x1`` of masked_conv.cu: an MC
    conv of bf16 x and w with a 1x1 window, no padding and C a multiple of
    8 (at most 1024) takes the 1x1 routine at stride 1 or 2 (at stride 2
    with H even and at most 64 output columns); a larger window, padding,
    C off the multiple of 8, an f32 or mixed operand, a mask-free conv
    (``conv_fused``), int8 and every bank conv take ``conv_mma_kernel``."""
    bf = torch.bfloat16

    def takes(entry, shape, k=1, padding="SAME", stride=1, xdt=bf, wdt=bf,
              hashed=True):
        n, c, h, w = shape
        x = torch.zeros(n, c, h, w, dtype=xdt).contiguous(
            memory_format=torch.channels_last)
        wt = torch.zeros(8, c, k, k, dtype=wdt)
        g = tmc.geometry(h, w, k, k, padding, stride)
        return tmc.takes_pointwise(entry, x, wt, g, stride, hashed)

    for entry in ("masked_conv", "masked_conv_xs"):
        assert takes(entry, (2, 256, 56, 56))
        assert takes(entry, (2, 1024, 14, 14), stride=2)
        assert takes(entry, (2, 40, 8, 7), padding="VALID", stride=2)
        assert not takes(entry, (2, 40, 9, 8), stride=2)
        assert not takes(entry, (2, 40, 8, 8), k=3)
        assert not takes(entry, (2, 40, 8, 8), padding=((0, 1), (0, 1)))
        assert not takes(entry, (2, 36, 8, 8))
        assert not takes(entry, (2, 1032, 8, 8))
        assert not takes(entry, (1, 8, 4, 130), stride=2)
        assert not takes(entry, (2, 40, 8, 8), xdt=torch.float32)
        assert not takes(entry, (2, 40, 8, 8), wdt=torch.float32)
    assert not takes("masked_conv", (2, 256, 56, 56), hashed=False)
    assert not takes("masked_conv_int8", (2, 40, 8, 8), xdt=torch.int8,
                     wdt=torch.int8)
    assert not takes("bank_conv_samples", (2, 40, 8, 8))


@pytest.mark.parametrize("case", ["pointwise_s2", "patch_1x1_s2",
                                  "patch_3x3_s1", "resnet50_downsample"])
def test_mask_hashes_counts_by_hand(case):
    """``mask_hashes``, the ``conv.mask_hashes`` counter's arithmetic,
    against counts made by hand. The 1x1 routine masks each element it
    reads once a sample; ``conv_mma_kernel`` masks the in-image positions of
    every block's patch (its halo at stride 2 included) once for each
    128-channel tile of F."""
    def count(n, h, w, c, f, k, padding, stride, samples, pointwise):
        g = tmc.geometry(h, w, k, k, padding, stride)
        return tmc.mask_hashes(n, h, w, c, f, k, k, g, stride, samples,
                               pointwise)

    if case == "pointwise_s2":
        # 3 samples x 3 images x 3 x 3 output pixels x 40 channels
        assert count(3, 6, 6, 40, 10, 1, "SAME", 2, 3, True) == 3240
    elif case == "patch_1x1_s2":
        # 2 tiles of F=256 x 2 x 2 blocks of 8 x 8 outputs, each reading a
        # 15 x 15 patch inside the 32 x 32 image, x 16 channels
        assert count(1, 32, 32, 16, 256, 1, "SAME", 2, 1, False) == 28800
        # the same conv on the 1x1 routine: 16 x 16 pixels x 16 channels
        assert count(1, 32, 32, 16, 256, 1, "SAME", 2, 1, True) == 4096
    elif case == "patch_3x3_s1":
        # one block holds both images (2 x 6 x 5 outputs); its 8 x 7 patch
        # reaches past the image by the SAME pad, so the 6 x 5 pixels of
        # each image, x 33 channels, x 3 samples, one tile of F = 13
        assert count(2, 6, 5, 33, 13, 3, "SAME", 1, 3, False) == 5940
    else:
        # resnet50's stage-2 downsample (56 x 56 x 256 -> 512, stride 2,
        # batch 128, S = 10): the implicit GEMM's 4 tiles of F x 4 x 4
        # blocks whose 15-row patches keep 15, 15, 15 and 8 rows (and
        # columns) inside the image; the 1x1 routine's 28 x 28 pixels once
        old = 10 * 4 * 128 * (15 + 15 + 15 + 8) ** 2 * 256
        assert count(128, 56, 56, 256, 512, 1, "SAME", 2, 10, False) == old
        assert count(128, 56, 56, 256, 512, 1, "SAME", 2, 10, True) == (
            10 * 128 * 28 * 28 * 256)
