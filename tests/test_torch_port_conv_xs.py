"""The port's masked conv on an x that carries the sample axis, against the
JAX package's vmap over (x, seeds), on the CPU.

``dropout_conv_inference`` and ``dropout_conv_int8_inference`` with x of
(S, N, C, H, W) and seeds (S, 2) mask sample s of x with seeds[s] on its
own coordinates: JAX's custom vmap rule (``masked_conv.py:732-748`` and
``:962-978``) sends such a call to its ``lax.map`` fallback, one single
kernel per sample. On the card the port makes one ``_xs`` launch for the S
samples; here, on the CPU, it runs the single plain version per sample,
and this file holds that against JAX with the Pallas kernels in the
interpreter (``interpret=True``), on numpy inputs made from a seed.
``chip_smoke.py`` holds the ``_xs`` kernels against the same plain path
on the card, and each of their samples against the single launch.

Tolerances as in ``test_torch_port_conv.py``: int8 results bit for bit
(exact int32 sums, then the same f32 multiplies and adds); f32 results to
FLOAT_RTOL of max|ref| (exact products, f32 sums in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.kernels import masked_conv as jmc
from bayestpu_torch.kernels import masked_conv as tmc

from port_threads import thread_budget  # noqa: F401

RATE = 0.25
FLOAT_RTOL = 1e-5
STEPS = (2.0 ** -7, 2.0 ** -6)
# x NHWC of one sample, kernel size, F, padding, stride: SAME at stride 1,
# SAME at stride 2 (asymmetric: 8 -> 4 pads (0, 1)), explicit asymmetric
# pairs at stride 2; F not a multiple of 8
GEOMS = {
    "same_s1": ((2, 6, 5, 33), 3, 13, "SAME", 1),
    "same_s2": ((2, 8, 8, 34), 3, 12, "SAME", 2),
    "explicit_s2": ((2, 9, 7, 35), 3, 11, ((2, 1), (0, 2)), 2),
}
# one seed pair per sample of x, the first negative
SEEDS = np.array([[-123456789, -7], [5, 99], [2 ** 31 - 1, 0]], np.int32)
S = len(SEEDS)


def _data(name, seed=0):
    shape, k, f, _, _ = GEOMS[name]
    rng = np.random.default_rng(seed)
    x5 = rng.normal(size=(S,) + shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], f))
         / np.sqrt(k * k * shape[-1])).astype(np.float32)
    affine = np.stack([rng.uniform(0.5, 1.5, f),
                       rng.normal(scale=0.3, size=f)]).astype(np.float32)
    x5q = rng.integers(-128, 128, size=(S,) + shape).astype(np.int8)
    wq = rng.integers(-128, 128, size=(k, k, shape[-1], f)).astype(np.int8)
    return x5, w, affine, x5q, wq


def _x5(a, dtype=None):
    """(S, N, H, W, C) numpy -> (S, N, C, H, W) torch, each sample in
    channels_last memory and the samples outermost (``stack_samples``'s
    layout, which the _xs kernels read)."""
    t = torch.from_numpy(np.array(a)).permute(0, 1, 4, 2, 3)
    return t if dtype is None else t.to(dtype)


def _w(a, dtype=None):
    t = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1)))
    return t if dtype is None else t.to(dtype)


def _np(t):
    """(S, N, F, Ho, Wo) -> (S, N, Ho, Wo, F) numpy."""
    t = t.detach().permute(0, 1, 3, 4, 2)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = _np(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FLOAT_RTOL * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_float_xs_equals_jax_vmap(geom, bf16):
    """Float x (f32 or bf16) carrying S samples, with the (2, F) affine and
    relu, f32 out: equal to JAX's vmap over (x, seeds) within FLOAT_RTOL;
    sample s bit-equal to the single call on x[s] with seeds[s]; no
    launch counted on the CPU."""
    x5, w, affine, _, _ = _data(geom)
    _, _, _, padding, stride = GEOMS[geom]
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx, jw = jnp.asarray(x5, jdt), jnp.asarray(w, jdt)
    tdt = torch.bfloat16 if bf16 else torch.float32
    tx = _x5(np.asarray(jx.astype(jnp.float32)), tdt)
    tw = _w(np.asarray(jw.astype(jnp.float32)), tdt)
    want = jax.vmap(lambda xs, sd: jmc.dropout_conv_inference(
        xs, jw, sd, RATE, padding, interpret=True,
        bias=jnp.asarray(affine), act="relu", stride=stride))(
        jx, jnp.asarray(SEEDS))
    tkw = dict(bias=torch.from_numpy(affine), act="relu", stride=stride)
    tmc.reset_launch_counts()
    got = tmc.dropout_conv_inference(tx, tw, torch.from_numpy(SEEDS), RATE,
                                     padding, **tkw)
    assert set(tmc.launch_counts.values()) == {0}
    assert got.dtype == torch.float32 and got.shape[0] == S
    _close(got, want)
    for s in range(S):
        assert torch.equal(got[s], tmc.dropout_conv_inference(
            tx[s], tw, torch.from_numpy(SEEDS[s]), RATE, padding, **tkw))


@pytest.mark.parametrize("epi", ["affine_relu_int8", "bias_f32"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_int8_xs_equals_jax_vmap(geom, epi):
    """int8 x carrying S samples, bit-equal to JAX's vmap over (x_q,
    seeds): with the BN affine, relu and an int8 store, and with an (F,)
    bias and an f32 store; sample s bit-equal to the single call; no
    launch counted on the CPU."""
    _, _, affine, x5q, wq = _data(geom)
    _, _, _, padding, stride = GEOMS[geom]
    if epi == "affine_relu_int8":
        jkw = dict(bias=jnp.asarray(affine), act="relu", out_step=STEPS[0])
        tkw = dict(bias=torch.from_numpy(affine), act="relu",
                   out_step=STEPS[0])
    else:
        jkw = dict(bias=jnp.asarray(affine[1]))
        tkw = dict(bias=torch.from_numpy(affine[1]))
    want = np.asarray(jax.vmap(lambda xs, sd: jmc.dropout_conv_int8_inference(
        xs, jnp.asarray(wq), sd, RATE, *STEPS, padding, interpret=True,
        stride=stride, **jkw))(jnp.asarray(x5q), jnp.asarray(SEEDS)))
    tmc.reset_launch_counts()
    got = tmc.dropout_conv_int8_inference(
        _x5(x5q), _w(wq), torch.from_numpy(SEEDS), RATE, *STEPS, padding,
        stride=stride, **tkw)
    assert set(tmc.launch_counts.values()) == {0}
    assert got.dtype == (torch.int8 if "int8" in epi else torch.float32)
    np.testing.assert_array_equal(_np(got), want)
    for s in (0, 2):
        one = tmc.dropout_conv_int8_inference(
            _x5(x5q)[s], _w(wq), torch.from_numpy(SEEDS[s]), RATE, *STEPS,
            padding, stride=stride, **tkw)
        assert torch.equal(got[s], one)


def test_xs_masks_each_sample_on_its_own_rows():
    """The mask of sample s is that of the single call on x[s] (local
    coordinates), not of S·N images folded into one batch: the readout
    ``conv(ones, 1×1 identity)`` of every sample equals the single
    readout with its seed pair, and the folded call differs."""
    ones = np.ones((S, 2, 5, 4, 40), np.float32)
    eye = np.eye(40, dtype=np.float32)[None, None]
    got = tmc.dropout_conv_inference(_x5(ones), _w(eye),
                                     torch.from_numpy(SEEDS), RATE, "VALID")
    for s in range(S):
        one = tmc.dropout_conv_inference(_x5(ones)[s], _w(eye),
                                         torch.from_numpy(SEEDS[s]), RATE,
                                         "VALID")
        assert torch.equal(got[s], one)
    folded = tmc.dropout_conv_inference(
        _x5(ones).flatten(0, 1), _w(eye), torch.from_numpy(SEEDS[1]), RATE,
        "VALID")[2:4]
    assert not torch.equal(got[1], folded)


def test_xs_rate_zero_and_int8_without_mask():
    """Rate 0: the float entry takes the reference conv per sample, the
    int8 one masks nothing; both equal JAX's vmap."""
    x5, w, affine, x5q, wq = _data("same_s2", seed=4)
    want = jax.vmap(lambda xs, sd: jmc.dropout_conv_inference(
        xs, jnp.asarray(w), sd, 0.0, "SAME", interpret=True,
        bias=jnp.asarray(affine[1]), act="relu", stride=2))(
        jnp.asarray(x5), jnp.asarray(SEEDS))
    got = tmc.dropout_conv_inference(
        _x5(x5), _w(w), torch.from_numpy(SEEDS), 0.0, "SAME",
        bias=torch.from_numpy(affine[1]), act="relu", stride=2)
    _close(got, want)
    want8 = np.asarray(jax.vmap(lambda xs, sd: jmc.dropout_conv_int8_inference(
        xs, jnp.asarray(wq), sd, 0.0, *STEPS, "SAME", interpret=True,
        stride=2))(jnp.asarray(x5q), jnp.asarray(SEEDS)))
    got8 = tmc.dropout_conv_int8_inference(
        _x5(x5q), _w(wq), torch.from_numpy(SEEDS), 0.0, *STEPS, "SAME",
        stride=2)
    np.testing.assert_array_equal(_np(got8), want8)


def test_xs_guards():
    """What the _xs entries refuse: a sample axis whose samples are not
    outermost in channels_last memory, a seed count other than S, and
    (S, 2) seeds with a single sample's x in a 5-D call."""
    x5, w, _, x5q, wq = _data("same_s1")
    seeds = torch.from_numpy(SEEDS)
    nchw = torch.from_numpy(x5).permute(0, 1, 4, 2, 3).contiguous()
    with pytest.raises(ValueError, match="channels_last"):
        tmc.dropout_conv_inference(nchw, _w(w), seeds, RATE)
    with pytest.raises(ValueError, match="carries"):
        tmc.dropout_conv_inference(_x5(x5), _w(w), seeds[:2], RATE)
    with pytest.raises(ValueError, match="carries"):
        tmc.dropout_conv_int8_inference(_x5(x5q), _w(wq), seeds[:2], RATE,
                                        *STEPS)
    with pytest.raises(ValueError):
        tmc.dropout_conv_inference(_x5(x5), _w(w), seeds[0], RATE)
