"""The port's threefry masks and materialized MC-dropout sites against JAX.

``core.threefry`` against ``jax.random.bits`` and ``jax.random.bernoulli``
bit for bit (odd sizes, 4-D, a leading axis of S keys; rates 0.1, 0.25,
0.3 and 1/3), and ``nn.bayes.BayesianDropout``, ``BayesianDropout2D`` and
``BayesSite``'s MC branch against the Flax layers under ``jax.jit``, the
way the JAX package's served and trained paths run them: values and
gradients bit-equal in f32 and bf16 on the key each layer drew (captured
by wrapping ``jax.random.bernoulli`` in an eager pass). The port's tensors
are NCHW where JAX's are NHWC; the inputs are random with distinct
channels, so a mask drawn in the wrong order shows.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.extend import random as jax_random

from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.nn import bayes as jbayes
from bayestpu_torch.core import threefry
from bayestpu_torch.core.config import BayesConfig
from bayestpu_torch.nn import bayes as tbayes

SHAPES = [(3, 5), (4, 1, 1, 20), (7, 13, 13, 3), (2, 9, 9, 20)]
RATES = [0.1, 0.25, 0.3, 1 / 3]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _seeds(key) -> np.ndarray:
    """The (2,) int32 seed pair of a key, as the port's sites take it."""
    return np.asarray(jax.random.key_data(key)).astype(np.uint32).view(
        np.int32)


def test_threefry_layout_needs_partitionable_keys():
    """The counter layout of ``core.threefry`` is the one of
    ``jax_threefry_partitionable=True``, the setting the JAX package's
    tests run under; another setting lays the bits out otherwise."""
    assert jax.config.jax_threefry_partitionable


def test_threefry2x32_equals_jax():
    """One block of Threefry-2x32 against
    ``jax.extend.random.threefry_2x32`` on random keys and counters."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    count = rng.integers(0, 2 ** 32, size=64, dtype=np.uint32)
    want = np.asarray(jax_random.threefry_2x32(jnp.asarray(key),
                                               jnp.asarray(count)))
    k = torch.from_numpy(key.astype(np.int64))
    c = torch.from_numpy(count.astype(np.int64))
    y0, y1 = threefry.threefry2x32(k[0], k[1], c[:32], c[32:])
    np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_equals_jax(shape):
    """``random_bits`` of one key, and of S = 3 keys in one pass."""
    keys = [jax.random.key(s) for s in (0, 7, 123456)]
    seeds = torch.from_numpy(np.stack([_seeds(k) for k in keys]))
    got = threefry.random_bits(seeds, shape)
    assert got.shape == (3,) + shape
    for s, key in enumerate(keys):
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        np.testing.assert_array_equal(got[s].numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(
            threefry.random_bits(seeds[s], shape).numpy(), want)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bernoulli_equals_jax(shape, rate):
    key = jax.random.key(11)
    want = np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape))
    got = threefry.bernoulli(torch.from_numpy(_seeds(key)), 1.0 - rate,
                             shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- the parity protocol

# the fused sites' kernel entries in ``bayestpu.nn.fused`` whose seeds a
# model-level capture records
FUSED_SITES = ("dropout_matmul_inference", "dropout_matmul_int8_inference",
               "dropout_conv_inference", "dropout_conv_int8_inference")


def capture_site_keys(model, variables, x, keys, jitted=True):
    """The JAX model's per-sample logits (S, E, B, C), from the jitted
    ``model.apply`` under each key (the form the JAX package serves; with
    ``jitted=False`` the eager one), and the seed pair of every MC site in
    call order (S, n_sites, 2) from an eager pass per key: the threefry
    key of each materialized site (a wrapper of ``jax.random.bernoulli``)
    and the seeds each fused site passes to its kernel (wrappers of
    ``FUSED_SITES``). The two convs of a deferred block site pass one
    pair, which is kept once."""
    import bayestpu.nn.fused as jfused
    seen = []
    orig_b = jax.random.bernoulli
    origs = {n: getattr(jfused, n) for n in FUSED_SITES}

    def bern(key, p, shape):
        seen.append(("threefry", _seeds(key)))
        return orig_b(key, p, shape)

    def spy(name):
        def f(xx, w, seeds, *a, **kw):
            pair = ("conv" if "conv" in name else "dense",
                    np.asarray(seeds).astype(np.int32))
            if not (pair[0] == "conv" and seen and seen[-1][0] == "conv"
                    and np.array_equal(seen[-1][1], pair[1])):
                seen.append(pair)
            return origs[name](xx, w, seeds, *a, **kw)
        return f

    out, eager = [], []
    jax.random.bernoulli = bern
    for n in FUSED_SITES:
        setattr(jfused, n, spy(n))
    try:
        for key in keys:
            seen.clear()
            eager.append(np.asarray(model.apply(
                variables, jnp.asarray(x), rngs={"bayes": key}).logits))
            out.append(np.stack([s for _, s in seen]) if seen
                       else np.zeros((0, 2), np.int32))
    finally:
        jax.random.bernoulli = orig_b
        for n, f in origs.items():
            setattr(jfused, n, f)
    if not jitted:
        return np.stack(eager), np.stack(out)
    run = jax.jit(lambda xx, k: model.apply(variables, xx,
                                            rngs={"bayes": k}).logits)
    want = np.stack([np.asarray(run(jnp.asarray(x), k).astype(jnp.float32))
                     for k in keys])
    return want, np.stack(out)


# --------------------------------------------------- materialized sites


def _flax_site(layer, x, key, grad_out=None):
    """The jitted Flax layer on x under ``key``: its output, the seed pair
    it drew (from an eager pass, by wrapping ``jax.random.bernoulli``), the
    eager output and, with ``grad_out``, the jitted VJP."""
    seen = []
    orig = jax.random.bernoulli

    def spy(k, p, shape):
        seen.append(_seeds(k))
        return orig(k, p, shape)

    def apply(xx):
        return layer.apply({}, xx, rngs={"bayes": key})

    jax.random.bernoulli = spy
    try:
        eager = np.asarray(apply(x).astype(jnp.float32))
    finally:
        jax.random.bernoulli = orig
    jitted = np.asarray(jax.jit(apply)(x).astype(jnp.float32))
    grad = None
    if grad_out is not None:
        _, vjp = jax.vjp(jax.jit(apply), x)
        grad = np.asarray(vjp(grad_out)[0].astype(jnp.float32))
    return jitted, (seen[0] if seen else None), eager, grad


def _nchw(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(a).to(dtype)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("kind,shape", [
    ("dropout", (4, 80)), ("dropout", (3, 7, 5, 20)),
    ("dropout2d", (3, 7, 5, 20))])
def test_materialized_site_equals_jitted_jax(kind, shape, rate, dtype):
    """Output and gradient bit-equal to the jitted Flax layer: the mask
    over the NHWC shape (an NCHW port tensor in ``channels_last`` memory),
    the kept values ``x · f32(1/keep)``, the VJP ``where(mask, g·c, 0)``."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jl, tl = {"dropout": (jbayes.BayesianDropout,
                          tbayes.BayesianDropout),
              "dropout2d": (jbayes.BayesianDropout2D,
                            tbayes.BayesianDropout2D)}[kind]
    want, seeds, _, want_g = _flax_site(
        jl(rate=rate), jnp.asarray(x, jdt), jax.random.key(4),
        jnp.asarray(g, jdt))
    xt = _nchw(x, tdt)
    if xt.dim() == 4:
        xt = xt.contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    y = tl(rate)(xt, torch.from_numpy(seeds))
    assert y.dtype == tdt
    np.testing.assert_array_equal(_nhwc(y), want)
    (gx,) = torch.autograd.grad(y, xt, _nchw(g, tdt))
    np.testing.assert_array_equal(_nhwc(gx), want_g)


def test_eager_jax_divides_where_the_port_multiplies():
    """Known difference: the port follows the jitted layer, where XLA-CPU
    turns ``x / keep`` into ``x · f32(1/keep)``; an eager JAX call divides
    and differs in the last bit on many f32 elements (about a third at
    rate 0.25). In bf16 both forms round to the same values."""
    x = np.random.default_rng(5).normal(size=(64, 100)).astype(np.float32)
    key = jax.random.key(6)
    for jdt, tdt in DTYPES.values():
        want, seeds, eager, _ = _flax_site(jbayes.BayesianDropout(rate=0.25),
                                           jnp.asarray(x, jdt), key)
        got = _nhwc(tbayes.BayesianDropout(0.25)(
            torch.from_numpy(x).to(tdt), torch.from_numpy(seeds)))
        np.testing.assert_array_equal(got, want)
        xj = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
        divided = np.where(eager != 0, xj / np.float32(0.75), 0.0)
        if jdt == jnp.float32:
            np.testing.assert_array_equal(eager, divided)
            assert 0.2 < np.mean(got[got != 0] != eager[got != 0]) < 0.5
        else:
            np.testing.assert_array_equal(eager, want)


def test_samples_on_a_new_axis_and_carried():
    """(S, 2) seeds give S masks on a new leading axis, sample s equal to
    the call with seeds[s]; an x that carries the sample axis gets sample
    s of x under seeds[s] on its own coordinates."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 20, 6, 6)).astype(np.float32))
    x3 = torch.from_numpy(rng.normal(size=(3, 2, 20, 6, 6)).astype(
        np.float32))
    seeds = torch.from_numpy(np.stack(
        [_seeds(jax.random.key(s)) for s in range(3)]))
    for layer in (tbayes.BayesianDropout(0.25),
                  tbayes.BayesianDropout2D(0.25)):
        many = layer(x, seeds)
        carried = layer(x3, seeds, carries_samples=True)
        assert many.shape == carried.shape == (3, 2, 20, 6, 6)
        for s in range(3):
            assert torch.equal(many[s], layer(x, seeds[s]))
            assert torch.equal(carried[s], layer(x3[s], seeds[s]))
    assert tbayes.BayesianDropout(0.0)(x, None) is x
    with pytest.raises(ValueError, match="carries"):
        tbayes.BayesianDropout(0.25)(x3, seeds[:2], carries_samples=True)


def test_bayes_site_mc_equals_jitted_jax():
    """``BayesSite``'s MC branch is ``BayesianDropout`` (child
    ``BayesianDropout_0``, no variables); at rate 0 the identity."""
    x = np.random.default_rng(8).normal(size=(3, 5, 4, 24)).astype(
        np.float32)
    want, seeds, _, _ = _flax_site(jbayes.BayesSite(JBayes(rate=0.3)),
                                   jnp.asarray(x), jax.random.key(9))
    site = tbayes.BayesSite(BayesConfig(rate=0.3), 24)
    assert site.stochastic and not site.masked
    assert list(site.named_parameters()) == []
    got = site(_nchw(x, torch.float32), 0, torch.from_numpy(seeds))
    np.testing.assert_array_equal(_nhwc(got), want)
    zero = tbayes.BayesSite(BayesConfig(rate=0.0), 24)
    xt = _nchw(x, torch.float32)
    assert not zero.stochastic and zero(xt, 0, None) is xt


# ------------------------------------------------- row0: one rank's rows


@pytest.mark.parametrize("shape,row0,rows", [
    ((8, 5), 3, 4), ((6, 3, 3, 20), 2, 3), ((4, 1, 1, 20), 1, 2)])
def test_row0_bits_are_the_global_slice(shape, row0, rows):
    """``random_bits``/``bernoulli`` at ``row0`` on ``rows`` rows are rows
    [row0, row0 + rows) of ``jax.random.bits``/``bernoulli`` over the
    global shape, bit for bit, for one key and S keys at once: the flat
    counters are the global array's."""
    keys = [jax.random.key(s) for s in (2, 31)]
    seeds = torch.from_numpy(np.stack([_seeds(k) for k in keys]))
    local = (rows,) + shape[1:]
    got = threefry.random_bits(seeds, local, row0)
    got_b = threefry.bernoulli(seeds[1], 0.7, local, row0)
    for s, key in enumerate(keys):
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        np.testing.assert_array_equal(got[s].numpy(),
                                      want[row0:row0 + rows])
    want_b = np.asarray(jax.random.bernoulli(keys[1], 0.7, shape))
    np.testing.assert_array_equal(got_b.numpy(), want_b[row0:row0 + rows])


@pytest.mark.parametrize("kind", ["dropout", "dropout2d"])
def test_row0_site_is_the_global_slice(kind):
    """A materialized site on images [2, 5) of a batch of 6 (one rank's
    rows, ``nn.rows``) equals those images of the jitted Flax layer on the
    whole batch, bit for bit."""
    from bayestpu_torch.engine.sharding import at_rows
    from bayestpu_torch.nn.rows import Rows
    x = np.random.default_rng(12).normal(size=(6, 5, 4, 20)).astype(
        np.float32)
    jl, tl = {"dropout": (jbayes.BayesianDropout, tbayes.BayesianDropout),
              "dropout2d": (jbayes.BayesianDropout2D,
                            tbayes.BayesianDropout2D)}[kind]
    want, seeds, _, _ = _flax_site(jl(rate=0.3), jnp.asarray(x),
                                   jax.random.key(21))
    site = tl(0.3)
    with at_rows(site, Rows(2, 6)):
        got = site(_nchw(x[2:5], torch.float32), torch.from_numpy(seeds))
    assert site.rows == Rows()
    np.testing.assert_array_equal(_nhwc(got), want[2:5])
