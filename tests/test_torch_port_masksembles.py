"""The port's Masksembles path against the JAX package's, on the CPU.

- ``nn.bayes``: ``Masksembles`` and ``BayesSite`` against the Flax modules
  (train split, eval row, (B, C) and NHWC inputs, the bank the Flax init
  draws).
- ``BayesDense`` with ``kind=MASK`` against Flax's: fused eval (one mask,
  and every mask at once as the JAX vmap rule runs them), unfused eval,
  training (forward and gradients against ``jax.vjp``), the fake-quant and
  the int8 head; a bf16 ``dtype`` still computes in f32.
- The full-width Masksembles ``vgg11_me`` (``BayesConfig(kind=MASK,
  num_masks=4, scale=2.0)``) on the JAX init variables with BatchNorm
  perturbed, its ``masks`` collection loaded through
  ``load_flax_variables``: per-mask logits in f32 and bf16, spatial equal
  to temporal, ``BayesEngine.predict`` (and ``sample_idx``) against the
  JAX engine's, the int8 model's logits bit-equal to JAX's int8 model's,
  the variables' round trip, one f32 training step against
  ``jax.value_and_grad``, and the training and serving entry points.

The JAX bank kernels run in the Pallas interpreter (as the JAX package's
own tests run them on the CPU); the port's wrappers take their plain
versions because the tensors lie on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import DropoutKind as JKind
from bayestpu.core.config import QuantConfig as JQuant
from bayestpu.engine.engine import BayesEngine as JEngine
from bayestpu.nn import bayes as jbayes
from bayestpu.nn import fused as jfused
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu.train.losses import eed_loss as jax_eed_loss
from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                        EngineConfig, QuantConfig,
                                        SamplingMode)
from bayestpu_torch.core.rng import sample_seeds, step_seeds
from bayestpu_torch.data.datasets import get_dataset, iterate_batches
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.kernels import masked_matmul as tmm
from bayestpu_torch.nn import bayes as tbayes
from bayestpu_torch.nn.fused import BayesDense
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.losses import eed_loss
from bayestpu_torch.train.loop import (bn_reestimate, create_state,
                                       make_train_step, train_loop)
from bayestpu_torch.train.optim import get_optimizer, get_recipe

from port_threads import thread_budget  # noqa: F401

MASK = BayesConfig(kind=DropoutKind.MASK, num_masks=4, scale=2.0)
JMASK = JBayes(kind=JKind.MASK, num_masks=4, scale=2.0)
Q8, INT8_Q = QuantConfig(8, 0), QuantConfig(8, 0, int8_infer=True)
JQ8, JINT8_Q = JQuant(8, 0), JQuant(8, 0, int8_infer=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
S = 4


def _rel(got, want):
    """max |got - want| over max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _norm_err(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------- nn.bayes


@pytest.mark.parametrize("shape", [(8, 64), (4, 3, 3, 32)])
def test_masksembles_matches_flax(shape):
    """The bank equals the Flax init's; eval multiplies by row
    ``sample_idx % 4`` (negative and wrapping indices included), train
    splits the batch into four groups, one row each."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jl = jbayes.Masksembles(num_masks=4, scale=2.0)
    v = jax.tree.map(np.asarray, jl.init(jax.random.key(0), jnp.asarray(x)))
    tl = tbayes.Masksembles(shape[-1], 4, 2.0)
    np.testing.assert_array_equal(tl.bank.numpy(), v["masks"]["bank"])
    assert list(dict(tl.named_parameters())) == []
    xt = torch.from_numpy(x)
    tl.eval()
    for i in (0, 2, -1, 6):
        want = np.asarray(jl.apply(v, jnp.asarray(x), sample_idx=i))
        np.testing.assert_array_equal(tl(xt, i).numpy(), want)
    spatial = tl(xt, torch.tensor([0, 2, -1, 6]))
    for s, i in enumerate((0, 2, -1, 6)):
        assert torch.equal(spatial[s], tl(xt, i))
    tl.train()
    want = np.asarray(jl.apply(v, jnp.asarray(x), train=True))
    np.testing.assert_array_equal(tl(xt).numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        tl(xt[:3])


def test_masksembles_bf16_input_promotes_to_f32():
    x = np.random.default_rng(2).normal(size=(4, 32)).astype(np.float32)
    jl = jbayes.Masksembles(num_masks=4, scale=2.0)
    v = jl.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jl.apply(v, jnp.asarray(x, jnp.bfloat16), sample_idx=1))
    got = tbayes.Masksembles(32).eval()(torch.from_numpy(x).bfloat16(), 1)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bayes_site_dispatch():
    x = np.random.default_rng(3).normal(size=(8, 48)).astype(np.float32)
    js = jbayes.BayesSite(JMASK)
    v = jax.tree.map(np.asarray, js.init(jax.random.key(0), jnp.asarray(x)))
    ts = tbayes.BayesSite(MASK, 48).eval()
    load_flax_variables(ts, v)
    np.testing.assert_array_equal(
        ts(torch.from_numpy(x), 3).numpy(),
        np.asarray(js.apply(v, jnp.asarray(x), sample_idx=3)))
    none = tbayes.BayesSite(BayesConfig(kind=DropoutKind.NONE), 48)
    xt = torch.from_numpy(x)
    assert none(xt, 1) is xt
    # MC: the identity at rate 0; at rate 0.25 BayesianDropout, equal to
    # the jitted JAX site on the key it drew
    assert tbayes.BayesSite(BayesConfig(rate=0.0), 48)(xt, 1) is xt
    keys = []
    orig = jax.random.bernoulli

    def spy(key, p, shape):
        keys.append(np.asarray(jax.random.key_data(key)).astype(np.uint32))
        return orig(key, p, shape)

    mc = jbayes.BayesSite(JBayes(rate=0.25))
    jax.random.bernoulli = spy
    try:
        mc.apply({}, jnp.asarray(x), rngs={"bayes": jax.random.key(1)})
    finally:
        jax.random.bernoulli = orig
    want = jax.jit(lambda xx: mc.apply(
        {}, xx, rngs={"bayes": jax.random.key(1)}))(jnp.asarray(x))
    got = tbayes.BayesSite(BayesConfig(rate=0.25), 48)(
        xt, 3, torch.from_numpy(keys[0].view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ BayesDense


def _dense_case(in_features=64, batch=8, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, in_features)).astype(np.float32)
    params = {"kernel": rng.normal(scale=0.2, size=(in_features, 10)).astype(
        np.float32), "bias": rng.normal(scale=0.1, size=10).astype(np.float32)}
    return x, params


def _port_dense(params, **kw):
    head = BayesDense(params["kernel"].shape[0], 10, bayes=MASK, **kw)
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(params["kernel"]))
        head.bias.copy_(torch.from_numpy(params["bias"]))
    return head.eval()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_bank_dense_eval_matches_flax(name, fused):
    """One mask at a time and every mask at once (the JAX vmap over
    ``sample_idx``, one samples kernel): f32 results to 1e-6 of max|ref|
    in both dtypes, because the family never casts to ``dtype``."""
    jdt, tdt = DTYPES[name]
    x, params = _dense_case()
    jl = jfused.BayesDense(10, bayes=JMASK, fused=fused, dtype=jdt)
    masks = jax.tree.map(np.asarray, jl.init(
        jax.random.key(0), jnp.asarray(x)))["masks"]
    v = {"params": params, "masks": masks}
    head = _port_dense(params, fused=fused, dtype=tdt)
    np.testing.assert_array_equal(head.bank.numpy(), masks["bank"])
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    idxs = jnp.asarray([0, 1, 2, 3, -1, 9], jnp.int32)
    want = np.asarray(jax.vmap(lambda i: jl.apply(v, jx, sample_idx=i))(idxs))
    with torch.inference_mode():
        got = head(tx, sample_idx=torch.from_numpy(np.array(idxs)))
        assert got.dtype == torch.float32 and got.shape == (6, 8, 10)
        assert _rel(got, want) <= 1e-6
        for s, i in enumerate(np.asarray(idxs)):
            one = head(tx, sample_idx=int(i))
            assert _rel(one, np.asarray(jl.apply(v, jx, sample_idx=int(i)))) \
                <= 1e-6
            if fused:      # rows 8 and 9 are one kernel
                assert torch.equal(one, got[s])
        assert torch.equal(head(tx), head(tx, sample_idx=0))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_bank_dense_train_matches_flax(name):
    """The batch-split branch (unfused, as in JAX): output and the
    gradients of x, kernel and bias against ``jax.vjp`` to 1e-6 of their
    norm (f32 sums in another order); the bank gets no gradient."""
    jdt, tdt = DTYPES[name]
    x, params = _dense_case(batch=12)
    cot = np.random.default_rng(5).normal(size=(12, 10)).astype(np.float32)
    jl = jfused.BayesDense(10, bayes=JMASK, dtype=jdt)
    masks = jl.init(jax.random.key(0), jnp.asarray(x))["masks"]
    want, vjp = jax.vjp(lambda p, xx: jl.apply(
        {"params": p, "masks": masks}, xx, train=True), params,
        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    head = _port_dense(params, dtype=tdt).train()
    xt = torch.from_numpy(x).requires_grad_()
    got = head(xt)
    gx, gk, gb = torch.autograd.grad(got, [xt, head.kernel, head.bias],
                                     torch.from_numpy(cot))
    for g, w in ((got.detach(), want), (gx, jgx), (gk, jgp["kernel"]),
                 (gb, jgp["bias"])):
        assert _norm_err(g.numpy(), np.asarray(w)) <= 1e-6
    assert not head.bank.requires_grad
    with pytest.raises(ValueError, match="divisible"):
        head(xt[:10])


@pytest.mark.parametrize("int8_infer", [False, True])
def test_bank_dense_quantized_matches_flax(int8_infer):
    """The fake-quant head (fake-quantized kernel and bias, f32 bank
    product) to 1e-6; the int8 head (x and kernel on the int8 grid,
    ``bank_matmul_int8_inference``) bit for bit, one mask and all masks."""
    x, params = _dense_case(seed=6)
    jq, tq = (JINT8_Q, INT8_Q) if int8_infer else (JQ8, Q8)
    jl = jfused.BayesDense(10, bayes=JMASK, quant=jq)
    masks = jl.init(jax.random.key(0), jnp.asarray(x))["masks"]
    v = {"params": params, "masks": masks}
    head = _port_dense(params, quant=tq)
    idxs = jnp.asarray([3, 0, -2], jnp.int32)
    want = np.asarray(jax.vmap(lambda i: jl.apply(
        v, jnp.asarray(x), sample_idx=i))(idxs))
    with torch.inference_mode():
        got = head(torch.from_numpy(x), sample_idx=torch.tensor([3, 0, -2]))
        one = head(torch.from_numpy(x), sample_idx=-2)
    if int8_infer:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(one.numpy(), want[2])
    else:
        assert _rel(got, want) <= 1e-6


# --------------------------------------------------------- vgg11_me


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("mean", "bias"):
            out[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = (v * rng.uniform(0.5, 1.5, size=v.shape)).astype(
                np.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def mask_vars():
    """JAX Masksembles vgg11_me init variables (BatchNorm perturbed, the
    banks as drawn) and an input batch of 2."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("vgg11_me", bayes=JMASK, fused=True)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    return x, {"params": _perturb(v["params"], rng),
               "batch_stats": _perturb(v["batch_stats"], rng),
               "masks": v["masks"]}


def _port(variables, dtype=torch.float32, quant=None, fused=True):
    model = get_model("vgg11_me", bayes=MASK, fused=fused, dtype=dtype,
                      quant=quant)
    return load_flax_variables(model, variables).eval()


def _jax_logits(variables, x, dtype=jnp.float32, quant=None):
    """(S, E, B, C): JAX's per-mask logits, one apply per mask index."""
    jm = jax_get_model("vgg11_me", bayes=JMASK, fused=True, dtype=dtype,
                       quant=quant)
    return np.stack([np.asarray(jm.apply(variables, jnp.asarray(x),
                                         sample_idx=i).logits)
                     for i in range(S)])


def test_masksembles_vgg_structure(mask_vars):
    """Five Masksembles heads and no MC site; the banks are the JAX init's
    and are buffers of the ``masks`` collection, not parameters."""
    _, variables = mask_vars
    model = _port(variables)
    assert model.num_sites == 0 and model.masked
    heads = [model.exit1.linear, model.exit2.linear, model.exit3.linear,
             model.exit4.linear, model.classifier]
    assert all(h.masked and h.site is None for h in heads)
    for name in ("exit1.linear", "exit4.linear", "classifier"):
        path = name.split(".")
        want = variables["masks"]
        for p in path:
            want = want[p]
        np.testing.assert_array_equal(
            dict(model.named_buffers())[f"{name}.bank"].numpy(),
            want["bank"])
    assert not any(n.endswith("bank") for n, _ in model.named_parameters())
    # every head shares BANK_SEED and width 512, so one bank, as in JAX
    assert torch.equal(heads[0].bank, heads[-1].bank)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_masksembles_vgg_logits_match_jax(mask_vars, name):
    """Per-mask logits (S=4). f32: summation order only (measured ~1e-6
    of max|ref|), held to 1e-5 of it. bf16: the backbone's bf16 convs
    round at other points in XLA and oneDNN (rtol/atol 0.02, as the MC
    model's test in ``test_torch_port_vgg.py``), while the heads compute
    in f32 in both. Spatial equals temporal bit for bit."""
    x, variables = mask_vars
    jdt, tdt = DTYPES[name]
    want = _jax_logits(variables, x, jdt)
    model = _port(variables, tdt)
    xt, seeds = torch.from_numpy(x), sample_seeds(0, S, 0)
    assert seeds.shape == (S, 0, 2)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, seeds)
        temporal = tsampler.mc_logits(model, xt, seeds,
                                      SamplingMode.TEMPORAL)
    assert spatial.shape == (S, 5, 2, 10) and spatial.dtype == torch.float32
    if name == "f32":
        assert _rel(spatial, want) <= 1e-5
    else:
        np.testing.assert_allclose(spatial.numpy(), want, rtol=0.02,
                                   atol=0.02)
    assert torch.equal(spatial, temporal)
    # the masks matter: the samples differ
    assert not torch.equal(spatial[0], spatial[1])


def test_masksembles_vgg_unfused_equals_fused(mask_vars):
    """fused=False runs ``(x · row) @ kernel`` in PyTorch: the same values
    as the bank kernels' plain versions to f32 summation order."""
    x, variables = mask_vars
    xt, seeds = torch.from_numpy(x), sample_seeds(0, S, 0)
    with torch.inference_mode():
        a = tsampler.mc_logits(_port(variables), xt, seeds)
        b = tsampler.mc_logits(_port(variables, fused=False), xt, seeds)
    assert _rel(b, a.numpy()) <= 1e-6


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_masksembles_int8_logits_equal_jax(mask_vars, name):
    """The int8 Masksembles model (INT8_Q, no QAT, as ``bench.py:734-739``
    serves it): int8 activations, int8 convs, the int8 bank heads; its
    per-mask logits equal JAX's int8 model's bit for bit (the int32 sums
    are exact and the float-branch convs take grid values; measured 0.0 in
    both dtypes), spatial equals temporal."""
    x, variables = mask_vars
    jdt, tdt = DTYPES[name]
    want = _jax_logits(variables, x, jdt, quant=JINT8_Q)
    model = _port(variables, tdt, quant=INT8_Q)
    xt, seeds = torch.from_numpy(x), sample_seeds(0, S, 0)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, seeds)
        temporal = tsampler.mc_logits(model, xt, seeds,
                                      SamplingMode.TEMPORAL)
    np.testing.assert_array_equal(spatial.numpy(), want)
    assert torch.equal(spatial, temporal)


def test_masksembles_engine_matches_jax(mask_vars):
    """``BayesEngine.predict`` runs S = num_masks = 4 whatever
    ``num_samples`` says (``sampler.py:133-140``); its predictive, and
    ``predict(sample_idx=i)`` (the fork's ``predict(x, mask_index=i)``),
    against the JAX engine's on the same variables, to 1e-5."""
    x, variables = mask_vars
    jeng = JEngine(jax_get_model("vgg11_me", bayes=JMASK, fused=True),
                   bayes=JMASK).attach(variables)
    want = jeng.predict(jnp.asarray(x))
    eng = BayesEngine(_port(variables), device="cpu").attach(variables)
    got = eng.predict(x, num_samples=10)
    assert got.num_samples == S
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(want.entropy),
                               rtol=1e-5, atol=1e-6)
    logits = tsampler.mc_logits(eng.model, torch.from_numpy(x),
                                sample_seeds(0, S, 0))
    for i in (0, 3, 5):
        one = eng.predict(x, sample_idx=i)
        np.testing.assert_allclose(
            one.numpy(), np.asarray(jeng.predict(jnp.asarray(x),
                                                 sample_idx=i)),
            rtol=1e-5, atol=1e-6)
        assert torch.equal(one, torch.softmax(logits[i % S], dim=-1))
    with pytest.raises(ValueError, match=">= 0"):
        eng.predict(x, sample_idx=-1)
    tm = BayesEngine(eng.model, config=EngineConfig(
        mode=SamplingMode.TEMPORAL), device="cpu").attach(variables)
    np.testing.assert_allclose(tm.predict(x).probs.numpy(),
                               got.probs.numpy(), rtol=1e-6, atol=1e-7)


def test_masksembles_evaluate_with_ood_check(mask_vars):
    x, variables = mask_vars
    eng = BayesEngine(_port(variables), device="cpu").attach(variables)
    mets = eng.evaluate(x, np.array([1, 7]), ood_check=True,
                        dataset="cifar10")
    assert set(mets) == {"acc", "nll", "mse", "ece_hist", "ece_ew10", "aPE",
                         "aPE_ood"}
    assert all(np.isfinite(v) for v in mets.values())


def test_masks_collection_round_trip_and_refusals(mask_vars):
    """``to_flax_variables`` emits ``masks`` and inverts
    ``load_flax_variables``; an MC model refuses a ``masks`` collection, a
    Masksembles model refuses a tree without one (the banks are missing
    names) or with a bank of the wrong shape; BN re-estimation leaves the
    banks out of the statistics it returns."""
    x, variables = mask_vars
    model = _port(variables)
    back = to_flax_variables(model)
    assert set(back) == {"params", "batch_stats", "masks"}
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(
                                     variables)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    mc = get_model("vgg11_me", bayes=BayesConfig(rate=0.25), fused=True)
    with pytest.raises(KeyError, match="masks"):
        load_flax_variables(mc, variables)
    assert "masks" not in to_flax_variables(mc)
    no_masks = {k: v for k, v in variables.items() if k != "masks"}
    with pytest.raises(KeyError, match="exit1.linear.bank"):
        load_flax_variables(get_model("vgg11_me", bayes=MASK, fused=True),
                            no_masks)
    bad = jax.tree.map(lambda a: a, variables)
    bad["masks"]["classifier"]["bank"] = np.zeros((3, 512), np.float32)
    with pytest.raises(ValueError, match="classifier"):
        load_flax_variables(get_model("vgg11_me", bayes=MASK, fused=True),
                            bad)
    stats = bn_reestimate(model, [np.concatenate([x, x])],
                          step_seeds(0, 0, 0), passes=1)
    assert stats and not any(k.endswith("bank") for k in stats)


# --------------------------------------------------------------- training


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# fc_0 feeds fc_bn_0, a batch-statistics BatchNorm, so its bias gradient is
# zero in exact arithmetic and only rounding in both packages
ZERO_GRAD = {"fc_0.bias"}


def test_masksembles_train_step_matches_jax(mask_vars):
    """One f32 step at batch 4 (one image per mask): the loss to 1e-6 and
    every gradient by name to 3e-4 of its norm (the MC step's standard: f32
    summation order, amplified by the batch statistics at batch 4), the
    ZERO_GRAD leaves below 1e-8 of the whole gradient's norm. The
    step draws no random numbers, so no seeds are captured. A batch of 6
    does not split into four groups and raises."""
    _, variables = mask_vars
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 3, 7, 3], np.int32)
    jm = jax_get_model("vgg11_me", bayes=JMASK, fused=True)

    def loss_fn(params):
        o, _ = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"],
                         "masks": variables["masks"]}, jnp.asarray(x),
                        train=True, mutable=["batch_stats"])
        return jax_eed_loss(o.logits, jnp.asarray(y), o.features)

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = _flat(jax.tree.map(np.asarray, jgrads))
    model = load_flax_variables(get_model("vgg11_me", bayes=MASK,
                                          fused=True), variables).train()
    params = dict(model.named_parameters())
    seeds = step_seeds(0, 0, model.num_sites)
    assert seeds.shape == (0, 2)
    out = model(torch.from_numpy(x), seeds)
    loss = eed_loss(out.logits, torch.from_numpy(y), out.features)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    assert set(params) == set(want)
    total = np.sqrt(sum(np.linalg.norm(v) ** 2 for v in want.values()))
    for name, g in zip(params, grads):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        if name in ZERO_GRAD:
            assert np.linalg.norm(g) < 1e-8 * total, name
        else:
            assert _norm_err(g, want[name]) <= 3e-4, (
                name, _norm_err(g, want[name]))
    with pytest.raises(ValueError, match="divisible"):
        model(torch.from_numpy(np.concatenate([x, x[:2]])), seeds)


def test_masksembles_trains_through_the_entry_points():
    """``create_state``, ``make_train_step`` and ``train_loop`` with zero
    MC sites: (0, 2) step seeds, the optimizer sees parameters only (the
    bank neither moves nor enters the optimizer state), and the trained
    variables carry the banks to ``BayesEngine.attach``."""
    ds = get_dataset("cifar10", data_dir="/nonexistent", n_synth_train=16,
                     n_synth_test=8)
    model = get_model("vgg11_me", bayes=MASK, fused=True)
    tx = get_optimizer(get_recipe("vgg19", lr=0.01, t_max=2), 2)
    state = create_state(model, tx, 0, ds.x_train[:8], device="cpu")
    bank = model.classifier.bank.clone()
    assert not any(k.endswith("bank") for k, _ in model.named_parameters())
    m = make_train_step(model, tx)(
        state, torch.from_numpy(ds.x_train[:8]),
        torch.from_numpy(ds.y_train[:8]).long(), step_seeds(0, 0, 0))
    assert np.isfinite(float(m["loss"])) and state.step == 1
    hist = {}
    train_loop(model, state, tx,
               lambda: iterate_batches(ds.x_train, ds.y_train, 8, seed=1), 0,
               1, val_batches=lambda: iterate_batches(
                   ds.x_test, ds.y_test, 4, shuffle=False),
               history=hist, log_fn=lambda msg: None)
    assert state.step == 3 and len(hist["val_metric"]) == 1
    assert torch.equal(model.classifier.bank, bank)
    variables = state.variables()
    assert "masks" in variables
    eng = BayesEngine(get_model("vgg11_me", bayes=MASK, fused=True),
                      device="cpu").attach(variables)
    pred = eng.predict(ds.x_test[:4])
    assert pred.probs.shape == (5, 4, 10) and pred.num_samples == S
