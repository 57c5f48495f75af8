"""The port's vgg11_me against the JAX package's, at full width on the CPU.

Both models get the same weights: the JAX init variables, with the
BatchNorm parameters and running statistics perturbed (numpy, seeded) so
the inference fold is exercised, loaded into the port through
``interop.from_flax``. The MC comparison feeds the port the seeds each JAX
``BayesDense`` passes to its kernel, captured by a test-local wrapper of
``bayestpu.nn.fused.dropout_matmul_inference`` while ``model.apply`` runs
once per sample key outside jit (the JAX kernels run in the Pallas
interpreter on the CPU).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.nn.fused as jfused
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import DropoutKind as JKind
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu_torch.core.config import BayesConfig, DropoutKind
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.nn.zoo import available_models, get_model
from port_threads import thread_budget  # noqa: F401
from test_torch_port_threefry import capture_site_keys

RATE = 0.25
S = 2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32: only summation order differs (measured ~1e-6 on logits of ~1.4).
# bf16: convs round to bf16 at other points in XLA and oneDNN (measured
# ~5e-3 on logits of ~1.4).
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=0.02, atol=0.02)}


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
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    variables = {"params": _perturb(v["params"], rng),
                 "batch_stats": _perturb(v["batch_stats"], rng)}
    return x, variables


def _capture(model, variables, x, key, num_samples):
    """Per-sample JAX logits (S, E, B, C) and the seeds every site passed to
    its kernel (S, n_sites, 2)."""
    seen = []
    orig = jfused.dropout_matmul_inference

    def spy(xx, w, seeds, rate, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, rate, **kw)

    logits, seeds = [], []
    jfused.dropout_matmul_inference = spy
    try:
        for i in range(num_samples):
            seen.clear()
            out = model.apply(variables, jnp.asarray(x), sample_idx=i,
                              train=False,
                              rngs={"bayes": jax.random.fold_in(key, i)})
            logits.append(np.asarray(out.logits))
            seeds.append(np.stack(seen))
    finally:
        jfused.dropout_matmul_inference = orig
    return np.stack(logits), np.stack(seeds).astype(np.int32)


def _port(variables, rate, dtype):
    model = get_model("vgg11_me", bayes=BayesConfig(rate=rate), fused=True,
                      dtype=dtype)
    return load_flax_variables(model, variables).eval()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_rate_zero_logits_match_jax(setup, name):
    x, variables = setup
    jdt, tdt = DTYPES[name]
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=0.0), fused=True,
                       dtype=jdt)
    out = jm.apply(variables, jnp.asarray(x), train=False)
    tm = _port(variables, 0.0, tdt)
    assert tm.num_sites == 0
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.zeros(0, 2, dtype=torch.int32))
    assert got.logits.shape == (5, 2, 10)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(out.logits),
                               **TOL[name])
    np.testing.assert_allclose(got.features.float().numpy(),
                               np.asarray(out.features, np.float32),
                               **TOL[name])


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_mc_logits_match_jax_with_captured_seeds(setup, name):
    x, variables = setup
    jdt, tdt = DTYPES[name]
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       dtype=jdt)
    want, seeds = _capture(jm, variables, x, jax.random.key(3), S)
    assert seeds.shape == (S, 5, 2)
    tm = _port(variables, RATE, tdt)
    seeds_t = torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tm(torch.from_numpy(x), seeds_t).logits
        temporal = torch.stack([tm(torch.from_numpy(x), seeds_t[i]).logits
                                for i in range(S)])
    assert spatial.shape == (S, 5, 2, 10)
    np.testing.assert_allclose(spatial.numpy(), want, **TOL[name])
    assert torch.equal(spatial, temporal)
    # the masks matter: rate-0 logits differ from the MC ones
    with torch.inference_mode():
        det = _port(variables, 0.0, tdt)(
            torch.from_numpy(x), torch.zeros(0, 2, dtype=torch.int32)).logits
    assert not np.allclose(det.numpy(), want[0], atol=1e-3)


def test_load_flax_variables_layouts(setup):
    _, variables = setup
    tm = _port(variables, RATE, torch.float32)
    hwio = variables["params"]["block2"]["convbn1"]["conv"]["kernel"]
    oihw = tm.block2.convbn1.conv.kernel.detach().numpy()
    np.testing.assert_array_equal(oihw, hwio.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tm.exit1.linear.kernel.detach().numpy(),
                                  variables["params"]["exit1"]["linear"][
                                      "kernel"])
    np.testing.assert_array_equal(
        tm.fc_bn_0.var.numpy(), variables["batch_stats"]["fc_bn_0"]["var"])


def test_load_flax_variables_rejects_mismatches(setup):
    _, variables = setup
    model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True)
    params = dict(variables["params"])
    del params["fc_1"]
    with pytest.raises(KeyError, match="fc_1"):
        load_flax_variables(model, {**variables, "params": params})
    extra = {**variables["params"], "bogus": {"kernel": np.zeros(3)}}
    with pytest.raises(KeyError, match="bogus"):
        load_flax_variables(model, {**variables, "params": extra})
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["classifier"] = {"kernel": np.zeros((512, 7), np.float32),
                                   "bias": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="classifier"):
        load_flax_variables(model, bad)
    with pytest.raises(KeyError, match="masks"):
        load_flax_variables(model, {**variables, "masks": {}})


def test_site_numbering_and_shapes():
    model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True)
    heads = [model.exit1.linear, model.exit2.linear, model.exit3.linear,
             model.exit4.linear, model.classifier]
    assert [h.site for h in heads] == [0, 1, 2, 3, 4]
    assert all(h.kernel.shape == (512, 10) for h in heads)
    assert model.num_sites == 5
    single = get_model("vgg11", bayes=BayesConfig(rate=RATE), fused=True)
    assert single.num_sites == 1 and not hasattr(single, "exit1")
    with pytest.raises(ValueError, match="n_sites"):
        model(torch.zeros(1, 32, 32, 3), torch.zeros(4, 2, dtype=torch.int32))


def test_deterministic_head_broadcasts_over_samples():
    """A head without dropout (here every head, at rate 0 only the seeds'
    sample axis remains) repeats its logits over S."""
    torch.manual_seed(0)
    model = get_model("vgg11_me", bayes=BayesConfig(rate=0.0), fused=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3)
    with torch.inference_mode():
        one = model(x, torch.zeros(0, 2, dtype=torch.int32)).logits
        many = model(x, torch.zeros(3, 0, 2, dtype=torch.int32)).logits
    assert many.shape == (3, 5, 2, 10)
    for s in range(3):
        assert torch.equal(many[s], one)


def test_registry_and_unported_branches():
    """The registry; what is ported builds (its values are held against
    JAX below), what is not raises and names its ROADMAP item."""
    assert {"vgg11", "vgg11_me"} <= set(available_models())
    with pytest.raises(KeyError, match="available"):
        get_model("bogus")
    from bayestpu_torch.core.config import DropoutKind, QuantConfig
    # Masksembles heads and fused block sites are ported; materialized
    # block sites (fused=False, or a multi-exit model) are not
    assert get_model("vgg11_me", bayes=BayesConfig(kind=DropoutKind.MASK),
                     fused=True).num_sites == 0
    assert get_model("vgg11", bayes=BayesConfig(kind=DropoutKind.MASK),
                     fused=True, dropout="block").num_sites == 0
    assert get_model("vgg11", fused=True, dropout="block").num_sites == 5
    # materialized block sites (fused=False, or a multi-exit model): a
    # BayesSite after blocks 0-3, before the exit head it feeds
    mask_me = get_model("vgg11_me", bayes=BayesConfig(kind=DropoutKind.MASK),
                        dropout="block")
    assert mask_me.num_sites == 0 and mask_me.conv_sites
    assert get_model("vgg11_me", fused=True, dropout="block").num_sites == 9
    unfused = get_model("vgg11", fused=False, dropout="block")
    assert unfused.num_sites == 5 and unfused.bayes_b0.site == 0
    # quantization is ported, and its per-layer overrides apply
    assert get_model("vgg11_me", quant=QuantConfig(),
                     fused=True).quant == QuantConfig()
    over = get_model("vgg11_me", quant=QuantConfig(), fused=True,
                     quant_overrides={"fc_0": QuantConfig(8, 2),
                                      "block1": None})
    assert over.fc_0.quant == QuantConfig(8, 2)
    assert over.fc_1.quant == QuantConfig() and over.block1.quant is None
    assert over.block1.convbn0.conv.quant is None
    # the JAX default fused=False: unfused MC heads (BayesianDropout)
    assert get_model("vgg11_me", dropout="block").num_sites == 9
    assert get_model("vgg11_me", fused=False).classifier.drop is not None


# ------------------------------------------- materialized sites (item 11)


@pytest.fixture(scope="module")
def vgg11_vars():
    """Batch 2; the JAX vgg11 (one exit, dense head 512-512) Masksembles
    init variables with BatchNorm perturbed; its ``masks`` tree holds the
    banks of the materialized block sites and of the classifier."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("vgg11", bayes=JBayes(kind=JKind.MASK, num_masks=4,
                                             scale=2.0), dropout="block",
                       head_sites=True)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    return x, {"params": _perturb(v["params"], rng),
               "batch_stats": _perturb(v["batch_stats"], rng),
               "masks": v["masks"]}


# name: (model, its keywords beyond the bayes config; the JAX default
# fused=False unless named)
MATERIALIZED = {
    "vgg11_me_unfused_heads": ("vgg11_me", {}),
    "vgg11_block_unfused": ("vgg11", dict(dropout="block")),
    "vgg11_me_block_exits": ("vgg11_me", dict(dropout="block", fused=True)),
    "vgg11_head_sites": ("vgg11", dict(head_sites=True, fused=True)),
}


@pytest.mark.parametrize("config,dtype", [
    (c, "f32") for c in MATERIALIZED] + [("vgg11_me_unfused_heads", "bf16")])
def test_materialized_sites_match_jitted_jax(setup, vgg11_vars, config,
                                             dtype):
    """The item-11 configurations: the unfused MC heads of the JAX default
    ``fused=False`` (``BayesianDropout`` then the dense), the materialized
    block sites (``bayes_b0`` … ``bayes_b3``; with exits they feed the exit
    heads too), and ``head_sites`` (``bayes_fc_0``, ``bayes_fc_1``), on
    the seeds JAX drew (threefry keys and fused seeds, in call order),
    S = 2, against the jitted JAX model (TOL); the spatial mapping equal to
    the temporal one bit for bit."""
    name, kw = MATERIALIZED[config]
    jdt, tdt = DTYPES[dtype]
    x, variables = setup if name == "vgg11_me" else vgg11_vars
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    jm = jax_get_model(name, bayes=JBayes(rate=RATE), dtype=jdt, **kw)
    keys = [jax.random.key(7), jax.random.key(8)]
    want, seeds = capture_site_keys(jm, variables, x, keys)
    tm = load_flax_variables(get_model(name, bayes=BayesConfig(rate=RATE),
                                       dtype=tdt, **kw), variables)
    assert seeds.shape[1] == tm.num_sites
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tm(xt, st).logits
        temporal = torch.stack([tm(xt, st[s], s).logits for s in range(S)])
    assert torch.equal(spatial, temporal)
    np.testing.assert_allclose(spatial.float().numpy(), want, **TOL[dtype])
    assert not torch.equal(spatial[0], spatial[1])


def test_materialized_mask_sites_match_jax(vgg11_vars):
    """The Masksembles twin of the unfused block sites with ``head_sites``:
    the banks of ``bayes_b{i}`` and ``bayes_fc_{j}`` loaded by name
    (``masks/bayes_b0/Masksembles_0/bank``), per-mask f32 logits against
    JAX's (TOL), the spatial mapping equal to the one-index calls."""
    x, variables = vgg11_vars
    cfg = dict(dropout="block", head_sites=True)
    mask = dict(kind=JKind.MASK, num_masks=4, scale=2.0)
    jm = jax_get_model("vgg11", bayes=JBayes(**mask), **cfg)
    tm = load_flax_variables(get_model(
        "vgg11", bayes=BayesConfig(kind=DropoutKind.MASK, num_masks=4,
                                   scale=2.0), **cfg), variables)
    idxs = (0, 3, 5)
    want = np.stack([np.asarray(jm.apply(variables, jnp.asarray(x),
                                         sample_idx=i).logits)
                     for i in idxs])
    xt = torch.from_numpy(x)
    seeds = torch.zeros(len(idxs), 0, 2, dtype=torch.int32)
    with torch.inference_mode():
        spatial = tm(xt, seeds, torch.tensor(idxs)).logits
        ones = [tm(xt, seeds[0], i).logits for i in idxs]
    np.testing.assert_allclose(spatial.numpy(), want, **TOL["f32"])
    for s in range(len(idxs)):
        assert torch.equal(spatial[s], ones[s])
