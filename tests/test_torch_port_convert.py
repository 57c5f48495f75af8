"""The port's NN→BNN converter (``bayestpu_torch.nn.convert``) against the
JAX package's, on the CPU.

- The spec builders of the autobayes zoo, the three strategies and
  ``convert_to_bayesian`` equal JAX's on every spec list, ``num`` 0-5.
- ``Sequential`` values, the JAX init variables (every bias perturbed,
  numpy-seeded) loaded into the port by name: the ``lenet_specs`` sweep of
  ``cli/sweep.py dropouts`` (n = 1-4, DEFAULT strategy) at batch 3 on
  MNIST shapes, fused and not, and an AlexNet-shaped spec list narrowed
  for the CPU: a 67x67x3 input and every width divided by 8 (conv widths
  12, 32, 48, 48, 32; dense 512, 512, 10), n = 3 and 4, so the fused conv
  site (48 input channels) and the fused dense sites (``_xs`` after it)
  are on its path. MC sites run on the seeds JAX drew in call order
  (``capture_site_keys``: the threefry key of each materialized site and
  the seeds each fused one passed to its kernel), S = 2, against the
  jitted JAX model: f32 to rtol 1e-5; bf16 to 0.02 (oneDNN and XLA round a
  bf16 conv at other points, as in the LeNet tests); int8 bit for bit
  against the eager apply (the int8 protocol) on the routes without a
  threefry site. The spatial mapping equals the temporal one bit for bit.
- Masksembles ``Sequential`` (fused and not, f32 and bf16, int8) per mask
  index, and the fused/unfused identity of ``tests/test_fused_conv.py``.
- ``MCDropoutModel``/``MasksemblesModel`` ``predict`` and ``evaluate``
  against JAX's on the same weights and the captured keys.

The JAX kernels run in the Pallas interpreter.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import DropoutKind as JKind
from bayestpu.core.config import InsertStrategy as JStrategy
from bayestpu.core.config import QuantConfig as JQuant
from bayestpu.core.rng import sample_keys
from bayestpu.nn import convert as jc
from bayestpu.nn.zoo import autobayes as jab
from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                        InsertStrategy, QuantConfig,
                                        SamplingMode)
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.nn import convert as tc
from bayestpu_torch.nn.zoo import autobayes as tab
from port_threads import thread_budget  # noqa: F401
from test_torch_port_threefry import capture_site_keys

RATE = 0.25
MASK = dict(num_masks=4, scale=2.0)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=0.02, atol=0.02)}
MNIST = (28, 28, 1)
ALEX = (67, 67, 3)
KEYS = (3, 4)


def _rep(specs):
    """A package-neutral form of a spec list: class name and fields (a
    ``Bayes`` spec's config by value)."""
    return [(type(s).__name__, json.dumps(dataclasses.asdict(s),
                                          default=lambda o: o.value,
                                          sort_keys=True)) for s in specs]


def _cfgs(kind="mc", **kw):
    """The same BayesConfig in both packages."""
    if kind == "mc":
        base = dict(rate=RATE)
    else:
        base = dict(kind="mask", **MASK)
    base.update(kw)
    j = {k: (JKind(v) if k == "kind" else JStrategy(v) if k == "strategy"
             else v) for k, v in base.items()}
    t = {k: (DropoutKind(v) if k == "kind" else InsertStrategy(v)
             if k == "strategy" else v) for k, v in base.items()}
    return JBayes(**j), BayesConfig(**t)


def _alex_narrow(pkg):
    """AlexNet's layer list (``autobayes.py:44-52``) with every width
    divided by 8, for a 67x67x3 input on the CPU."""
    C, D, Act, Pool, Flatten = pkg.C, pkg.D, pkg.Act, pkg.Pool, pkg.Flatten
    return [C(12, (11, 11), (4, 4), "VALID"), Act(), Pool("max", 3, 2),
            C(32, (5, 5)), Act(), Pool("max", 3, 2),
            C(48, (3, 3)), Act(), C(48, (3, 3)), Act(),
            C(32, (3, 3)), Act(), Pool("max", 3, 2),
            Flatten(), D(512), Act(), D(512), Act(), D(10)]


SPECS = {"lenet": (lambda pkg: pkg.lenet_specs(), MNIST),
         "alex": (_alex_narrow, ALEX)}


def _perturb_biases(tree, rng):
    return {k: (_perturb_biases(v, rng) if isinstance(v, dict) else
                (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "bias" else v)
            for k, v in tree.items()}


def _x(shape, batch):
    return np.random.default_rng(1).normal(size=(batch,) + shape).astype(
        np.float32)


def _models(name, n, fused, dtype="f32", quant=False, kind="mc",
            strategy="default"):
    """JAX and port ``Sequential`` of a converted spec list and the JAX
    init variables (biases perturbed; with the JAX banks)."""
    build, shape = SPECS[name]
    jb, tb = _cfgs(kind, num_bayes_layers=n, strategy=strategy)
    jspecs = tuple(jc.convert_to_bayesian(build(jc), jb))
    tspecs = tuple(tc.convert_to_bayesian(build(tc), tb))
    assert _rep(jspecs) == _rep(tspecs)
    jdt, tdt = DTYPES[dtype]
    jq = JQuant(8, 0, int8_infer=True) if quant else None
    tq = QuantConfig(8, 0, int8_infer=True) if quant else None
    x = _x(shape, 3 if name == "lenet" else 2)
    init = jc.Sequential(jspecs, fused=fused)
    v = jax.tree.map(np.asarray, init.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    variables = {**v, "params": _perturb_biases(
        v["params"], np.random.default_rng(2))}
    jm = jc.Sequential(jspecs, quant=jq, dtype=jdt, fused=fused)
    tm = tc.Sequential(tspecs, shape, quant=tq, dtype=tdt, fused=fused)
    load_flax_variables(tm, variables)
    return jm, tm, variables, x


def _mc(name, n, fused, dtype="f32", quant=False, strategy="default"):
    """(JAX logits, port spatial and temporal logits, the port model)."""
    jm, tm, variables, x = _models(name, n, fused, dtype, quant,
                                   strategy=strategy)
    want, seeds = capture_site_keys(
        jm, variables, x, [jax.random.key(k) for k in KEYS], not quant)
    assert seeds.shape == (len(KEYS), tm.num_sites, 2)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        sp = tsampler.mc_logits(tm, xt, st)
        tp = tsampler.mc_logits(tm, xt, st, SamplingMode.TEMPORAL)
    return want, sp.float().numpy(), tp.float().numpy(), tm


# ------------------------------------------------------ specs, strategies

SPEC_LISTS = sorted(jab._SPEC_BUILDERS) + ["lenet_specs"]


def _spec_list(pkg, zoo, name):
    return pkg.lenet_specs() if name == "lenet_specs" else zoo.get_specs(name)


@pytest.mark.parametrize("name", SPEC_LISTS)
def test_specs_and_strategies_match_jax(name):
    """The spec list, each strategy's positions and ``convert_to_bayesian``
    under each strategy for ``num`` 0-5, MC and Masksembles."""
    js, ts = _spec_list(jc, jab, name), _spec_list(tc, tab, name)
    assert _rep(js) == _rep(ts)
    for strategy in ("default", "last", "full"):
        jfn = jc.STRATEGIES[JStrategy(strategy)]
        tfn = tc.STRATEGIES[InsertStrategy(strategy)]
        for num in range(6):
            assert jfn(js, num) == tfn(ts, num)
            for kind in ("mc", "mask"):
                jb, tb = _cfgs(kind, num_bayes_layers=num, strategy=strategy)
                assert (_rep(jc.convert_to_bayesian(js, jb))
                        == _rep(tc.convert_to_bayesian(ts, tb)))


# --------------------------------------------------------------- MC values


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_lenet_sweep_mc_matches_jitted_jax(n, fused):
    """The ``dropouts`` sweep points, f32: n = 1 a threefry site before the
    last Dense (never fused); n = 2 adds ``dense_8`` (fused: row 2/3, K =
    80); n = 3 a site before ``conv_3`` (20 input channels: threefry
    inside the BayesConv when fused); n = 4 one on the raw image."""
    want, sp, tp, tm = _mc("lenet", n, fused)
    assert tm.num_sites == n
    np.testing.assert_array_equal(sp, tp)
    np.testing.assert_allclose(sp, want, **TOL["f32"])
    assert not np.array_equal(sp[0], sp[1])


@pytest.mark.parametrize("n,fused", [(3, True), (4, True), (4, False)])
def test_alexnet_narrow_mc_matches_jitted_jax(n, fused):
    """The narrowed AlexNet, f32: n = 3 (fc6 fused as the first site, fc7
    fused on activations that carry S, a threefry site before fc8), n = 4
    adds the fused conv site before conv5 (48 input channels), after which
    fc6 and fc7 take x with the sample axis."""
    want, sp, tp, tm = _mc("alex", n, fused)
    assert tm.num_sites == n
    kinds = [type(getattr(tm, name)).__name__
             for kind, name in tm._steps if kind in ("site", "dense")]
    fused_sites = kinds.count("BayesConv") + kinds.count("BayesDense")
    assert fused_sites == (n - 1 if fused else 0)
    np.testing.assert_array_equal(sp, tp)
    np.testing.assert_allclose(sp, want, **TOL["f32"])


@pytest.mark.parametrize("name,n,fused", [("lenet", 2, True),
                                          ("lenet", 4, False),
                                          ("alex", 4, True)])
def test_bf16_matches_jitted_jax(name, n, fused):
    want, sp, tp, _ = _mc(name, n, fused, "bf16")
    np.testing.assert_array_equal(sp, tp)
    np.testing.assert_allclose(sp, want, **TOL["bf16"])


@pytest.mark.parametrize("name,n,fused", [("lenet", 1, True),
                                          ("alex", 1, True)])
def test_int8_matches_eager_jax(name, n, fused):
    """The int8 model (``int8_infer``), LAST strategy: one site, before
    the first Dense after the last conv and fused into it (the int8 heads,
    rows 4-5), so no threefry site is on the path: bit for bit against the
    eager JAX apply. The convs (at most 48 input channels) take the float
    branch on grid values, the later Denses run int8 × int8."""
    want, sp, tp, tm = _mc(name, n, fused, quant=True, strategy="last")
    assert tm.num_sites == 1
    np.testing.assert_array_equal(sp, tp)
    np.testing.assert_array_equal(sp, want)


# -------------------------------------------------------------- Masksembles


def _mask_case(name, n, fused, dtype="f32", quant=False):
    jm, tm, variables, x = _models(name, n, fused, dtype, quant, "mask")
    assert tm.num_sites == 0 and tm.masked
    np.testing.assert_equal(to_flax_variables(tm)["masks"],
                            variables["masks"])
    idxs = (0, 3, 5)
    want = np.stack([np.asarray(jm.apply(
        variables, jnp.asarray(x), sample_idx=i).logits.astype(jnp.float32))
        for i in idxs])
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        spatial = tm(xt, torch.zeros(len(idxs), 0, 2, dtype=torch.int32),
                     torch.tensor(idxs)).logits.float().numpy()
        ones = np.stack([tm(xt, torch.zeros(0, 2, dtype=torch.int32),
                            i).logits.float().numpy() for i in idxs])
    np.testing.assert_array_equal(spatial, ones)
    return want, spatial


@pytest.mark.parametrize("name,n,fused,dtype", [
    ("lenet", 2, True, "f32"), ("lenet", 3, False, "f32"),
    ("alex", 4, True, "f32"), ("alex", 4, True, "bf16")])
def test_masksembles_matches_jax(name, n, fused, dtype):
    """Per-mask logits (indices 0, 3, 5: 5 wraps) of the Masksembles
    ``Sequential``, the banks equal to the Flax init's under their Flax
    names (``masks/bayes_{i}/Masksembles_0/bank``, ``masks/conv_{i}/bank``,
    ``masks/dense_{i}/bank``), the spatial call equal to one-index calls.
    The Masksembles family computes in f32 whatever the dtype, but the
    bf16 model rounds its plain convs to bf16: the bf16 tolerance."""
    want, spatial = _mask_case(name, n, fused, dtype)
    np.testing.assert_allclose(spatial, want, **TOL[dtype])


def test_masksembles_int8_matches_jax():
    """The int8 Masksembles AlexNet-narrow, LAST strategy (the int8 bank
    head, rows 6-7): bit for bit against the eager apply."""
    jm, tm, variables, x = _models("alex", 1, True, quant=True, kind="mask",
                                   strategy="last")
    want = np.stack([np.asarray(jm.apply(variables, jnp.asarray(x),
                                         sample_idx=i).logits)
                     for i in range(4)])
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.zeros(4, 0, 2,
                                                  dtype=torch.int32)).logits
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_unfused_masksembles_identity():
    """``tests/test_fused_conv.py:380-404`` in the port: a (Bayes → Conv),
    (Bayes → Dense) spec list, fused and unfused, one param tree, per-mask
    logits equal; and each equal to JAX's."""
    def specs(pkg, cfg):
        return tuple(pkg.convert_to_bayesian(
            (pkg.C(16, (3, 3)), pkg.Act(), pkg.Pool("max", 2),
             pkg.C(32, (3, 3)), pkg.Act(), pkg.Flatten(), pkg.D(10)), cfg))
    jb, tb = _cfgs("mask", num_bayes_layers=2)
    x = np.random.default_rng(14).normal(size=(8, 16, 16, 12)).astype(
        np.float32)
    out = {}
    for fused in (True, False):
        jm = jc.Sequential(specs(jc, jb), fused=fused)
        v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x)))
        tm = tc.Sequential(specs(tc, tb), (16, 16, 12), fused=fused)
        load_flax_variables(tm, v)
        with torch.inference_mode():
            out[fused] = np.stack([tm(torch.from_numpy(x), torch.zeros(
                0, 2, dtype=torch.int32), i).logits.numpy()
                for i in range(4)])
        want = np.stack([np.asarray(jm.apply(v, jnp.asarray(x),
                                             sample_idx=i).logits)
                         for i in range(4)])
        np.testing.assert_allclose(out[fused], want, **TOL["f32"])
    np.testing.assert_allclose(out[True], out[False], rtol=2e-5, atol=2e-5)


def test_flax_names_and_refusals():
    """The children carry the Flax names (unfused: a ``bayes_{i}`` per
    site, with its ``BayesianDropout_0``; fused: the sites deferred into
    ``conv_1``, ``conv_5`` and ``dense_10``, the one before the last Dense
    kept); the tree goes back out equal; a missing, extra or misshapen
    leaf raises."""
    _, fused, _, _ = _models("lenet", 4, True)
    assert {n for n, _ in fused.named_children()} == {
        "conv_1", "act_2", "conv_5", "act_6", "dense_10", "act_11",
        "bayes_12", "dense_13"}
    jm, tm, variables, _ = _models("lenet", 4, False)
    assert {n for n, _ in tm.named_children()} == {
        "bayes_0", "conv_1", "act_2", "bayes_4", "conv_5", "act_6",
        "bayes_9", "dense_10", "act_11", "bayes_12", "dense_13"}
    assert tm.bayes_0.BayesianDropout_0 is not None
    back = to_flax_variables(tm)
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 variables["params"])
    bad = jax.tree.map(np.copy, variables)
    del bad["params"]["dense_10"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(tm, bad)
    bad = jax.tree.map(np.copy, variables)
    bad["params"]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        load_flax_variables(tm, bad)
    bad = jax.tree.map(np.copy, variables)
    bad["params"]["dense_13"]["kernel"] = np.zeros((3, 10), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tm, bad)


# ----------------------------------------------------------------- wrappers


@pytest.mark.parametrize("kind", ["mc", "mask"])
def test_wrappers_match_jax(kind):
    """``MCDropoutModel`` (num 2, rate 0.3) and ``MasksemblesModel`` (num
    1) over ``lenet_specs``: the JAX wrapper's ``predict`` and ``evaluate``
    (its eager sampler: the threefry site divides where the port
    multiplies, an f32 ulp: rtol 1e-5) against the port's on the same
    weights, the MC port fed the seeds JAX drew for each sample key."""
    x = _x(MNIST, 4)
    y = np.array([0, 1, 2, 3])
    if kind == "mc":
        jw = jc.MCDropoutModel(jc.lenet_specs(), num_samples=3, rate=0.3,
                               num=2)
        tw = tc.MCDropoutModel(tc.lenet_specs(), num_samples=3, rate=0.3,
                               num=2, input_shape=MNIST, device="cpu")
    else:
        jw = jc.MasksemblesModel(jc.lenet_specs(), num=1, **MASK)
        tw = tc.MasksemblesModel(tc.lenet_specs(), num=1, input_shape=MNIST,
                                 device="cpu", **MASK)
    key = jax.random.key(7)
    jw.init(key, jnp.asarray(x))
    tw.attach(jax.tree.map(np.asarray, jw.variables))
    want = np.asarray(jw.predict(jnp.asarray(x), key))
    if kind == "mc":
        _, seeds = capture_site_keys(jw.model, jw.variables, x,
                                     list(sample_keys(key, 3)), False)
        seed = torch.from_numpy(seeds)
    else:
        seed = 123       # enumerating masks: the seed does not matter
    got = tw.predict(x, seed).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jm = jw.evaluate(jnp.asarray(x), jnp.asarray(y), key)
    tm = tw.evaluate(x, y, seed)
    assert set(tm) <= set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6)
    logits = tw(x, 0, train=True)
    assert logits.shape == (4, 10) and logits.requires_grad
