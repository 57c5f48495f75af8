"""The port's LeNet family against the JAX package's, on the CPU.

Full-width ``lenet`` (``num_bayes_layers`` 1, 2 and 3, fused and not) and
``lenet_me`` (fused and not) at batch 3 on MNIST shapes (28×28×1), the JAX
init variables with every bias perturbed (numpy, seeded), loaded into the
port by name through ``from_flax``. The MC models run on the seeds JAX drew
in call order (the threefry key of each materialized site and the seeds of
each fused one, ``capture_site_keys``) and are held against the jitted JAX
model, S = 2: f32 to rtol 1e-5, bf16 to 0.02 (oneDNN and XLA round a bf16
conv at other points: measured 0.0065 of the largest logit), int8 bit for
bit where the heads run the int8 kernels; the spatial mapping equal to the
temporal one bit for bit. Then the Masksembles twins, the engine on MNIST
shapes, one f32 training step of ``lenet_me`` against ``jax.value_and_grad``
(loss 1e-6, each gradient to 3e-4 of its norm) and a few port steps of the
``"lenet"`` recipe on synthetic MNIST. The JAX kernels run in the Pallas
interpreter; each JAX tree is built once per file.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.nn.fused as jfused
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import DropoutKind as JKind
from bayestpu.core.config import QuantConfig as JQuant
from bayestpu.core.rng import sample_keys
from bayestpu.engine import sampler as jsampler
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu.train.losses import eed_loss as jax_eed_loss
from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                        EngineConfig, QuantConfig,
                                        SamplingMode)
from bayestpu_torch.core.rng import step_seeds
from bayestpu_torch.data.datasets import get_dataset
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.nn.zoo import available_models, get_model
from bayestpu_torch.train.loop import create_state, make_train_step
from bayestpu_torch.train.losses import eed_loss
from bayestpu_torch.train.optim import get_optimizer, get_recipe
from port_threads import thread_budget  # noqa: F401
from test_torch_port_threefry import _seeds, capture_site_keys

RATE = 0.25
MASK = dict(num_masks=4, scale=2.0)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=0.02, atol=0.02)}
SHAPE = (28, 28, 1)


def _perturb_biases(tree, rng):
    """Every bias moved off its zero init, so the convs' and denses'
    biases show."""
    return {k: (_perturb_biases(v, rng) if isinstance(v, dict) else
                (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "bias" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def data():
    """Batch 3 of MNIST shapes and the JAX init variables of ``lenet``
    and ``lenet_me`` (every LeNet configuration holds the same parameter
    names), biases perturbed."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3,) + SHAPE).astype(np.float32)
    out = {"x": x}
    for name in ("lenet", "lenet_me"):
        jm = jax_get_model(name, bayes=JBayes(rate=RATE))
        v = jax.tree.map(np.asarray, jm.init(
            {"params": jax.random.key(0), "bayes": jax.random.key(0)},
            jnp.asarray(x)))
        out[name] = {"params": _perturb_biases(v["params"], rng)}
    return out


def _models(name, nb, fused, dtype="f32", quant=False, kind="mc"):
    jdt, tdt = DTYPES[dtype]
    jq = JQuant(8, 0, int8_infer=True) if quant else None
    tq = QuantConfig(8, 0, int8_infer=True) if quant else None
    if kind == "mc":
        jb, tb = JBayes(rate=RATE), BayesConfig(rate=RATE)
    else:
        jb = JBayes(kind=JKind.MASK, **MASK)
        tb = BayesConfig(kind=DropoutKind.MASK, **MASK)
    if name == "lenet":
        jb = JBayes(**{**jb.__dict__, "num_bayes_layers": nb})
        tb = BayesConfig(**{**tb.__dict__, "num_bayes_layers": nb})
    jm = jax_get_model(name, bayes=jb, fused=fused, dtype=jdt, quant=jq)
    tm = get_model(name, bayes=tb, fused=fused, dtype=tdt, quant=tq)
    return jm, tm


def _mc_case(data, name, nb, fused, dtype="f32", quant=False,
             jitted=True):
    """(JAX logits, jitted or eager, and the port's spatial and temporal
    logits)."""
    x, variables = data["x"], data[name]
    jm, tm = _models(name, nb, fused, dtype, quant)
    want, seeds = capture_site_keys(jm, variables, x,
                                    [jax.random.key(3), jax.random.key(4)],
                                    jitted)
    load_flax_variables(tm, variables)
    assert seeds.shape == (2, tm.num_sites, 2)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(tm, xt, st)
        temporal = tsampler.mc_logits(tm, xt, st, SamplingMode.TEMPORAL)
    return want, spatial.float().numpy(), temporal.float().numpy()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_lenet_mc_matches_jitted_jax(data, nb, fused):
    """``lenet`` with 1, 2 or 3 sites, fused and not, f32: site 0 is the
    threefry ``BayesianDropout`` on the 20-channel map (inside
    ``conv2d_2`` when fused: 20 < 32 routes it unfused), site 1 the input
    of ``fc_1`` on the 80 NHWC-ordered features (threefry, or fused into
    ``fc_1``), site 2 the head."""
    want, spatial, temporal = _mc_case(data, "lenet", nb, fused)
    np.testing.assert_array_equal(spatial, temporal)
    np.testing.assert_allclose(spatial, want, **TOL["f32"])
    assert not np.array_equal(spatial[0], spatial[1])


@pytest.mark.parametrize("fused", [False, True])
def test_lenet_me_mc_matches_jitted_jax(data, fused):
    """``lenet_me``: the early exit's stride-7 SAME conv and both heads,
    f32, fused heads (rows 2-3) or the JAX default unfused ones."""
    want, spatial, temporal = _mc_case(data, "lenet_me", 1, fused)
    assert spatial.shape == (2, 2, 3, 10)
    np.testing.assert_array_equal(spatial, temporal)
    np.testing.assert_allclose(spatial, want, **TOL["f32"])


@pytest.mark.parametrize("name,nb,fused", [
    ("lenet", 3, False), ("lenet", 3, True), ("lenet_me", 1, True)])
def test_bf16_matches_jitted_jax(data, name, nb, fused):
    want, spatial, temporal = _mc_case(data, name, nb, fused, "bf16")
    np.testing.assert_array_equal(spatial, temporal)
    np.testing.assert_allclose(spatial, want, **TOL["bf16"])


@pytest.mark.parametrize("name,nb,fused", [
    ("lenet_me", 1, True), ("lenet", 2, True), ("lenet", 3, True),
    ("lenet", 3, False)])
def test_int8_matches_jax(data, name, nb, fused):
    """The int8 model (``int8_infer``): ``fc_1`` int8 × int8 and the fused
    heads on the int8 kernels (rows 4-5 at K = 80 and 100), against an
    eager JAX apply, as the int8 protocol holds every int8 model (under
    ``jax.jit`` XLA-CPU contracts the Pallas interpreter's int8 rescale
    with the bias into one FMA, which a compiled kernel does not): bit for
    bit without a threefry site. With ``lenet``'s site 0 (threefry, on
    the grid values) the eager JAX site divides by keep where the port
    multiplies, as the jitted one does; one ulp moves a hidden feature of
    ``fc_1`` by at most one grid step (2⁻⁸, the unsigned grid of
    ``relu3``), so a logit by at most 2⁻⁸ · max‖w_col‖₁ / keep of the
    head. With ``fused=False`` the heads are the float dense on
    fake-quantized kernels (JAX runs int8 heads only fused): f32
    tolerance."""
    want, spatial, temporal = _mc_case(data, name, nb, fused, quant=True,
                                       jitted=False)
    np.testing.assert_array_equal(spatial, temporal)
    if not fused:
        np.testing.assert_allclose(spatial, want, **TOL["f32"])
    elif nb < 3:
        np.testing.assert_array_equal(spatial, want)
    else:
        w = np.abs(data[name]["params"]["fc_2"]["kernel"]).sum(0).max()
        bound = 2.0 ** -8 * w / (1 - RATE)
        assert np.abs(spatial - want).max() <= bound


@pytest.mark.parametrize("name,nb,fused", [
    ("lenet", 3, False), ("lenet", 3, True), ("lenet_me", 1, True)])
def test_masksembles_matches_jax(data, name, nb, fused):
    """The Masksembles twins: their own banks (``masks/bayes_0/
    Masksembles_0/bank``, ``masks/conv2d_2/bank``, ``masks/fc_1/bank``,
    the heads') equal to the Flax init's, per-mask f32 logits against
    JAX's, the spatial mapping (indices 0, 3, 5) equal to one-index
    calls."""
    x = data["x"]
    jm, tm = _models(name, nb, fused, kind="mask")
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0)}, jnp.asarray(x)))
    variables = {"params": data[name]["params"], "masks": v["masks"]}
    load_flax_variables(tm, variables)
    assert tm.num_sites == 0 and tm.masked
    np.testing.assert_equal(to_flax_variables(tm)["masks"], v["masks"])
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


def test_registry_names_and_round_trip(data):
    """``lenet`` and ``lenet_me`` are registered with JAX's defaults
    (``fused=False``, one site: the head), and a port model's variables
    go back to the JAX tree's names and shapes (kernels HWIO)."""
    assert {"lenet", "lenet_me"} <= set(available_models())
    default = get_model("lenet")
    assert default.num_sites == 1 and default.fc_2.drop is not None
    for name in ("lenet", "lenet_me"):
        tm = load_flax_variables(get_model(name, fused=True), data[name])
        back = to_flax_variables(tm)["params"]
        jax.tree.map(np.testing.assert_array_equal, back,
                     data[name]["params"])


def test_spatial_predictive_matches_jax_sampler(data):
    """``lenet(num_bayes_layers=3)``: the port's spatial predictive on the
    keys of ``sample_keys`` against ``bayestpu.engine.sampler.predictive``
    (JAX's vmap over the sample keys), S = 3, rtol 1e-5."""
    x, variables = data["x"], data["lenet"]
    jm, tm = _models("lenet", 3, False)
    key = jax.random.key(5)
    _, seeds = capture_site_keys(jm, variables, x, sample_keys(key, 3))
    want = jsampler.predictive(jm, variables, jnp.asarray(x), key, 3,
                               jsampler.SamplingMode.SPATIAL)
    load_flax_variables(tm, variables)
    with torch.inference_mode():
        got = tsampler.predictive(tm, torch.from_numpy(x),
                                  torch.from_numpy(seeds))
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               rtol=1e-5, atol=1e-6)


def test_engine_serves_mnist_shapes(data):
    """``BayesEngine(device="cpu")`` on ``lenet_me`` and the threefry
    ``lenet``: spatial and temporal predictives agree, and sample i of a
    one-sample predict equals sample i of the spatial logits."""
    x = data["x"]
    for name, bayes in (("lenet_me", BayesConfig(rate=RATE)),
                        ("lenet", BayesConfig(rate=RATE,
                                              num_bayes_layers=3))):
        engines = [BayesEngine(get_model(name, bayes=bayes),
                               config=EngineConfig(mode=mode),
                               device="cpu").attach(data[name])
                   for mode in (SamplingMode.SPATIAL, SamplingMode.TEMPORAL)]
        sp, tm = (e.predict(x, seed=2, num_samples=4) for e in engines)
        assert sp.probs.shape == (2 if name == "lenet_me" else 1, 3, 10)
        torch.testing.assert_close(sp.probs, tm.probs, rtol=1e-6,
                                   atol=1e-6)
        one = engines[0].predict(x, seed=2, sample_idx=1)
        with torch.inference_mode():
            logits = tsampler.mc_logits(engines[0].model,
                                        torch.from_numpy(x),
                                        engines[0].seeds(2, 4))
        torch.testing.assert_close(one, torch.softmax(logits[1], -1),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_lenet_me_train_step_matches_jax(data, fused):
    """One f32 training step of ``lenet_me``, batch 4, against the jitted
    ``jax.value_and_grad`` of the EED loss: the heads' seeds (threefry
    keys unfused, ``dropout_matmul``'s seeds fused), loss to 1e-6, every
    gradient by name to 3e-4 of its norm."""
    variables = data["lenet_me"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4,) + SHAPE).astype(np.float32)
    y = np.array([0, 7, 3, 7], np.int32)
    jm, tm = _models("lenet_me", 1, fused)
    key = jax.random.key(9)

    def loss_fn(params):
        o = jm.apply({"params": params}, jnp.asarray(x), train=True,
                     rngs={"bayes": key})
        return jax_eed_loss(o.logits, jnp.asarray(y), o.features)

    seen = []
    orig_b, orig_mm = jax.random.bernoulli, jfused.dropout_matmul

    def bern(k, p, shape):
        seen.append(_seeds(k))
        return orig_b(k, p, shape)

    def spy(xx, w, seeds, *a, **kw):
        seen.append(np.asarray(seeds).astype(np.int32))
        return orig_mm(xx, w, seeds, *a, **kw)

    jax.random.bernoulli, jfused.dropout_matmul = bern, spy
    try:
        loss_fn(variables["params"])
    finally:
        jax.random.bernoulli, jfused.dropout_matmul = orig_b, orig_mm
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    seeds = torch.from_numpy(np.stack(seen))
    assert seeds.shape == (2, 2)
    load_flax_variables(tm, variables).train()
    params = dict(tm.named_parameters())
    out = tm(torch.from_numpy(x), seeds)
    tloss = eed_loss(out.logits, torch.from_numpy(y).long(), out.features)
    tgrads = torch.autograd.grad(tloss, list(params.values()))
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=1e-6)
    want = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[f"{prefix}{k}"] = np.asarray(v)

    walk(jax.tree.map(np.asarray, grads))
    assert set(want) == set(params)
    for (k, p), g in zip(params.items(), tgrads):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)            # OIHW → HWIO
        err = np.linalg.norm(g - want[k])
        assert err <= 3e-4 * np.linalg.norm(want[k]), (k, err)


def test_lenet_recipe_trains_on_synthetic_mnist():
    """The copied ``"lenet"`` recipe (Adam 1e-3, constant, clip 10) trains
    the threefry ``lenet(num_bayes_layers=3)`` on synthetic MNIST on the
    CPU: the materialized sites draw their masks from ``step_seeds`` like
    any MC site, and the loss falls over 12 steps of batch 32."""
    ds = get_dataset("mnist", data_dir="/nonexistent", n_synth_train=384,
                     n_synth_test=32)
    model = get_model("lenet", bayes=BayesConfig(rate=RATE,
                                                 num_bayes_layers=3))
    tx = get_optimizer(get_recipe("lenet"), steps_per_epoch=12)
    state = create_state(model, tx, 0, ds.x_train[:32], device="cpu")
    step = make_train_step(model, tx)
    losses = []
    for i in range(12):
        sl = slice(32 * i, 32 * (i + 1))
        m = step(state, torch.from_numpy(ds.x_train[sl]),
                 torch.from_numpy(ds.y_train[sl]).long(),
                 step_seeds(0, state.step, model.num_sites))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


# name: (x NHWC shape, features, kernel, strides, padding, compute dtype,
# quant: None, "fake" (QAT-style fake-quant), "int8" (the layer's own
# int8_infer), "resid" (an int8-residency input, model-wide int8_infer)
CONVS = {
    "f32_s7_same": ((2, 14, 14, 20), 20, 5, 7, "SAME", "f32", None),
    "bf16_s1_same": ((2, 9, 9, 6), 5, 5, 1, "SAME", "bf16", None),
    "f32_s3_valid": ((2, 11, 10, 4), 7, 3, 3, "VALID", "f32", None),
    "fake_quant": ((2, 8, 8, 5), 6, 3, 2, "SAME", "f32", "fake"),
    "int8_forced": ((2, 8, 8, 5), 6, 3, 1, "SAME", "f32", "int8"),
    "int8_residency": ((2, 8, 8, 40), 6, 3, 1, "SAME", "f32", "resid"),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_plain_conv_matches_flax(name):
    """``nn.layers.Conv`` against the Flax ``Conv`` (``layers.py:86-160``)
    on one set of variables: any stride with XLA's asymmetric SAME padding
    or VALID, a bias, bf16 compute (the conv rounded to bf16, then the f32
    bias), the fake-quantized kernel and bias, the layer's own
    ``int8_infer`` (int8 × int8 → int32) and an int8-residency input under
    the model-wide ``int8_infer`` (40 input channels: int8 execution);
    f32 to rtol 1e-5, bf16 one bf16 step (2⁻⁸ relative), int8 bit for
    bit."""
    from bayestpu.nn import layers as jlayers
    from bayestpu_torch.nn.layers import Conv
    shape, f, k, stride, padding, dtype, quant = CONVS[name]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    jq = tq = None
    if quant is not None:
        jq = JQuant(8, 0, int8_infer=quant == "resid",
                    int8_conv_min_ch=32)
        tq = QuantConfig(8, 0, int8_infer=quant == "resid",
                         int8_conv_min_ch=32)
    if quant == "resid":
        x = np.clip(np.round(x * 32), -128, 127).astype(np.int8)
    jl = jlayers.Conv(f, (k, k), (stride, stride), padding, quant=jq,
                      dtype=jdt, int8_infer=quant == "int8")
    v = jax.tree.map(np.asarray, jl.init(jax.random.key(1), jnp.asarray(x)))
    v = {"params": _perturb_biases(v["params"], rng)}
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    tl = load_flax_variables(Conv(shape[-1], f, (k, k), (stride, stride),
                                  padding, quant=tq, dtype=tdt,
                                  int8_infer=quant == "int8"), v)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tl(xt).permute(0, 2, 3, 1).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if quant in ("int8", "resid"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **(
            TOL["f32"] if dtype == "f32" else dict(rtol=2.0 ** -8,
                                                   atol=1e-6)))
