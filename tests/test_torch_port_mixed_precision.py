"""The port's per-layer precision against the JAX package's, on the CPU.

- ``Dense(bias_quant=…)`` and ``Dense(int8_infer=True)`` against the Flax
  ``Dense`` (``bayestpu/nn/layers.py:36-83``): bit-equal in int8, rtol 1e-6
  in f32; an int8 input with ``quant=None`` raises in both.
- ``ConvBN(emit_int8=True)`` without ``act_quant``: int8 out, bit-equal to
  JAX and to the port's own ``act_quant=True``.
- ``mixed_head=True`` on every vgg builder: the same override dict as JAX
  (``vgg.py:295-310``); nothing on a float model.
- The int8 ``vgg11_me`` with ``mixed_head``, with the quantize-late
  overrides of ``scripts/exp_quantize_late.py`` (``{"block0": None,
  "block1": None}``) and with a ``classifier`` override, on the JAX
  package's QAT weights (init variables with BatchNorm perturbed) and the
  seeds the JAX heads drew, against the eager JAX apply (Known differences
  18): the same residency dtypes (block outputs, ``fc_relu_0``) and
  bit-equal logits, but for quantize-late in f32 compute (Known
  differences 22): its two float blocks sum their f32 convs in another
  order than XLA's, block 2 quantizes them, and an element within the last
  bits of a rounding boundary lands one grid step over; those logits are
  held within two grid steps of a head's int8 input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayestpu.nn.fused as jfused
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import QuantConfig as JQuant
from bayestpu.core.rng import sample_keys
from bayestpu.nn import layers as jlayers
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu_torch.core.config import BayesConfig, QuantConfig
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.nn import layers as tlayers
from bayestpu_torch.nn.zoo import get_model
from port_threads import thread_budget  # noqa: F401
from test_torch_port_int8 import _perturb

RATE = 0.25
STEP = 2.0 ** -7
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _q(**kw):
    """The same QuantConfig in both packages."""
    return JQuant(**kw), QuantConfig(**kw)


# ------------------------------------------------------------------ Dense

# name: (JAX Dense kwargs / port Dense kwargs, int8 input, exact)
DENSE_CASES = {
    # the reference's fc_0 bias: kernel on the 8-bit grid, bias on 16
    "bias_quant": (dict(quant=dict(total_bits=8, integer_bits=0),
                        bias_quant=dict(total_bits=16, integer_bits=0)),
                   False, False),
    # explicit int8 × int8 below the layer-width threshold
    "int8_infer": (dict(quant=dict(total_bits=8, integer_bits=0,
                                   int8_infer=True, int8_dense_min_dim=64),
                        int8_infer=True), False, True),
    "int8_infer_int8_input": (dict(quant=dict(total_bits=8, integer_bits=1),
                                   int8_infer=True), True, True),
    # an int8-resident input on a float branch: exact dequantize
    "int8_input_fake_quant": (dict(quant=dict(total_bits=8,
                                              integer_bits=0)), True, False),
    # int8 matmul and a 16-bit bias
    "int8_infer_bias_quant": (dict(
        quant=dict(total_bits=8, integer_bits=0, int8_infer=True),
        bias_quant=dict(total_bits=16, integer_bits=0)), False, True),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_matches_jax(name):
    kw, int8_in, exact = DENSE_CASES[name]
    rng = np.random.default_rng(len(name))
    if int8_in:
        x = rng.integers(-128, 128, size=(5, 32)).astype(np.int8)
    else:
        x = rng.uniform(-1, 1, (5, 32)).astype(np.float32)
    kernel = rng.normal(scale=0.2, size=(32, 16)).astype(np.float32)
    # a bias that the 16-bit grid resolves and the 8-bit one rounds away
    bias = (rng.integers(-50, 50, 16) * 2.0 ** -12).astype(np.float32)
    jkw = {k: JQuant(**v) if isinstance(v, dict) else v
           for k, v in kw.items()}
    tkw = {k: QuantConfig(**v) if isinstance(v, dict) else v
           for k, v in kw.items()}
    want = np.asarray(jlayers.Dense(16, **jkw).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    layer = tlayers.Dense(32, 16, **tkw)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(kernel))
        layer.bias.copy_(torch.from_numpy(bias))
        got = layer(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if "bias_quant" in name:
        # the bias is not on the 8-bit grid: the override took effect
        no_bq = tlayers.Dense(32, 16, quant=tkw["quant"])
        no_bq.load_state_dict(layer.state_dict())
        with torch.no_grad():
            assert not torch.equal(no_bq(torch.from_numpy(x)),
                                   torch.from_numpy(got))


def test_dense_int8_input_without_quant_raises_as_jax():
    x = np.ones((2, 8), np.int8)
    with pytest.raises(ValueError, match="int8-residency"):
        jlayers.Dense(4).init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="int8-residency"):
        tlayers.Dense(8, 4)(torch.from_numpy(x))


# ----------------------------------------------------------------- ConvBN


@pytest.mark.parametrize("cin,dt", [(16, "f32"), (16, "bf16"), (128, "f32"),
                                    (128, "bf16")])
def test_convbn_emit_int8_matches_jax(cin, dt):
    """``emit_int8`` without ``act_quant`` on the int8 model, fed int8: the
    float-branch conv on grid values (16 channels) and the int8 × int8 one
    (128, ``_int8_conv_on_mxu``); int8 out, bit-equal to JAX and to the
    port's ``act_quant=True``."""
    cout = 32
    rng = np.random.default_rng(cin)
    x = rng.integers(0, 128, size=(2, 8, 8, cin)).astype(np.int8)
    kernel = rng.normal(scale=0.04, size=(3, 3, cin, cout)).astype(
        np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
          "bias": rng.normal(scale=0.2, size=cout).astype(np.float32)}
    stats = {"mean": rng.normal(scale=0.3, size=cout).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}
    jq, tq = _q(total_bits=8, integer_bits=0, int8_infer=True)
    jl = jlayers.ConvBN(cout, quant=jq, dtype=JDT[dt])
    want = np.asarray(jl.apply(
        {"params": {"conv": {"kernel": kernel}, "bn": bn},
         "batch_stats": {"bn": stats}}, jnp.asarray(x), act="relu",
        emit_int8=True))
    tl = tlayers.ConvBN(cin, cout, quant=tq, dtype=TDT[dt]).eval()
    with torch.no_grad():
        tl.conv.kernel.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        for k, v in {**bn, **stats}.items():
            getattr(tl.bn, k).copy_(torch.from_numpy(v))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tl(xt, act="relu", emit_int8=True)
        aq = tl(xt, act="relu", act_quant=True)
    assert want.dtype == np.int8 and got.dtype == torch.int8
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert torch.equal(got, aq)
    assert len(np.unique(want)) > 20            # the grid is exercised


# ----------------------------------------------------------- mixed_head

BUILDERS = ["vgg11", "vgg11_me", "vgg16", "vgg19", "vgg19_me"]


def _asdict(ov):
    return None if ov is None else {
        k: None if v is None else dataclasses.asdict(v)
        for k, v in ov.items()}


@pytest.mark.parametrize("name", BUILDERS)
def test_mixed_head_overrides_equal_jax(name):
    """The same override dict as JAX: ``fc_0/bias`` and ``fc_relu_0`` at 16
    bits without ``int8_infer``, ``fc_0`` untouched, a caller's entry kept;
    nothing on a float model."""
    jq, tq = _q(total_bits=8, integer_bits=0, int8_infer=True)
    for extra in ({}, {"fc_relu_0": None}):
        jm = jax_get_model(name, quant=jq, mixed_head=True,
                           quant_overrides=dict(extra) or None)
        tm = get_model(name, quant=tq, mixed_head=True,
                       quant_overrides=dict(extra) or None)
        assert _asdict(tm.quant_overrides) == _asdict(jm.quant_overrides)
        assert "fc_0" not in tm.quant_overrides
        assert tm.quant_overrides["fc_0/bias"].total_bits == 16
    assert get_model(name, mixed_head=True).quant_overrides is None
    assert jax_get_model(name, mixed_head=True).quant_overrides is None


# ------------------------------------------------------- int8 vgg11_me

INT8 = dict(total_bits=8, integer_bits=0, int8_infer=True)
# name: (builder kwargs beyond quant, whose dicts are QuantConfig fields)
MODELS = {
    "mixed_head": dict(mixed_head=True),
    "quantize_late": dict(quant_overrides={"block0": None, "block1": None}),
    "classifier": dict(quant_overrides={
        "classifier": dict(total_bits=8, integer_bits=1, int8_infer=True)}),
}
HEAD_FNS = ("dropout_matmul_int8_inference", "dropout_matmul_inference")
WATCH = ("block0", "block1", "block2", "block3", "block4", "fc_relu_0")


def _kw(kw, Q):
    out = dict(kw)
    if "quant_overrides" in kw:
        out["quant_overrides"] = {k: None if v is None else Q(**v)
                                  for k, v in kw["quant_overrides"].items()}
    return out


@pytest.fixture(scope="module")
def qat_vars():
    """The JAX QAT vgg11_me init variables with BatchNorm perturbed, and an
    input batch of 2."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JQuant(8, 0))
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    return x, {"params": _perturb(v["params"], rng),
               "batch_stats": _perturb(v["batch_stats"], rng)}


def _jax_run(jm, variables, x, keys):
    """The eager JAX apply per key: logits (S, E, B, C), the seeds every
    head passed to its kernel in call order (S, n_sites, 2), and the last
    key's output of each of ``WATCH``."""
    seen = []
    origs = {n: getattr(jfused, n) for n in HEAD_FNS}

    def spy(name):
        def f(xx, w, seeds, *a, **kw):
            seen.append(np.asarray(seeds))
            return origs[name](xx, w, seeds, *a, **kw)
        return f

    logits, seeds, dtypes = [], [], {}
    for n in HEAD_FNS:
        setattr(jfused, n, spy(n))
    try:
        for i, k in enumerate(keys):
            seen.clear()
            out, inter = jm.apply(
                variables, jnp.asarray(x), sample_idx=i, train=False,
                rngs={"bayes": k},
                capture_intermediates=lambda mdl, _: mdl.name in WATCH)
            logits.append(np.asarray(out.logits))
            seeds.append(np.stack(seen))
            acts = {n: jax.tree.leaves(inter["intermediates"][n])[0]
                    for n in WATCH}
    finally:
        for n, f in origs.items():
            setattr(jfused, n, f)
    return np.stack(logits), np.stack(seeds).astype(np.int32), acts


def _grid_steps(got, want, model):
    """max |got − want| in grid steps of a head's int8 input through the
    widest column of the heads' quantized kernels."""
    from bayestpu_torch.core.quant import fake_quant
    from bayestpu_torch.nn.fused import BayesDense
    col = max(torch.linalg.vector_norm(fake_quant(h.kernel, h.quant),
                                       dim=0).max().item()
              for h in model.modules() if isinstance(h, BayesDense))
    return np.abs(got - want).max() / (STEP * col / (1 - RATE))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_int8_overrides_match_jax(qat_vars, name, dt):
    x, variables = qat_vars
    kw = MODELS[name]
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JQuant(**INT8), dtype=JDT[dt], **_kw(kw, JQuant))
    want, seeds, jacts = _jax_run(jm, variables, x,
                                  sample_keys(jax.random.key(7), 2))
    jdtypes = {n: str(a.dtype) for n, a in jacts.items()}
    assert seeds.shape == (2, 5, 2)
    model = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=RATE), fused=True,
        quant=QuantConfig(**INT8), dtype=TDT[dt], **_kw(kw, QuantConfig)),
        variables).eval()
    tacts = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda m, a, out, n=n: tacts.__setitem__(n, out)) for n in WATCH]
    with torch.inference_mode():
        # the last sample alone leaves its activations in the hooks
        got = torch.cat([model(torch.from_numpy(x), torch.from_numpy(seeds[
            :1])).logits, model(torch.from_numpy(x),
                                torch.from_numpy(seeds[1:])).logits])
    for h in hooks:
        h.remove()
    tdtypes = {n: str(a.dtype).replace("torch.", "")
               for n, a in tacts.items()}
    assert tdtypes == jdtypes
    if name == "quantize_late" and dt == "f32":
        # the float blocks agree to summation order; their outputs differ
        # on block 2's int8 grid only where they lie within the last bits
        # of a rounding boundary
        for n in ("block0", "block1"):
            ref = np.asarray(jacts[n], np.float32)
            np.testing.assert_allclose(
                tacts[n].permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5,
                atol=1e-5 * np.abs(ref).max())
        t1 = tacts["block1"].permute(0, 2, 3, 1).numpy() / STEP
        j1 = np.asarray(jacts["block1"], np.float32) / STEP
        flip = np.round(t1) != np.round(j1)
        assert np.all(np.abs(np.abs(j1 - np.floor(j1)) - 0.5)[flip] < 1e-3)
        assert _grid_steps(got.numpy(), want, model) <= 2.0
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # the residency each configuration must show
    if name == "quantize_late":
        assert tdtypes["block1"] != "int8" and tdtypes["block2"] == "int8"
    else:
        assert tdtypes["block0"] == "int8"
    assert tdtypes["fc_relu_0"] == "float32"
    # the override changed the model: it is not the plain int8 vgg11_me
    plain = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=RATE), fused=True,
        quant=QuantConfig(**INT8), dtype=TDT[dt]), variables).eval()
    with torch.inference_mode():
        assert not torch.equal(plain(torch.from_numpy(x),
                                     torch.from_numpy(seeds)).logits, got)


def test_float_fc_override_on_int8_residency_raises_as_jax(qat_vars):
    """``{"fc_0": None}`` hands the float fc_0 the int8-resident backbone
    output: a ValueError in both packages."""
    x, variables = qat_vars
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JQuant(**INT8), quant_overrides={"fc_0": None})
    with pytest.raises(ValueError, match="int8-residency"):
        jm.apply(variables, jnp.asarray(x), rngs={"bayes": jax.random.key(0)})
    tm = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=RATE), fused=True,
        quant=QuantConfig(**INT8), quant_overrides={"fc_0": None}),
        variables).eval()
    with pytest.raises(ValueError, match="int8-residency"):
        with torch.inference_mode():
            tm(torch.from_numpy(x), torch.zeros(5, 2, dtype=torch.int32))
