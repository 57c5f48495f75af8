"""The port's model registry for the converter zoo and the VGG-16/19
family against the JAX package's, on the CPU.

Every autobayes model (``nn/zoo/autobayes.py``) is built through
``get_model`` with an MC site (rate 0.25, DEFAULT strategy, one site) and
``fused=True``, which both registries accept and ignore: the port's model
has the same modules as with ``fused=False`` (a materialized threefry site
before the last Dense, whatever ``fused`` says), as JAX builds its
``Sequential`` without it. Its logits match the JAX model's on the same
weights and seeds (``capture_site_keys``, S = 2) at batch 2: MNIST shapes,
16 features for ThreeLayer, and 67x67x3 for AlexNet at its published
widths (fc6 then takes 1x1x256 features; the port is told the shape with
``input_shape``, which Flax infers). ``vgg16``, ``vgg19`` and ``vgg19_me``
(JAX's defaults: 100 classes, no hidden dense; ``vgg19_me`` five exits
with an MC site before each classifier, unfused by default) match JAX at
``tests/test_zoo.py``'s (2, 32, 32, 3). f32 throughout: rtol 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu_torch.core.config import BayesConfig, DropoutKind, QuantConfig
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.nn.zoo import available_models, get_model
from test_torch_port_threefry import capture_site_keys

RATE = 0.25
TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = {"lenet1": (28, 28, 1), "lenet5": (28, 28, 1),
          "lenet_autobayes": (28, 28, 1), "alexnet": (67, 67, 3),
          "three_layer": (16,), "minimal_cnn": (28, 28, 1),
          "reduced_cnn": (28, 28, 1)}


def _perturb_biases(tree, rng):
    return {k: (_perturb_biases(v, rng) if isinstance(v, dict) else
                (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "bias" else v)
            for k, v in tree.items()}


def _match(jm, tm, x, keys=(3, 4)):
    """The port's spatial logits on the JAX init (biases perturbed) and
    the seeds JAX drew, against the jitted JAX logits."""
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    variables = {**v, "params": _perturb_biases(v["params"],
                                                np.random.default_rng(2))}
    load_flax_variables(tm, variables)
    want, seeds = capture_site_keys(jm, variables, x,
                                    [jax.random.key(k) for k in keys])
    with torch.inference_mode():
        got = tsampler.mc_logits(tm, torch.from_numpy(x),
                                 torch.from_numpy(seeds))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    return got


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_autobayes_models_match_jax(name):
    shape = SHAPES[name]
    x = np.random.default_rng(1).normal(size=(2,) + shape).astype(
        np.float32)
    jm = jax_get_model(name, bayes=JBayes(rate=RATE), fused=True)
    tm = get_model(name, bayes=BayesConfig(rate=RATE), fused=True,
                   input_shape=shape)
    plain = get_model(name, bayes=BayesConfig(rate=RATE), fused=False,
                      input_shape=shape)
    assert not tm.fused and tm.num_sites == 1
    assert ([(n, type(m)) for n, m in tm.named_children()]
            == [(n, type(m)) for n, m in plain.named_children()])
    _match(jm, tm, x)


def test_autobayes_builder_options():
    """``num_classes`` replaces the last Dense, ``bayes=None`` or kind
    NONE leaves the specs unconverted, ``quant`` and ``dtype`` reach the
    model, ``specs_kw`` the spec builder, and an unknown keyword is
    ignored, as in JAX."""
    m = get_model("lenet5", num_classes=7, dropout="block")
    assert m.output_shape == (7,) and m.num_sites == 0
    assert not any(n.startswith("bayes") for n, _ in m.named_children())
    m = get_model("minimal_cnn", specs_kw={"filters": 4, "dense_out": 3},
                  quant=QuantConfig(8, 0), dtype=torch.bfloat16,
                  bayes=BayesConfig(kind=DropoutKind.NONE))
    assert m.conv_0.kernel.shape == (4, 1, 3, 3) and m.output_shape == (3,)
    assert m.quant == QuantConfig(8, 0) and m.dtype == torch.bfloat16
    assert m.num_sites == 0
    assert get_model("lenet5", specs_kw={"include_top": False}
                     ).output_shape == (7, 7, 50)


@pytest.mark.parametrize("name", ["vgg16", "vgg19", "vgg19_me"])
def test_vgg16_19_match_jax(name):
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = jax_get_model(name, bayes=JBayes(rate=RATE))
    tm = get_model(name, bayes=BayesConfig(rate=RATE))
    exits = 5 if name == "vgg19_me" else 1
    assert tm.num_sites == (5 if name == "vgg19_me" else 0)
    got = _match(jm, tm, x, keys=(3,))
    assert got.shape == (1, exits, 2, 100)


@pytest.mark.parametrize("name", ["vgg16", "vgg19", "vgg19_me"])
def test_vgg_mixed_head_refuses(name):
    assert name in available_models()
    with pytest.raises(NotImplementedError, match="item 8"):
        get_model(name, mixed_head=True)
