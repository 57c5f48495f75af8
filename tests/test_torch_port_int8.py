"""The port's int8 operating point against the JAX package's, on the CPU.

- Rows 4 and 5 of the kernel table: ``dropout_matmul_int8`` and
  ``dropout_matmul_int8_samples`` (the port's plain versions, because the
  tensors lie on the CPU) against the JAX kernels in the Pallas interpreter,
  bit for bit; the int8 mask readout equals the float kernel's.
- One int8-executing ``ConvBN`` fed int8 input against JAX's.
- Full-width ``vgg11_me`` with ``QuantConfig(8, 0)``: the fake-quant eval
  model's logits and the int8 model's spatial predictive on the JAX
  package's weights (init variables with BatchNorm perturbed) and the seeds
  each JAX head passed to its kernel, captured by a test-local wrapper.
- One f32 QAT training step against ``jax.value_and_grad``, and the
  step of one quantized ConvBN and of one quantized MC head against
  ``jax.vjp``.
- The OOD noise probe and ``evaluate(ood_check=True)``.

``chip_smoke.py`` holds the CUDA kernels against the same plain versions
on the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.nn.fused as jfused
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import QuantConfig as JQuant
from bayestpu.core.rng import sample_keys
from bayestpu.engine import sampler as jsampler
from bayestpu.kernels import masked_matmul as jmm
from bayestpu.metrics import entropy as jentropy
from bayestpu.nn import layers as jlayers
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu.train.losses import eed_loss as jax_eed_loss
from bayestpu_torch.core.config import BayesConfig, QuantConfig
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.kernels import masked_matmul as tmm
from bayestpu_torch.metrics import entropy as tentropy
from bayestpu_torch.nn import layers as tlayers
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.losses import eed_loss

from port_threads import thread_budget  # noqa: F401

I = dict(interpret=True)
RATE = 0.25
STEP = 2.0 ** -7
Q8, INT8_Q = QuantConfig(8, 0), QuantConfig(8, 0, int8_infer=True)
JQ8, JINT8_Q = JQuant(8, 0), JQuant(8, 0, int8_infer=True)
HEAD, RAGGED = (128, 512, 10), (300, 700, 130)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _seeds(num, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.integers(-2 ** 31, 2 ** 31, size=(num, 2), dtype=np.int64)
    s[0] = (-5, -2 ** 31)                      # negative seeds, int32 min
    return s.astype(np.int32)


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(
        -128, 128, size=shape).astype(np.int8)


# --------------------------------------------------------- rows 4 and 5


@pytest.mark.parametrize("m,k,n", [HEAD, RAGGED])
def test_dropout_matmul_int8_equals_jax(m, k, n):
    x, w = _int8((m, k), m), _int8((k, n), k)
    seeds = _seeds(1)[0]
    want = np.asarray(jmm.dropout_matmul_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(seeds), RATE, STEP, STEP,
        **I))
    got = tmm.dropout_matmul_int8(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(seeds), RATE, STEP, STEP)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n,s", [HEAD + (10,), RAGGED + (3,)])
def test_dropout_matmul_int8_samples_equals_jax(m, k, n, s):
    """Bit for bit against the JAX samples kernel, and sample s bit-equal to
    the single-sample function with seeds[s]."""
    x, w = _int8((m, k), m + 1), _int8((k, n), k + 1)
    seeds = _seeds(s, seed=s)
    want = np.asarray(jmm.dropout_matmul_int8_samples(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(seeds), RATE, STEP,
        2 * STEP, **I))
    xt, wt, st = (torch.from_numpy(a) for a in (x, w, seeds))
    got = tmm.dropout_matmul_int8_samples(xt, wt, st, RATE, STEP, 2 * STEP)
    assert got.shape == (s, m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(s):
        assert torch.equal(got[i], tmm.dropout_matmul_int8(
            xt, wt, st[i], RATE, STEP, 2 * STEP))
    both = tmm.dropout_matmul_int8_inference(xt, wt, st, RATE, STEP,
                                             2 * STEP)
    one = tmm.dropout_matmul_int8_inference(xt, wt, st[0], RATE, STEP,
                                            2 * STEP)
    assert torch.equal(both, got) and torch.equal(one, got[0])


def test_int8_mask_readout_equals_float_kernel():
    """x_q = ones, w_q = eye: every output is 0 or out_scale, and the kept
    positions are the float kernel's (``test_pallas_kernels.py:151``)."""
    m, k = 40, 150
    seeds = _seeds(3, seed=5)
    ones, eye = np.ones((m, k), np.int8), np.eye(k, dtype=np.int8)
    got = tmm.dropout_matmul_int8_samples(
        torch.from_numpy(ones), torch.from_numpy(eye),
        torch.from_numpy(seeds), 0.3, STEP, STEP)
    scale = tmm.int8_out_scale(STEP, STEP, 0.3)
    assert set(np.unique(got.numpy()).tolist()) == {0.0, scale}
    fwd = tmm.dropout_matmul_samples(torch.ones(m, k), torch.eye(k),
                                     torch.from_numpy(seeds), 0.3)
    assert torch.equal(got != 0, fwd != 0)
    want = np.asarray(jmm.dropout_matmul_int8_samples(
        jnp.asarray(ones), jnp.asarray(eye), jnp.asarray(seeds), 0.3, STEP,
        STEP, **I))
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_scale_is_the_f32_of_the_double():
    """x_step·w_step/(1-rate) in double, then rounded once to f32."""
    got = tmm.int8_out_scale(STEP, STEP, RATE)
    assert got == float(np.float32(2.0 ** -14 / 0.75))
    assert got != 2.0 ** -14 / 0.75        # the double is not an f32


def test_int8_rate_zero_applies_no_mask():
    x, w = _int8((20, 24), 3), _int8((24, 8), 4)
    seeds = _seeds(2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    from bayestpu_torch.core.quant import int8_matmul
    want = int8_matmul(xt, wt, STEP, STEP)
    assert torch.equal(tmm.dropout_matmul_int8(
        xt, wt, torch.from_numpy(seeds[0]), 0.0, STEP, STEP), want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jmm.dropout_matmul_int8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(seeds[0]), 0.0, STEP,
            STEP, **I)))
    got = tmm.dropout_matmul_int8_samples(xt, wt, torch.from_numpy(seeds),
                                          0.0, STEP, STEP)
    assert all(torch.equal(got[s], want) for s in range(2))


def test_int8_wrappers_reject_bad_inputs():
    x, w = torch.zeros(4, 6, dtype=torch.int8), torch.zeros(6, 3,
                                                            dtype=torch.int8)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(TypeError):
        tmm.dropout_matmul_int8(x.float(), w, seeds, RATE, STEP, STEP)
    with pytest.raises(ValueError):
        tmm.dropout_matmul_int8(x, torch.zeros(5, 3, dtype=torch.int8),
                                seeds, RATE, STEP, STEP)
    with pytest.raises(ValueError):
        tmm.dropout_matmul_int8(x, w, seeds[None], RATE, STEP, STEP)
    with pytest.raises(ValueError):
        tmm.dropout_matmul_int8_samples(x, w, seeds, RATE, STEP, STEP)
    with pytest.raises(ValueError, match="device"):
        tmm.dropout_matmul_int8(
            torch.empty(4, 6, dtype=torch.int8, device="meta"),
            torch.empty(6, 3, dtype=torch.int8, device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta"), RATE, STEP,
            STEP)


# -------------------------------------------------------------- ConvBN


def test_int8_convbn_equals_jax():
    """An int8-executing ConvBN (128 → 256 channels at 8², the int8 model's
    block2) fed int8 input emits int8 equal to JAX's, or one grid step
    apart where the f32 epilogue value lies within 1e-6 of a rounding
    boundary (the int32 conv is exact; the f32 epilogue may contract to an
    FMA in one package)."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 128, size=(2, 8, 8, 128)).astype(np.int8)
    kernel = rng.normal(scale=0.04, size=(3, 3, 128, 256)).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, 256).astype(np.float32),
          "bias": rng.normal(scale=0.2, size=256).astype(np.float32)}
    stats = {"mean": rng.normal(scale=0.3, size=256).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 256).astype(np.float32)}
    jl = jlayers.ConvBN(256, quant=JINT8_Q, dtype=jnp.bfloat16)
    variables = {"params": {"conv": {"kernel": kernel}, "bn": bn},
                 "batch_stats": {"bn": stats}}
    want = np.asarray(jl.apply(variables, jnp.asarray(x), act="relu",
                               act_quant=True))
    assert want.dtype == np.int8
    tl = tlayers.ConvBN(128, 256, quant=INT8_Q, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        tl.conv.kernel.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        for k, v in bn.items():
            getattr(tl.bn, k).copy_(torch.from_numpy(v))
        for k, v in stats.items():
            getattr(tl.bn, k).copy_(torch.from_numpy(v))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tl(xt, act="relu", act_quant=True).permute(0, 2, 3, 1).numpy()
        y = tl(xt, act="relu").permute(0, 2, 3, 1).numpy() / STEP
    assert got.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    near = np.abs(np.abs(y - np.floor(y)) - 0.5) * STEP <= 1e-6
    assert diff.max() <= 1 and bool(near[diff > 0].all())
    assert (diff > 0).mean() <= 1e-3
    assert len(np.unique(want)) > 20            # the grid is exercised


# ------------------------------------------------------------- vgg11_me


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
def qat_vars():
    """JAX QAT vgg11_me init variables (BatchNorm perturbed) and an input
    batch of 3."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JQ8)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    return x, {"params": _perturb(v["params"], rng),
               "batch_stats": _perturb(v["batch_stats"], rng)}


def _capture(model, variables, x, keys, fn_name):
    """Per-sample JAX logits (S, E, B, C) and the seeds every head passed
    to ``bayestpu.nn.fused.<fn_name>`` (S, n_sites, 2)."""
    seen = []
    orig = getattr(jfused, fn_name)

    def spy(xx, w, seeds, rate, *args, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, rate, *args, **kw)

    logits, seeds = [], []
    setattr(jfused, fn_name, spy)
    try:
        for i, k in enumerate(keys):
            seen.clear()
            out = model.apply(variables, jnp.asarray(x), sample_idx=i,
                              train=False, rngs={"bayes": k})
            logits.append(np.asarray(out.logits))
            seeds.append(np.stack(seen))
    finally:
        setattr(jfused, fn_name, orig)
    return np.stack(logits), np.stack(seeds).astype(np.int32)


def _port(variables, quant, dtype):
    model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True,
                      quant=quant, dtype=dtype)
    return load_flax_variables(model, variables).eval()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_fake_quant_eval_logits_match_jax(qat_vars, name):
    """The QAT eval model (BN as an f32 epilogue, fake-quant activations)
    with captured seeds, S=2. f32: rtol/atol 1e-5 for summation order
    (measured ≤ 1.5e-7; one activation moved by a grid step would show as
    ~1e-3). bf16: the convs on grid values sum exactly in f32 in both
    packages, but the entry conv's raw input may round differently in XLA
    and oneDNN: atol 0.02, as the float bf16 model's test."""
    x, variables = qat_vars
    jdt, tdt = DTYPES[name]
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JQ8, dtype=jdt)
    keys = [jax.random.fold_in(jax.random.key(3), i) for i in range(2)]
    want, seeds = _capture(jm, variables, x, keys, "dropout_matmul_inference")
    assert seeds.shape == (2, 5, 2)
    with torch.inference_mode():
        out = _port(variables, Q8, tdt)(torch.from_numpy(x),
                                        torch.from_numpy(seeds))
    assert out.logits.dtype == torch.float32
    tol = (dict(rtol=1e-5, atol=1e-5) if name == "f32"
           else dict(rtol=0.02, atol=0.02))
    np.testing.assert_allclose(out.logits.numpy(), want, **tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_int8_spatial_predictive_matches_jax(qat_vars, name):
    """The int8 model (int8 activations between layers, int8 convs where
    ``_int8_conv_on_mxu`` routes them, the int8 MC heads) on the seeds the
    JAX heads drew, S=3. Its per-sample logits agree with JAX's to 1e-5 (the
    int32 sums are exact and the float-branch convs take grid values;
    measured 0.0); probabilities to 1e-5; spatial equals temporal bit for
    bit; and the int8 model is not the fake-quant one."""
    x, variables = qat_vars
    jdt, tdt = DTYPES[name]
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JINT8_Q, dtype=jdt)
    pkey, s = jax.random.key(5), 3
    keys = sample_keys(pkey, s)
    want, seeds = _capture(jm, variables, x, keys,
                           "dropout_matmul_int8_inference")
    jpred = jsampler.predictive(jm, variables, jnp.asarray(x), pkey, s)
    model = _port(variables, INT8_Q, tdt)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
        temporal = tsampler.mc_logits(
            model, xt, st, tsampler.SamplingMode.TEMPORAL)
        pred = tsampler.predictive(model, xt, st)
        fq = _port(variables, Q8, tdt)(xt, st).logits
    np.testing.assert_allclose(spatial.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(spatial, temporal)
    np.testing.assert_allclose(pred.probs.numpy(), np.asarray(jpred.probs),
                               rtol=1e-5, atol=1e-6)
    assert not torch.equal(fq, spatial)
    # the masks matter: the heads' samples differ
    assert not torch.equal(spatial[0], spatial[1])


def test_int8_model_activations_stay_int8(qat_vars):
    """Blocks hand int8 to each other; the features reach the metrics as
    f32 on the grid."""
    x, variables = qat_vars
    model = _port(variables, INT8_Q, torch.bfloat16)
    seen = {}
    hooks = [getattr(model, f"block{i}").register_forward_hook(
        lambda m, a, out, i=i: seen.__setitem__(i, out.dtype))
        for i in range(5)]
    with torch.inference_mode():
        out = model(torch.from_numpy(x), torch.zeros(5, 2, dtype=torch.int32))
    for h in hooks:
        h.remove()
    assert set(seen.values()) == {torch.int8}
    feat = out.features[-1]
    assert feat.dtype == torch.float32
    assert torch.equal(feat, torch.round(feat / STEP) * STEP)


def test_qat_variables_load_by_name(qat_vars):
    """QuantConfig adds no parameters: the JAX QAT variables fill the
    quantized port model by name, and the float model's names are the
    same."""
    _, variables = qat_vars
    q = _port(variables, INT8_Q, torch.float32)
    f = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True)
    assert [n for n, _ in q.named_parameters()] == [
        n for n, _ in f.named_parameters()]
    np.testing.assert_array_equal(
        q.block3.convbn1.conv.kernel.detach().numpy(),
        variables["params"]["block3"]["convbn1"]["conv"]["kernel"].transpose(
            3, 2, 0, 1))
    np.testing.assert_array_equal(
        q.exit2.convbn2.bn.var.numpy(),
        variables["batch_stats"]["exit2"]["convbn2"]["bn"]["var"])


def test_quant_overrides_and_mixed_head_raise():
    """Per-layer overrides and ``mixed_head`` (ported since they raised):
    every layer's config equals the JAX model's ``_q`` at each key JAX
    consults, and the layers carry it."""
    import dataclasses
    ov = {"fc_0": JQuant(8, 1), "fc_1/bias": JQuant(16, 0), "bogus": None}
    tov = {k: None if v is None else QuantConfig(**dataclasses.asdict(v))
           for k, v in ov.items()}
    for kw, tkw in ((dict(quant_overrides=ov), dict(quant_overrides=tov)),
                    (dict(mixed_head=True), dict(mixed_head=True))):
        jm = jax_get_model("vgg11_me", quant=JINT8_Q, **kw)
        tm = get_model("vgg11_me", quant=INT8_Q, **tkw)
        for key in ("block0", "block4", "fc_0", "fc_0/bias", "fc_1",
                    "fc_relu_0", "fc_relu_1", "classifier"):
            want, got = jm._q(key), tm._q(key)
            assert (None if want is None else dataclasses.asdict(want)) == (
                None if got is None else dataclasses.asdict(got)), key
        assert tm.fc_0.quant == tm._q("fc_0")
        assert tm.fc_relu_0.quant == tm._q("fc_relu_0")
        assert tm.classifier.quant == tm._q("classifier")
        assert tm.block0.quant == tm._q("block0")
    # the bias grid only where named (vgg.py:262-266)
    assert tm.fc_0.bias_quant.total_bits == 16 and tm.fc_1.bias_quant is None


# --------------------------------------------------------------- QAT step


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _jax_qat_grads(variables, x, y):
    """Loss and gradients of one f32 QAT step of the JAX model, and the
    seeds its heads drew."""
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=RATE), fused=True,
                       quant=JQ8)
    seen = []
    orig = jfused.dropout_matmul

    def spy(xx, w, seeds, r, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, r, **kw)

    def loss_fn(params):
        o, _ = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        jnp.asarray(x), train=True,
                        rngs={"bayes": jax.random.key(5)},
                        mutable=["batch_stats"])
        return jax_eed_loss(o.logits, jnp.asarray(y), o.features)

    jfused.dropout_matmul = spy
    try:
        loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    finally:
        jfused.dropout_matmul = orig
    return (float(loss), _flat(jax.tree.map(np.asarray, grads)),
            np.stack(seen).astype(np.int32))


# fc_0 feeds fc_bn_0, a batch-statistics BatchNorm, so its bias gradient is
# zero in exact arithmetic and only rounding in both packages
ZERO_GRAD = {"fc_0.bias"}


def _norm_err(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_qat_train_step_matches_jax(qat_vars):
    """One f32 QAT step at batch 3 (fake-quant kernels, biases and
    activations, straight-through gradients): the loss to 1e-6 and every
    gradient by name to 3e-4 of its norm, as the float step's test, against
    JAX's step at x or at nextafter(x), whichever has the nearer loss. The
    ZERO_GRAD leaves are held below 1e-8 of the whole gradient's norm.

    Why two JAX steps: the QAT forward is discontinuous. A fake-quant after
    a batch-statistics BatchNorm turns a last-bit difference into a whole
    grid step for an element next to a rounding boundary; that step moves
    the next layer's batch statistics for whole channels, which flips more
    elements (measured at this input, the port against JAX at x: 1 of
    block0's 196,608 outputs differs, 56 of block1's, 4,845 of block3's),
    and the gradients move by up to 90% of their norm. Which elements flip
    depends on the last bit of each conv's sums, so one ulp of input moves
    JAX's own step as far. At this input the port's step is JAX's at
    nextafter(x): loss to 7e-8, gradients to 9e-5 of their norm (measured).
    The layer tests below hold each layer's step to JAX's without the
    choice."""
    x, variables = qat_vars
    y = np.array([0, 3, 7], np.int32)
    steps = [_jax_qat_grads(variables, xx, y)
             for xx in (x, np.nextafter(x, np.float32(np.inf)))]
    seeds = steps[0][2]
    assert seeds.shape == (5, 2) and np.array_equal(seeds, steps[1][2])
    model = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=RATE), fused=True, quant=Q8),
        variables).train()
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(x), torch.from_numpy(seeds))
    loss = eed_loss(out.logits, torch.from_numpy(y), out.features)
    grads = torch.autograd.grad(loss, list(params.values()))
    loss = float(loss.detach())
    jloss, want, _ = min(steps, key=lambda st: abs(st[0] - loss))
    assert loss == pytest.approx(jloss, rel=1e-6)
    assert set(params) == set(want)
    total = np.sqrt(sum(np.linalg.norm(v) ** 2 for v in want.values()))
    assert {k for k, v in want.items()
            if np.linalg.norm(v) < 1e-8 * total} == ZERO_GRAD
    for name, g in zip(params, grads):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        if name in ZERO_GRAD:
            assert np.linalg.norm(g) < 1e-8 * total, name
        else:
            assert _norm_err(g, want[name]) <= 3e-4, (
                name, _norm_err(g, want[name]))


def test_qat_convbn_train_step_matches_jax():
    """One quantized ConvBN in training (fake-quant kernel, conv, BatchNorm
    with batch statistics, relu, unsigned fake-quant) against JAX's, 64 →
    128 channels at 16², batch 4, on one f32 input and cotangent. The
    output is equal, or one grid step apart where the value before the
    fake-quant lies within 1e-6 of a rounding boundary (at most 1e-4 of
    the elements). The gradients of x, the kernel and BN's scale and bias
    match to 3e-4 of their norm: the straight-through estimator passes the
    cotangent past the fake-quants, so a flipped element does not move
    them (measured ≤ 3e-6). The batch statistics match to 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, size=(4, 16, 16, 64)).astype(np.float32)
    kernel = rng.normal(scale=0.05, size=(3, 3, 64, 128)).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, 128).astype(np.float32),
          "bias": rng.normal(scale=0.2, size=128).astype(np.float32)}
    stats = {"mean": np.zeros(128, np.float32),
             "var": np.ones(128, np.float32)}
    cot = rng.normal(size=(4, 16, 16, 128)).astype(np.float32)
    jl = jlayers.ConvBN(128, quant=JQ8)

    def f(params, xx):
        return jl.apply({"params": params, "batch_stats": {"bn": stats}}, xx,
                        train=True, act="relu", act_quant=True,
                        mutable=["batch_stats"])

    want, vjp, upd = jax.vjp(f, {"conv": {"kernel": kernel}, "bn": bn},
                             jnp.asarray(x), has_aux=True)
    jgp, jgx = vjp(jnp.asarray(cot))
    tl = tlayers.ConvBN(64, 128, quant=Q8).train()
    with torch.no_grad():
        tl.conv.kernel.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        for k, v in bn.items():
            getattr(tl.bn, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tl(xt, act="relu", act_quant=True)
    gx, gk, gs, gb = torch.autograd.grad(
        got, [xt, tl.conv.kernel, tl.bn.scale, tl.bn.bias],
        torch.from_numpy(cot).permute(0, 3, 1, 2))
    running = {k: getattr(tl.bn, k).clone() for k in ("mean", "var")}
    with torch.no_grad():
        pre = tl(xt, act="relu").permute(0, 2, 3, 1).numpy() / STEP
    got = got.detach().permute(0, 2, 3, 1).numpy()
    diff = np.abs(got - np.asarray(want)) / STEP
    near = np.abs(np.abs(pre - np.floor(pre)) - 0.5) * STEP <= 1e-6
    assert np.all((diff == 0) | ((diff == 1) & near))
    assert (diff > 0).mean() <= 1e-4
    assert len(np.unique(got)) > 100            # the grid is exercised
    for g, w in ((gx.permute(0, 2, 3, 1), jgx),
                 (gk.permute(2, 3, 1, 0), jgp["conv"]["kernel"]),
                 (gs, jgp["bn"]["scale"]), (gb, jgp["bn"]["bias"])):
        assert _norm_err(g.numpy(), np.asarray(w)) <= 3e-4
    for k in ("mean", "var"):
        np.testing.assert_allclose(running[k].numpy(),
                                   upd["batch_stats"]["bn"][k], rtol=1e-5,
                                   atol=1e-6)


def test_qat_head_train_step_matches_jax():
    """A quantized MC head in training (fake-quant kernel and bias, the
    trainable ``dropout_matmul`` on the seeds JAX drew, straight-through
    gradients) against JAX's ``BayesDense``, 512 → 10 at batch 16: the
    output and the gradients of x, the kernel and the bias to 1e-5 of their
    norm (f32 sums in another order; measured ≤ 1e-7)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(16, 512)).astype(np.float32)
    params = {"kernel": rng.normal(scale=0.1, size=(512, 10)).astype(
        np.float32), "bias": rng.normal(scale=0.1, size=10).astype(np.float32)}
    cot = rng.normal(size=(16, 10)).astype(np.float32)
    jl = jfused.BayesDense(10, bayes=JBayes(rate=RATE), quant=JQ8)
    seen = []
    orig = jfused.dropout_matmul

    def spy(xx, w, seeds, r, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, r, **kw)

    jfused.dropout_matmul = spy
    try:
        want, vjp = jax.vjp(lambda p, xx: jl.apply(
            {"params": p}, xx, train=True,
            rngs={"bayes": jax.random.key(7)}), params, jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(cot))
    finally:
        jfused.dropout_matmul = orig
    from bayestpu_torch.nn.fused import BayesDense
    tl = BayesDense(512, 10, bayes=BayesConfig(rate=RATE), quant=Q8).train()
    with torch.no_grad():
        tl.kernel.copy_(torch.from_numpy(params["kernel"]))
        tl.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).requires_grad_()
    got = tl(xt, torch.from_numpy(seen[0].astype(np.int32)))
    gx, gk, gb = torch.autograd.grad(got, [xt, tl.kernel, tl.bias],
                                     torch.from_numpy(cot))
    for g, w in ((got.detach(), want), (gx, jgx), (gk, jgp["kernel"]),
                 (gb, jgp["bias"])):
        assert _norm_err(g.numpy(), np.asarray(w)) <= 1e-5


def test_qat_train_step_straight_through():
    """The QAT model's gradients pass the fake-quant of kernels and biases
    as the identity: the gradient of a quantized head's kernel and bias
    equals that of the float model on the same forward activations (at
    rate 0, with fake-quant weights loaded into the float model)."""
    rng = np.random.default_rng(4)
    model = get_model("vgg11_me", bayes=BayesConfig(rate=0.0), fused=True,
                      quant=Q8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    head = model.classifier
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(rng.normal(
            scale=0.1, size=tuple(head.kernel.shape)).astype(np.float32)))
        head.bias.copy_(torch.from_numpy(rng.normal(
            scale=0.1, size=tuple(head.bias.shape)).astype(np.float32)))
    model.train()
    feats = {}
    head.register_forward_hook(lambda m, a, o: feats.__setitem__("x", a[0]))
    out = model(x, torch.zeros(0, 2, dtype=torch.int32))
    gk, gb = torch.autograd.grad(out.logits[-1].sum(), (head.kernel,
                                                        head.bias))
    xin = feats["x"].detach()
    np.testing.assert_allclose(gk.numpy(), (xin.T @ torch.ones(2, 10)).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gb.numpy(), np.full(10, 2.0, np.float32))


# ------------------------------------------------------------ OOD probe


def test_random_noise_data_shape_stats_and_standardisation():
    """The port draws with a torch.Generator, JAX with threefry: the values
    differ, the distribution does not. Moments over 2·10⁵ values per
    channel agree to a few standard errors; the standardisation is
    (noise − DATASET mean) / DATASET std."""
    shape = (200, 32, 32, 3)
    gen = torch.Generator().manual_seed(99)
    raw = tentropy.random_noise_data(gen, "cifar10", shape, normalized=False)
    gen = torch.Generator().manual_seed(99)
    norm = tentropy.random_noise_data(gen, "cifar10", shape)
    assert raw.shape == norm.shape == shape and norm.dtype == torch.float32
    from bayestpu_torch.data.datasets import DATASET_STATS
    nm, ns = (torch.tensor(v) for v in DATASET_STATS["cifar10"])
    torch.testing.assert_close(norm, (raw - nm) / ns)
    want = np.asarray(jentropy.random_noise_data(jax.random.key(99),
                                                 "cifar10", shape))
    got = norm.reshape(-1, 3).numpy()
    want = want.reshape(-1, 3)
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.01)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.01)
    mean, std = jentropy.NOISE_STATS["cifar10"]
    np.testing.assert_allclose(raw.reshape(-1, 3).mean(0).numpy(), mean,
                               atol=0.003)
    np.testing.assert_allclose(raw.reshape(-1, 3).std(0).numpy(), std,
                               rtol=0.01)
    assert tentropy.NOISE_STATS == jentropy.NOISE_STATS
    g1 = tentropy.random_noise_data(torch.Generator().manual_seed(1),
                                    "mnist", (4, 3, 3, 1))
    g2 = tentropy.random_noise_data(torch.Generator().manual_seed(1),
                                    "mnist", (4, 3, 3, 1))
    assert torch.equal(g1, g2)
    with pytest.raises(ValueError, match="channels"):
        tentropy.random_noise_data(gen, "cifar10", (2, 4, 4, 1))
    with pytest.raises(KeyError):
        tentropy.random_noise_data(gen, "bogus", (2, 4, 4, 3))


def test_evaluate_ood_check_returns_ape_ood():
    """aPE_ood is the aPE of the same seed's predictive on the noise probe,
    with the dataset's fixed stats or, without a dataset, x's moments."""
    model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True,
                      quant=INT8_Q, dtype=torch.bfloat16)
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    y = np.array([0, 1, 2, 3])
    eng = BayesEngine(model, device="cpu").init(0, x)
    mets = eng.evaluate(x, y, seed=2, num_samples=3, ood_check=True,
                        dataset="cifar10")
    assert set(mets) == {"acc", "nll", "mse", "ece_hist", "ece_ew10", "aPE",
                         "aPE_ood"}
    assert 0.0 <= mets["aPE_ood"] <= np.log(10) + 1e-6
    noise = tentropy.random_noise_data(torch.Generator().manual_seed(99),
                                       "cifar10", x.shape)
    want = float(tentropy.mean_predictive_entropy(
        eng.predict(noise, 2, 3).probs[-1]))
    assert mets["aPE_ood"] == pytest.approx(want, rel=1e-6)
    plain = eng.evaluate(x, y, seed=2, num_samples=3)
    assert plain["aPE"] == mets["aPE"] and "aPE_ood" not in plain
    moments = eng.evaluate(x, y, seed=2, num_samples=3, ood_check=True)
    assert np.isfinite(moments["aPE_ood"])
    assert moments["aPE_ood"] != mets["aPE_ood"]

