"""The port's ``vgg11`` with fused block sites against the JAX package's,
on the CPU.

``get_model("vgg11", fused=True, dropout="block")`` puts a Bayesian site on
the input of blocks 1-4, fused into each block's first conv
(``BayesConv``, the masked-conv kernels), besides the MC classifier head.
At full width and batch 2, on the JAX init variables with BatchNorm
perturbed:

- MC logits in f32 and bf16 on the seeds each JAX site passed to its
  kernel (captured by wrapping ``bayestpu.nn.fused.dropout_conv_inference``
  and ``dropout_matmul_inference``), the port's spatial mapping against
  JAX's per-sample applies, and the spatial predictive against JAX's
  ``sampler.predictive``;
- Masksembles per-mask logits;
- the int8 MC and Masksembles models, mapping by mapping (JAX's own int8
  spatial and temporal logits differ), in grid steps;
- one f32 MC training step against ``jax.value_and_grad`` and one QAT
  ``ConvBN`` with a site against ``jax.vjp``;
- the conv-site banks loaded from Flax and round-tripped.

The JAX kernels run in the Pallas interpreter, as the JAX package's own
tests run them; the port's wrappers take their plain versions because the
tensors lie on the CPU.
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
from bayestpu.nn import layers as jlayers
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu.train.losses import eed_loss as jax_eed_loss
from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                        QuantConfig, SamplingMode)
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.kernels import masked_conv as tmc
from bayestpu_torch.nn import layers as tlayers
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.losses import eed_loss

from port_threads import thread_budget  # noqa: F401

RATE = 0.25
MC, JMC = BayesConfig(rate=RATE), JBayes(rate=RATE)
MASK = BayesConfig(kind=DropoutKind.MASK, num_masks=4, scale=2.0)
JMASK = JBayes(kind=JKind.MASK, num_masks=4, scale=2.0)
Q8, INT8_Q = QuantConfig(8, 0), QuantConfig(8, 0, int8_infer=True)
JQ8, JINT8_Q = JQuant(8, 0), JQuant(8, 0, int8_infer=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
STEP = 2.0 ** -7
SITE_BANKS = {"block1": 64, "block2": 128, "block3": 256, "block4": 512}


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


def _jax_model(bayes, dtype=jnp.float32, quant=None):
    return jax_get_model("vgg11", bayes=bayes, fused=True, dropout="block",
                         dtype=dtype, quant=quant)


def _port(variables, bayes=MC, dtype=torch.float32, quant=None):
    model = get_model("vgg11", bayes=bayes, fused=True, dropout="block",
                      dtype=dtype, quant=quant)
    return load_flax_variables(model, variables).eval()


@pytest.fixture(scope="module")
def block_vars():
    """An input batch of 2, the JAX Masksembles model's init variables (its
    ``masks`` tree holds the five banks) with BatchNorm perturbed, and the
    same tree without ``masks`` for the MC model (same parameter names)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, _jax_model(JMASK).init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    mask_vars = {"params": _perturb(v["params"], rng),
                 "batch_stats": _perturb(v["batch_stats"], rng),
                 "masks": v["masks"]}
    mc_vars = {k: mask_vars[k] for k in ("params", "batch_stats")}
    return x, mc_vars, mask_vars


def _capture(model, variables, x, keys, fn_names):
    """JAX per-sample logits (S, E, B, C), one apply per key as the
    temporal mapping runs them, and the seeds (S, n_sites, 2) that the
    sites passed to ``bayestpu.nn.fused.<fn_names>``, in call order."""
    seen = []
    origs = {n: getattr(jfused, n) for n in fn_names}

    def spy(orig):
        def f(xx, w, seeds, *args, **kw):
            seen.append(np.asarray(seeds))
            return orig(xx, w, seeds, *args, **kw)
        return f

    logits, seeds = [], []
    for n, f in origs.items():
        setattr(jfused, n, spy(f))
    try:
        for i, k in enumerate(keys):
            seen.clear()
            out = model.apply(variables, jnp.asarray(x), sample_idx=i,
                              train=False, rngs={"bayes": k})
            logits.append(np.asarray(out.logits))
            seeds.append(np.stack(seen))
    finally:
        for n, f in origs.items():
            setattr(jfused, n, f)
    return np.stack(logits), np.stack(seeds).astype(np.int32)


MC_SITES = ("dropout_conv_inference", "dropout_matmul_inference")


@pytest.fixture(scope="module")
def mc_f32(block_vars):
    """The f32 MC model: JAX per-sample logits and seeds (S=2), and JAX's
    spatial predictive from the same key."""
    x, variables, _ = block_vars
    jm = _jax_model(JMC)
    key = jax.random.key(5)
    want, seeds = _capture(jm, variables, x, sample_keys(key, 2), MC_SITES)
    pred = jsampler.predictive(jm, variables, jnp.asarray(x), key, 2)
    return want, seeds, pred


def test_block_model_structure(block_vars):
    """Sites in JAX call order: block1…block4, then the classifier; the
    Masksembles model has none (its banks are buffers)."""
    _, variables, mask_vars = block_vars
    model = _port(variables)
    assert model.num_sites == 5
    assert [getattr(model, f"block{i}").convbn0.conv.site
            for i in range(1, 5)] == [0, 1, 2, 3]
    assert model.classifier.site == 4
    assert model.block0.convbn0.conv.site is None
    mask = _port(mask_vars, MASK)
    assert mask.num_sites == 0 and mask.masked
    assert {name for name, _ in mask.named_buffers()
            if name.endswith("bank")} == {
        *(f"{b}.convbn0.conv.bank" for b in SITE_BANKS), "classifier.bank"}


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_block_mc_logits_match_jax(block_vars, mc_f32, name):
    """Per-sample logits on the captured seeds (5 sites, S=2): the port's
    spatial mapping (block 1's site in one samples call, blocks 2-4 and the
    head once per sample) and its temporal one against JAX's applies. f32:
    rtol/atol 1e-5 (the masked convs sum exact products in another order;
    measured 9.5e-7 on logits up to 0.83). bf16: atol 0.02, as the bf16
    vgg11_me test (XLA and oneDNN round the bf16 convs at other points;
    measured 0.0027)."""
    x, variables, _ = block_vars
    jdt, tdt = DTYPES[name]
    if name == "f32":
        want, seeds, _ = mc_f32
    else:
        want, seeds = _capture(_jax_model(JMC, jdt), variables, x,
                               sample_keys(jax.random.key(5), 2), MC_SITES)
    assert seeds.shape == (2, 5, 2)
    np.testing.assert_array_equal(seeds, mc_f32[1])  # the same key
    model = _port(variables, dtype=tdt)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
        temporal = tsampler.mc_logits(model, xt, st, SamplingMode.TEMPORAL)
    tol = (dict(rtol=1e-5, atol=1e-5) if name == "f32"
           else dict(rtol=0.02, atol=0.02))
    np.testing.assert_allclose(spatial.numpy(), want, **tol)
    np.testing.assert_allclose(temporal.numpy(), want, **tol)
    assert not torch.equal(spatial[0], spatial[1])   # the masks matter


def test_block_mc_spatial_predictive_matches_jax(block_vars, mc_f32):
    """The port's spatial predictive on the captured seeds against JAX's
    ``sampler.predictive`` (vmap over the sample keys: one
    ``dropout_conv_samples`` at block 1, ``lax.map`` after it), and the
    model's features carry the sample axis."""
    x, variables, _ = block_vars
    _, seeds, jpred = mc_f32
    model = _port(variables)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        pred = tsampler.predictive(model, xt, st)
        out = model(xt, st)
    np.testing.assert_allclose(pred.probs.numpy(), np.asarray(jpred.probs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.entropy.numpy(),
                               np.asarray(jpred.entropy), rtol=1e-5,
                               atol=1e-6)
    assert out.logits.shape == (2, 1, 2, 10)
    assert out.features.shape == (2, 1, 2, 512)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_block_mask_logits_match_jax(block_vars, name):
    """Masksembles per-mask logits (the bank rows of each site by index,
    4 wrapping to 0) against JAX's applies with ``sample_idx=i``; the
    port's spatial mapping over indices (0, 2, 4) equals its one-index
    calls bit for bit. Tolerances as the MC test's (measured 1.3e-7 in
    f32, 0.00037 in bf16)."""
    x, _, variables = block_vars
    jdt, tdt = DTYPES[name]
    jm = _jax_model(JMASK, jdt)
    idxs = (0, 2, 4)
    want = np.stack([np.asarray(jm.apply(variables, jnp.asarray(x),
                                         sample_idx=i).logits)
                     for i in idxs])
    model = _port(variables, MASK, tdt)
    xt = torch.from_numpy(x)
    seeds = torch.zeros(len(idxs), 0, 2, dtype=torch.int32)
    with torch.inference_mode():
        spatial = model(xt, seeds, torch.tensor(idxs)).logits
        ones = [model(xt, seeds[0], i).logits for i in idxs]
    tol = (dict(rtol=1e-5, atol=1e-5) if name == "f32"
           else dict(rtol=0.02, atol=0.02))
    np.testing.assert_allclose(spatial.numpy(), want, **tol)
    for s in range(len(idxs)):
        assert torch.equal(spatial[s], ones[s])
    np.testing.assert_array_equal(ones[0].numpy(), ones[2].numpy())


def _grid_steps(got, want, model):
    """|got − want| over one grid step of a head's int8 input through the
    widest column of the classifier's quantized kernel."""
    from bayestpu_torch.core.quant import fake_quant
    col = torch.linalg.vector_norm(fake_quant(model.classifier.kernel,
                                              INT8_Q), dim=0).max().item()
    return np.abs(got - want).max() / (STEP * col / (1 - RATE))


@pytest.mark.parametrize("kind", ["mc", "mask"])
def test_block_int8_matches_jax_mapping_by_mapping(block_vars, kind):
    """The int8 model (bf16 compute): block 1's site (64 channels at 16²,
    not int8-executed) runs the float masked kernel on grid values with an
    int8 store, blocks 2-4 and the head the int8 kernels. JAX's own int8
    spatial and temporal logits differ, so each mapping is held to JAX's
    same mapping, within two grid steps of a head input through the
    classifier's widest column (measured 0.0 for both models and both
    mappings on these inputs), and the port's two mappings agree with
    each other as well."""
    x, mc_vars, mask_vars = block_vars
    jm = _jax_model(JMC if kind == "mc" else JMASK, jnp.bfloat16, JINT8_Q)
    key = jax.random.key(7)
    if kind == "mc":
        variables = mc_vars
        want_tm, seeds = _capture(
            jm, variables, x, sample_keys(key, 2),
            ("dropout_conv_inference", "dropout_conv_int8_inference",
             "dropout_matmul_int8_inference"))
        assert seeds.shape == (2, 5, 2)
    else:
        variables = mask_vars
        want_tm = np.stack([np.asarray(jm.apply(
            variables, jnp.asarray(x), sample_idx=i).logits)
            for i in range(2)])
        seeds = np.zeros((2, 0, 2), np.int32)
    want_sp = np.asarray(jsampler.mc_logits(jm, variables, jnp.asarray(x),
                                            key, 2))
    model = _port(variables, MC if kind == "mc" else MASK, torch.bfloat16,
                  INT8_Q)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st).numpy()
        temporal = tsampler.mc_logits(model, xt, st,
                                      SamplingMode.TEMPORAL).numpy()
    assert _grid_steps(temporal, want_tm, model) <= 2.0
    assert _grid_steps(spatial, want_sp, model) <= 2.0
    assert _grid_steps(spatial, temporal, model) <= 2.0


def test_block_int8_sites_run_the_int8_kernels(block_vars, monkeypatch):
    """Which kernel each int8 site calls: block 1's site the float masked
    conv with an int8 store, blocks 2-4 the int8 one, all emitting int8."""
    x, variables, _ = block_vars
    calls = []
    import bayestpu_torch.nn.fused as tfused
    for name in ("dropout_conv_inference", "dropout_conv_int8_inference"):
        orig = getattr(tfused, name)

        def spy(xx, *a, _n=name, _o=orig, **kw):
            y = _o(xx, *a, **kw)
            calls.append((_n, xx.dtype, y.dtype))
            return y
        monkeypatch.setattr(tfused, name, spy)
    model = _port(variables, dtype=torch.bfloat16, quant=INT8_Q)
    with torch.inference_mode():
        model(torch.from_numpy(x), torch.zeros(5, 2, dtype=torch.int32))
    assert calls == [("dropout_conv_inference", torch.bfloat16, torch.int8)] \
        + [("dropout_conv_int8_inference", torch.int8, torch.int8)] * 3


# ------------------------------------------------------------- training


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _hwio(t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def test_block_train_step_matches_jax(block_vars):
    """One f32 MC training step, batch 4: the seeds of JAX's
    ``dropout_conv`` (four sites) and ``dropout_matmul`` (the head), the
    EED loss and every gradient by name, each to 3e-4 of its norm
    (summation order amplified by train-mode BatchNorm at batch 4, as the
    vgg11_me step test), and the BatchNorm statistics."""
    _, variables, _ = block_vars
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 3, 7, 3], np.int32)
    jm = _jax_model(JMC)
    seen = []
    origs = {n: getattr(jfused, n) for n in ("dropout_conv",
                                             "dropout_matmul")}

    def spy(orig):
        def f(xx, w, seeds, *args, **kw):
            seen.append(np.asarray(seeds))
            return orig(xx, w, seeds, *args, **kw)
        return f

    def loss_fn(params, bs):
        o, upd = jm.apply({"params": params, "batch_stats": bs},
                          jnp.asarray(x), train=True,
                          rngs={"bayes": jax.random.key(9)},
                          mutable=["batch_stats"])
        return jax_eed_loss(o.logits, jnp.asarray(y), o.features), upd

    for n, f in origs.items():
        setattr(jfused, n, spy(f))
    try:
        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"], variables["batch_stats"])
    finally:
        for n, f in origs.items():
            setattr(jfused, n, f)
    seeds = np.stack(seen).astype(np.int32)
    assert seeds.shape == (5, 2)
    model = load_flax_variables(get_model(
        "vgg11", bayes=MC, fused=True, dropout="block"), variables).train()
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(x), torch.from_numpy(seeds))
    tloss = eed_loss(out.logits, torch.from_numpy(y), out.features)
    tgrads = dict(zip(params, torch.autograd.grad(tloss,
                                                  list(params.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, grads))
    assert set(want) == set(tgrads)
    # fc_0.bias feeds a train-mode BatchNorm: its gradient is 0 in exact
    # arithmetic and roundoff in both packages, held below 1e-6 of the
    # whole gradient's norm
    total = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in want.values()))
    for k, g in tgrads.items():
        err = np.linalg.norm(_hwio(g) - want[k])
        assert err <= 3e-4 * np.linalg.norm(want[k]) + 1e-6 * total, (k, err)
    bstats = _flat(to_flax_variables(model)["batch_stats"])
    jstats = _flat(jax.tree.map(np.asarray, upd["batch_stats"]))
    for k, v in jstats.items():
        assert np.linalg.norm(bstats[k] - v) <= 3e-4 * np.linalg.norm(v), k


def test_materialized_block_train_step_matches_jax(block_vars):
    """One f32 MC training step of the JAX default ``fused=False`` block
    model, batch 4: the materialized sites ``bayes_b0`` … ``bayes_b3`` and
    the unfused classifier head draw threefry masks on the keys JAX drew
    (captured in an eager pass), against the jitted
    ``jax.value_and_grad``: the EED loss and every gradient by name to
    3e-4 of its norm (as the fused step above)."""
    _, variables, _ = block_vars
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 3, 9, 3], np.int32)
    jm = jax_get_model("vgg11", bayes=JMC, dropout="block")

    def loss_fn(params, bs):
        o, upd = jm.apply({"params": params, "batch_stats": bs},
                          jnp.asarray(x), train=True,
                          rngs={"bayes": jax.random.key(9)},
                          mutable=["batch_stats"])
        return jax_eed_loss(o.logits, jnp.asarray(y), o.features), upd

    seen = []
    orig = jax.random.bernoulli

    def spy(key, p, shape):
        seen.append(np.asarray(jax.random.key_data(key)).astype(np.uint32))
        return orig(key, p, shape)

    jax.random.bernoulli = spy
    try:
        loss_fn(variables["params"], variables["batch_stats"])
    finally:
        jax.random.bernoulli = orig
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    seeds = np.stack(seen).view(np.int32)
    assert seeds.shape == (5, 2)
    model = load_flax_variables(get_model(
        "vgg11", bayes=MC, dropout="block"), variables).train()
    assert model.num_sites == 5 and model.classifier.drop is not None
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(x), torch.from_numpy(seeds))
    tloss = eed_loss(out.logits, torch.from_numpy(y), out.features)
    tgrads = dict(zip(params, torch.autograd.grad(tloss,
                                                  list(params.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, grads))
    assert set(want) == set(tgrads)
    total = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in want.values()))
    for k, g in tgrads.items():
        err = np.linalg.norm(_hwio(g) - want[k])
        assert err <= 3e-4 * np.linalg.norm(want[k]) + 1e-6 * total, (k, err)


def test_qat_convbn_with_site_train_step_matches_jax():
    """One QAT ``ConvBN`` whose input carries an MC site (the trainable
    masked conv on fake-quant weights, BN on batch statistics, relu and the
    unsigned activation grid), forward and gradients against ``jax.vjp``
    on the seeds JAX drew, f32, to 1e-5 of each gradient's norm."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, size=(4, 8, 8, 32)).astype(np.float32)
    jl = jlayers.ConvBN(16, quant=JQ8, bayes=JMC)
    v = jax.tree.map(np.asarray, jl.init(
        {"params": jax.random.key(1), "bayes": jax.random.key(2)},
        jnp.asarray(x), train=True))
    seen = []
    orig = jfused.dropout_conv

    def spy(xx, w, seeds, *a, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, *a, **kw)

    def f(params, xx):
        y, _ = jl.apply({"params": params, "batch_stats": v["batch_stats"]},
                        xx, train=True, act="relu", act_quant=True,
                        rngs={"bayes": jax.random.key(4)},
                        mutable=["batch_stats"])
        return y

    jfused.dropout_conv = spy
    try:
        want, vjp = jax.vjp(f, v["params"], jnp.asarray(x))
        cot = rng.normal(size=want.shape).astype(np.float32)
        jgp, jgx = vjp(jnp.asarray(cot))
    finally:
        jfused.dropout_conv = orig
    tl = tlayers.ConvBN(32, 16, quant=Q8, bayes=MC).train()
    with torch.no_grad():
        tl.conv.kernel.copy_(torch.from_numpy(np.array(
            v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))))
        tl.bn.scale.copy_(torch.from_numpy(np.array(
            v["params"]["bn"]["scale"])))
        tl.bn.bias.copy_(torch.from_numpy(np.array(v["params"]["bn"]["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = tl(xt, act="relu", act_quant=True,
             seeds=torch.from_numpy(seen[0].astype(np.int32)))
    gx, gk, gs, gb = torch.autograd.grad(
        got, (xt, tl.conv.kernel, tl.bn.scale, tl.bn.bias),
        torch.from_numpy(cot).permute(0, 3, 1, 2))
    # the activation grid: a value within roundoff of a rounding boundary
    # (the batch statistics sum in another order) may land one grid step
    # over, as in the QAT step tests of the int8 slice
    diff = np.abs(got.detach().permute(0, 2, 3, 1).numpy() - np.asarray(want))
    assert diff.max() <= STEP and (diff > 0).mean() <= 1e-3
    for g, w in ((gx.permute(0, 2, 3, 1), jgx),
                 (gk.permute(2, 3, 1, 0), jgp["conv"]["kernel"]),
                 (gs, jgp["bn"]["scale"]), (gb, jgp["bn"]["bias"])):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)


# ------------------------------------------------------------- interop


def test_block_banks_load_from_flax_and_round_trip(block_vars):
    """The conv-site banks come from ``masks/blockN/convbn0/conv/bank``
    ((4, C) for C = 64, 128, 256, 512) and the head's from
    ``masks/classifier/bank``; they equal the port's own banks (the ones
    the Flax init draws), and ``to_flax_variables`` gives the tree back."""
    _, _, variables = block_vars
    masks = variables["masks"]
    for block, c in SITE_BANKS.items():
        assert masks[block]["convbn0"]["conv"]["bank"].shape == (4, c)
    model = _port(variables, MASK)
    fresh = get_model("vgg11", bayes=MASK, fused=True, dropout="block")
    for name, b in model.named_buffers():
        if name.endswith("bank"):
            assert torch.equal(b, dict(fresh.named_buffers())[name]), name
    back = to_flax_variables(model)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="masks"):
        _port({k: variables[k] for k in ("params", "batch_stats")}, MASK)


def test_block_sites_guard_the_mask_rows():
    """A site never takes S folded into its batch: x (S, N, C, H, W)
    with (S, 2) seeds gives sample s the single call's mask on x[s] (one
    _xs launch on the card), which differs from folding (the mask rows
    would shift)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 2, 40, 4, 4)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 40, 3, 3)).astype(np.float32))
    seeds = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    x5 = x.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    per = tmc.dropout_conv_inference(x5, w, seeds, RATE)
    for s in range(2):
        assert torch.equal(per[s], tmc.dropout_conv_inference(
            x5[s], w, seeds[s], RATE))
    folded = tmc.dropout_conv_inference(
        x5.flatten(0, 1), w, seeds[1], RATE)[2:]
    assert not torch.equal(per[1], folded)
