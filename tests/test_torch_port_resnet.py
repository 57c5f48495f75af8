"""The port's ResNet family against the JAX package's, on the CPU.

``resnet18_me`` at full width on CIFAR-100 shapes (batch 2, 100 classes,
the JAX init variables with BatchNorm perturbed, loaded by name through
``from_flax``): MC logits in f32 and bf16 on the seeds each JAX head
passed to ``dropout_matmul_inference`` (captured by wrapping it), the
spatial predictive, the int8 model (the JAX bench's BASELINE config 5),
Masksembles per-mask logits and one f32 training step against
``jax.value_and_grad``. The block-site ``resnet18(fused=True,
dropout="block")`` at a narrow width that keeps every site at 32 input
channels or more (``stage_planes=(32, 32, 64, 64)``, 16×16 input): MC and
Masksembles logits, and the seeds of the deferred site's two convs.
``resnet50`` and ``resnet20`` at a small width, forward only; and what the
port refuses.

The JAX kernels run in the Pallas interpreter, as the JAX package's own
tests run them; the port's wrappers take their plain versions because the
tensors lie on the CPU. Each JAX model is built once per file.
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
                                        QuantConfig, SamplingMode)
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.losses import eed_loss
from port_threads import thread_budget  # noqa: F401
from test_torch_port_threefry import capture_site_keys

RATE = 0.25
MC, JMC = BayesConfig(rate=RATE), JBayes(rate=RATE)
MASK = BayesConfig(kind=DropoutKind.MASK, num_masks=4, scale=2.0)
JMASK = JBayes(kind=JKind.MASK, num_masks=4, scale=2.0)
INT8_Q = QuantConfig(8, 0, int8_infer=True)
JINT8_Q = JQuant(8, 0, int8_infer=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the block-site model, narrow: every deferred site at >= 32 channels
NARROW = dict(stage_planes=(32, 32, 64, 64), num_classes=10)
NARROW_SHAPE = (16, 16, 3)
MC_HEADS = ("dropout_matmul_inference",)
MC_CONVS = ("dropout_conv_inference", "dropout_matmul_inference")


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


def _init(jm, x, rng):
    """JAX init variables with BatchNorm perturbed; the MC tree without
    ``masks``."""
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    mask_vars = {"params": _perturb(v["params"], rng),
                 "batch_stats": _perturb(v["batch_stats"], rng),
                 "masks": v["masks"]}
    return {k: mask_vars[k] for k in ("params", "batch_stats")}, mask_vars


def _capture(model, variables, x, keys, fn_names):
    """JAX per-sample logits (S, E, B, C), one apply per key as the
    temporal mapping runs them, and the seeds (S, n_seen, 2) that the sites
    passed to ``bayestpu.nn.fused.<fn_names>``, in call order."""
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


def _port(name, variables, bayes=MC, dtype=torch.float32, **kw):
    model = get_model(name, bayes=bayes, fused=True, dtype=dtype, **kw)
    return load_flax_variables(model, variables).eval()


# ------------------------------------------------------------ resnet18_me


@pytest.fixture(scope="module")
def me_vars():
    """Batch 2 of CIFAR-100 shapes; the JAX Masksembles resnet18_me's init
    variables (its ``masks`` tree holds the four heads' banks) with
    BatchNorm perturbed, and the same tree without ``masks`` for the MC
    model (same parameter names)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("resnet18_me", bayes=JMASK, fused=True)
    return (x, *_init(jm, x, rng))


@pytest.fixture(scope="module")
def me_mc(me_vars):
    """The f32 MC resnet18_me: JAX per-sample logits and head seeds (S=2)
    and JAX's spatial predictive from the same key."""
    x, variables, _ = me_vars
    jm = jax_get_model("resnet18_me", bayes=JMC, fused=True)
    key = jax.random.key(5)
    want, seeds = _capture(jm, variables, x, sample_keys(key, 2), MC_HEADS)
    pred = jsampler.predictive(jm, variables, jnp.asarray(x), key, 2)
    return want, seeds, pred


def test_resnet18_me_structure(me_vars):
    """Sites in JAX call order: exit1…exit3, then the final linear; the
    Flax names load unchanged; Masksembles banks on the four heads."""
    _, variables, mask_vars = me_vars
    model = _port("resnet18_me", variables)
    assert model.num_sites == 4 and not model.conv_sites
    assert [getattr(model, f"exit{i}").linear.site
            for i in (1, 2, 3)] == [0, 1, 2]
    assert model.linear.site == 3
    assert model.layer2_0.downsample is not None
    assert model.layer1_0.downsample is None
    names = dict(model.named_parameters())
    for n in ("stem.conv.kernel", "layer2_0.convbn1.conv.kernel",
              "layer2_0.downsample.bn.scale", "exit1.convbn1.conv.kernel",
              "exit1.linear.kernel", "linear.kernel"):
        assert n in names, n
    assert names["linear.kernel"].shape == (512, 100)
    mask = _port("resnet18_me", mask_vars, MASK)
    assert mask.num_sites == 0 and mask.masked
    assert {n for n, _ in mask.named_buffers() if n.endswith("bank")} == {
        "exit1.linear.bank", "exit2.linear.bank", "exit3.linear.bank",
        "linear.bank"}
    back = to_flax_variables(mask)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(mask_vars)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_resnet18_me_mc_logits_match_jax(me_vars, me_mc, name):
    """Per-sample logits (4 exits, 100 classes) on the captured head seeds
    (S=2): the port's spatial mapping (the backbone once, each head one
    samples call) and its temporal one against JAX's applies. f32:
    rtol/atol 1e-5 (the convs sum exact products in another order in
    oneDNN and XLA). bf16: atol 0.02, as the bf16 vgg11 tests (XLA and
    oneDNN round the bf16 convs at other points, and 20 convs pass the
    difference on through the residual sums)."""
    x, variables, _ = me_vars
    jdt, tdt = DTYPES[name]
    if name == "f32":
        want, seeds, _ = me_mc
    else:
        want, seeds = _capture(
            jax_get_model("resnet18_me", bayes=JMC, fused=True, dtype=jdt),
            variables, x, sample_keys(jax.random.key(5), 2), MC_HEADS)
    assert seeds.shape == (2, 4, 2)
    np.testing.assert_array_equal(seeds, me_mc[1])      # the same key
    model = _port("resnet18_me", variables, dtype=tdt)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
        temporal = tsampler.mc_logits(model, xt, st, SamplingMode.TEMPORAL)
    assert spatial.shape == (2, 4, 2, 100)
    tol = (dict(rtol=1e-5, atol=1e-5) if name == "f32"
           else dict(rtol=0.02, atol=0.02))
    np.testing.assert_allclose(spatial.numpy(), want, **tol)
    np.testing.assert_allclose(temporal.numpy(), want, **tol)
    assert not torch.equal(spatial[0], spatial[1])      # the masks matter


def test_resnet18_me_spatial_predictive_matches_jax(me_vars, me_mc):
    """The port's spatial predictive on the captured seeds against JAX's
    ``sampler.predictive`` (vmap over the keys), f32; the features are the
    four exits' 512-wide pooled activations."""
    x, variables, _ = me_vars
    _, seeds, jpred = me_mc
    model = _port("resnet18_me", variables)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        pred = tsampler.predictive(model, xt, st)
        out = model(xt, st)
    np.testing.assert_allclose(pred.probs.numpy(), np.asarray(jpred.probs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.entropy.numpy(),
                               np.asarray(jpred.entropy), rtol=1e-5,
                               atol=1e-6)
    assert out.features.shape == (4, 2, 512)


def _grid_steps(got, want, model):
    """max |got − want| in units of one grid step of a head's int8 input
    through the widest column of the four heads' quantized kernels."""
    from bayestpu_torch.core.quant import fake_quant
    col = max(torch.linalg.vector_norm(fake_quant(h.kernel, INT8_Q),
                                       dim=0).max().item()
              for h in (model.exit1.linear, model.exit2.linear,
                        model.exit3.linear, model.linear))
    return np.abs(got - want).max() / (2.0 ** -7 * col / (1 - RATE))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_resnet18_me_int8_matches_jax(me_vars, name):
    """The int8 resnet18_me (``int8_infer``, rate 0.25, 100 classes; bf16
    compute is the JAX bench's BASELINE config 5) on the seeds its int8
    heads drew, S=2; spatial equals temporal bit for bit. f32 compute:
    bit-equal to JAX. bf16 compute: the float epilogue of a conv (y · scale
    + bias) rounds once in XLA on the CPU, which contracts it to a fused
    multiply-add, and twice in PyTorch; the last-bit differences this
    leaves in every activation move an element next to a rounding boundary
    of the next conv's int8 grid by one step now and then, so each logit
    is held within two grid steps of a head's int8 input through the
    widest head column (measured 0.74 of one, in exits 2-4; exit 1 bit-
    equal)."""
    x, variables, _ = me_vars
    jdt, tdt = DTYPES[name]
    jm = jax_get_model("resnet18_me", bayes=JMC, fused=True, dtype=jdt,
                       quant=JINT8_Q)
    want, seeds = _capture(jm, variables, x,
                           sample_keys(jax.random.key(7), 2),
                           ("dropout_matmul_int8_inference",))
    model = _port("resnet18_me", variables, dtype=tdt, quant=INT8_Q)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
        temporal = tsampler.mc_logits(model, xt, st, SamplingMode.TEMPORAL)
    if name == "f32":
        np.testing.assert_array_equal(spatial.numpy(), want)
    else:
        assert _grid_steps(spatial.numpy(), want, model) <= 2.0
    assert torch.equal(spatial, temporal)
    assert not torch.equal(spatial[0], spatial[1])


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_resnet18_me_int8_kernel_route_matches_jax(me_vars, name):
    """The int8 resnet18_me with ``int8_det_pallas`` on both sides, on the
    inputs and head keys of ``test_resnet18_me_int8_matches_jax``: every
    deterministic int8 conv runs ``conv_int8_fused`` (the epilogue one
    fused multiply-add, int8 stored by the producer inside a block), the
    route every such conv takes on the card. f32 compute: bit-equal to
    JAX's Pallas kernel in the interpreter; bf16: within two grid steps,
    as the XLA route."""
    from bayestpu_torch.utils import profiler
    x, variables, _ = me_vars
    jdt, tdt = DTYPES[name]
    jq = JQuant(8, 0, int8_infer=True, int8_det_pallas=True)
    jm = jax_get_model("resnet18_me", bayes=JMC, fused=True, dtype=jdt,
                       quant=jq)
    want, seeds = _capture(jm, variables, x,
                           sample_keys(jax.random.key(7), 2),
                           ("dropout_matmul_int8_inference",))
    tq = QuantConfig(8, 0, int8_infer=True, int8_det_pallas=True)
    model = _port("resnet18_me", variables, dtype=tdt, quant=tq)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    profiler.reset_spans()
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
    # the backbone's 19 int8 convs and the exits' 6, none through im2col
    assert profiler.counters().get("quant.conv_kernel") == 25
    assert "quant.conv_im2col" not in profiler.counters()
    if name == "f32":
        np.testing.assert_array_equal(spatial.numpy(), want)
    else:
        assert _grid_steps(spatial.numpy(), want, model) <= 2.0
    assert not torch.equal(spatial[0], spatial[1])


@pytest.mark.parametrize("det_pallas", [False, True])
@pytest.mark.parametrize("block", ["layer1_0", "layer2_0"])
def test_resnet18_me_int8_block_emits_int8(me_vars, block, det_pallas):
    """Inside a block of the int8 resnet18_me (CPU, both int8 routes, an
    identity block and a projection one), ``convbn1`` emits int8 equal bit
    for bit to ``quantize_int8`` of the f32 output the same conv gives
    without ``emit_int8``; the block's output equals the one built from
    those f32 outputs."""
    from bayestpu_torch.core.quant import quantize_int8
    x, variables, _ = me_vars
    q = QuantConfig(8, 0, int8_infer=True, int8_det_pallas=det_pallas)
    model = _port("resnet18_me", variables, quant=q)
    blk = getattr(model, block)
    with torch.inference_mode():
        h = model.stem(torch.from_numpy(x).permute(0, 3, 1, 2))
        if block == "layer2_0":
            h = model.layer1_1(model.layer1_0(h))
        y8 = blk.convbn1(h, act="relu", emit_int8=True)
        y32 = blk.convbn1(h, act="relu")
        residual = h if blk.downsample is None else blk.downsample(h)
        want = torch.relu(blk.convbn2(y32) + residual)
        got = blk(h)
    assert y8.dtype == torch.int8 and y32.dtype == torch.float32
    assert torch.equal(y8, quantize_int8(y32, q)[0])
    assert torch.equal(got, want)


def test_resnet18_me_mask_logits_match_jax(me_vars):
    """Masksembles per-mask logits (indices 0, 2 and 5, which wraps to 1)
    against JAX's applies with ``sample_idx=i``, f32, rtol/atol 1e-5; the
    spatial mapping over the indices equals the one-index calls bit for
    bit."""
    x, _, variables = me_vars
    jm = jax_get_model("resnet18_me", bayes=JMASK, fused=True)
    idxs = (0, 2, 5)
    want = np.stack([np.asarray(jm.apply(variables, jnp.asarray(x),
                                         sample_idx=i).logits)
                     for i in idxs])
    model = _port("resnet18_me", variables, MASK)
    xt = torch.from_numpy(x)
    seeds = torch.zeros(len(idxs), 0, 2, dtype=torch.int32)
    with torch.inference_mode():
        spatial = model(xt, seeds, torch.tensor(idxs)).logits
        ones = [model(xt, seeds[0], i).logits for i in idxs]
    np.testing.assert_allclose(spatial.numpy(), want, rtol=1e-5, atol=1e-5)
    for s in range(len(idxs)):
        assert torch.equal(spatial[s], ones[s])


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


def test_resnet18_me_train_step_matches_jax(me_vars):
    """One f32 MC training step, batch 4: the seeds JAX's four heads passed
    to ``dropout_matmul``, the EED loss (rtol 1e-5), the BatchNorm
    statistics (3e-4 of their norm) and every gradient by name to 1e-2 of
    its norm. The gradients are ill-conditioned in x: an activation a few
    1e-6 from a relu's kink crosses it under a relative change of 1e-7,
    and its gradient flips on or off. Measured: a relative change of 1e-7
    in x moves the port's own gradients by up to 5.4e-3 of their norm here
    (batch 4); at batch 32, with stage_planes (16, 16, 32, 32), by 2.2e-3
    in f32 and in f64 alike, from one activation of exit 3's input at
    1.6e-6 that crosses zero; in float64 the port's f32 gradients are
    within 3.7e-6 of its own. So a larger batch does not condition the
    step: the port and JAX differ by 2.1e-3 here, 7.3e-3 at batch 16 and
    1.2e-2 at batch 32 (full width), 5.2e-3 at batch 32 narrow. JAX's
    convs round to f32 (also under x64), which after a train-mode
    BatchNorm moves activations by 2e-6 to 6e-6 of their norm: enough to
    flip such a kink."""
    _, variables, _ = me_vars
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 37, 99, 37], np.int32)
    jm = jax_get_model("resnet18_me", bayes=JMC, fused=True)
    seen = []
    orig = jfused.dropout_matmul

    def spy(xx, w, seeds, *args, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, *args, **kw)

    def loss_fn(params, bs):
        o, upd = jm.apply({"params": params, "batch_stats": bs},
                          jnp.asarray(x), train=True,
                          rngs={"bayes": jax.random.key(9)},
                          mutable=["batch_stats"])
        return jax_eed_loss(o.logits, jnp.asarray(y), o.features), upd

    jfused.dropout_matmul = spy
    try:
        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"], variables["batch_stats"])
    finally:
        jfused.dropout_matmul = orig
    seeds = np.stack(seen).astype(np.int32)
    assert seeds.shape == (4, 2)
    model = load_flax_variables(get_model("resnet18_me", bayes=MC,
                                          fused=True), variables).train()
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(x), torch.from_numpy(seeds))
    tloss = eed_loss(out.logits, torch.from_numpy(y), out.features)
    tgrads = dict(zip(params, torch.autograd.grad(tloss,
                                                  list(params.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, grads))
    assert set(want) == set(tgrads)
    for k, g in tgrads.items():
        err = np.linalg.norm(_hwio(g) - want[k])
        assert err <= 1e-2 * np.linalg.norm(want[k]), (k, err)
    bstats = _flat(to_flax_variables(model)["batch_stats"])
    jstats = _flat(jax.tree.map(np.asarray, upd["batch_stats"]))
    for k, v in jstats.items():
        assert np.linalg.norm(bstats[k] - v) <= 3e-4 * np.linalg.norm(v), k


# ------------------------------------------------ block-site resnet18


@pytest.fixture(scope="module")
def block_vars():
    """Batch 2 at 16×16; the narrow block-site resnet18's Masksembles
    init variables (six conv banks: convbn1 and downsample of layer2_0,
    layer3_0, layer4_0) with BatchNorm perturbed, and the MC tree."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2,) + NARROW_SHAPE).astype(np.float32)
    jm = jax_get_model("resnet18", bayes=JMASK, fused=True,
                       dropout="block", **NARROW)
    return (x, *_init(jm, x, rng))


def _block_port(variables, bayes=MC, dtype=torch.float32):
    return _port("resnet18", variables, bayes, dtype, dropout="block",
                 input_shape=NARROW_SHAPE, **NARROW)


def test_block_mc_logits_and_shared_seeds_match_jax(block_vars):
    """The deferred sites (layer2_0, layer3_0, layer4_0; the head has no
    site) on the seeds JAX's masked convs drew, S=2: JAX passes one pair to
    ``convbn1`` and ``downsample`` of each block, and the port numbers both
    convs as one site. Per-sample logits of the spatial mapping (one
    samples call of each conv at layer2_0, then x carrying S) and the
    temporal one, f32, rtol/atol 1e-5 (the masked convs sum exact
    products in another order)."""
    x, variables, _ = block_vars
    jm = jax_get_model("resnet18", bayes=JMC, fused=True, dropout="block",
                       **NARROW)
    want, seen = _capture(jm, variables, x,
                          sample_keys(jax.random.key(5), 2), MC_CONVS)
    assert seen.shape == (2, 6, 2)
    # convbn1, then downsample, of each deferred block: one pair
    np.testing.assert_array_equal(seen[:, 0::2], seen[:, 1::2])
    seeds = np.ascontiguousarray(seen[:, 0::2])
    model = _block_port(variables)
    assert model.num_sites == 3 and model.conv_sites
    for i, blk in enumerate(("layer2_0", "layer3_0", "layer4_0")):
        b = getattr(model, blk)
        assert b.convbn1.conv.site == b.downsample.conv.site == i
    assert model.linear.site is None
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
        temporal = tsampler.mc_logits(model, xt, st, SamplingMode.TEMPORAL)
    np.testing.assert_allclose(spatial.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(temporal.numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert not torch.equal(spatial[0], spatial[1])


def test_block_mask_logits_match_jax(block_vars):
    """The Masksembles block-site model: both convs of a deferred block
    hold the same bank (the Flax init draws it from the channel count),
    per-mask logits against JAX's applies, f32, rtol/atol 1e-5, the
    spatial mapping equal to the one-index calls bit for bit."""
    x, _, variables = block_vars
    masks = variables["masks"]
    for blk in ("layer2_0", "layer3_0", "layer4_0"):
        np.testing.assert_array_equal(masks[blk]["convbn1"]["conv"]["bank"],
                                      masks[blk]["downsample"]["conv"]["bank"])
    jm = jax_get_model("resnet18", bayes=JMASK, fused=True, dropout="block",
                       **NARROW)
    idxs = (0, 3, 6)
    want = np.stack([np.asarray(jm.apply(variables, jnp.asarray(x),
                                         sample_idx=i).logits)
                     for i in idxs])
    model = _block_port(variables, MASK)
    assert model.num_sites == 0 and model.masked and model.conv_sites
    xt = torch.from_numpy(x)
    seeds = torch.zeros(len(idxs), 0, 2, dtype=torch.int32)
    with torch.inference_mode():
        spatial = model(xt, seeds, torch.tensor(idxs)).logits
        ones = [model(xt, seeds[0], i).logits for i in idxs]
    np.testing.assert_allclose(spatial.numpy(), want, rtol=1e-5, atol=1e-5)
    for s in range(len(idxs)):
        assert torch.equal(spatial[s], ones[s])


# -------------------------------------------------- resnet50, resnet20


@pytest.mark.parametrize("name,kw", [
    ("resnet50", dict(stage_blocks=(1, 1, 1, 1),
                      stage_planes=(8, 16, 16, 32), num_classes=10)),
    ("resnet20", dict(stage_planes=(8, 16, 32)))])
def test_small_resnets_forward_match_jax(name, kw):
    """``resnet50`` (Bottleneck blocks, expansion 4) and ``resnet20``
    (3 stages of 3 BasicBlocks) at a small width, 16×16 input, their
    default MC head (``dropout_exit``) fused, on the seeds JAX drew (one
    sample), f32, rtol/atol 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jm = jax_get_model(name, bayes=JMC, fused=True, **kw)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    v = {k: _perturb(v[k], rng) for k in ("params", "batch_stats")}
    want, seeds = _capture(jm, v, x, [jax.random.key(2)], MC_HEADS)
    model = _port(name, v, input_shape=(16, 16, 3), **kw)
    with torch.inference_mode():
        got = tsampler.mc_logits(model, torch.from_numpy(x),
                                 torch.from_numpy(seeds))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("name,kw,err,item", [
    ("resnet18", dict(fused=True, quant_overrides={"stem": None}),
     TypeError, "quant_overrides"),
    ("resnet18", dict(fused=True, dropout="bogus"), ValueError, "dropout"),
])
def test_refusals_cite_their_items(name, kw, err, item):
    """``quant_overrides`` is a ``TypeError``, as the JAX ``ResNet18``
    has no such field; a bad ``dropout`` is a ``ValueError``."""
    with pytest.raises(err, match=item):
        get_model(name, bayes=MC, **kw)
    if err is TypeError:
        with pytest.raises(TypeError, match=item):
            jax_get_model(name, **kw)


# the materialized-site configurations at a small width, 16x16 input:
# resnet18's stage boundaries at 16 input channels (layer2_0, layer3_0),
# below MASKED_CONV_FUSE_MIN_CH, and at 32 (layer4_0)
SMALL18 = dict(stage_planes=(16, 16, 32, 32), num_classes=10)


@pytest.mark.parametrize("name,kw,n_sites", [
    ("resnet18", dict(fused=True, dropout="layer", **SMALL18), 9),
    ("resnet18_me", dict(fused=True, dropout="block", **SMALL18), 7),
    ("resnet18", dict(fused=False, dropout="block", **SMALL18), 3),
    ("resnet20", dict(fused=True, dropout="block"), 4),
    ("resnet18_me", dict(fused=False, **SMALL18), 4),
])
def test_materialized_configs_match_jax(name, kw, n_sites):
    """The item-11 configurations, f32, batch 2, on the seeds JAX drew in
    call order (threefry keys of the materialized sites, the fused sites'
    seeds), S = 2, against the jitted JAX model (rtol/atol 1e-5), spatial
    equal to temporal bit for bit: ``dropout="layer"`` (in-stage sites
    materialized, stage boundaries deferred: fused at 32 channels, two
    unfused masks, one a conv, at 16), block sites with exits, unfused
    block sites, resnet20's deferred site at 16 channels (each conv draws
    its own threefry mask, as JAX's two ``BayesianDropout`` do) and the
    unfused MC heads of the JAX default ``fused=False``."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jm = jax_get_model(name, bayes=JMC, **kw)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    v = {k: _perturb(v[k], rng) for k in ("params", "batch_stats")}
    want, seeds = capture_site_keys(jm, v, x, [jax.random.key(2),
                                               jax.random.key(3)])
    model = load_flax_variables(get_model(
        name, bayes=MC, input_shape=(16, 16, 3), **kw), v)
    assert model.num_sites == seeds.shape[1] == n_sites
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        spatial = tsampler.mc_logits(model, xt, st)
        temporal = tsampler.mc_logits(model, xt, st, SamplingMode.TEMPORAL)
    assert torch.equal(spatial, temporal)
    np.testing.assert_allclose(spatial.numpy(), want, rtol=1e-5, atol=1e-5)


def test_site_on_identity_block_raises():
    """A fused input site on a block whose residual is the identity would
    leave the residual unmasked: ``ValueError``, as JAX raises."""
    from bayestpu_torch.nn.zoo.resnet import basic_block, bottleneck
    with pytest.raises(ValueError, match="identity BasicBlock"):
        basic_block(32, 32, 1, torch.float32, None, MC)
    with pytest.raises(ValueError, match="identity Bottleneck"):
        bottleneck(128, 32, 1, torch.float32, None, MC)
    assert basic_block(32, 64, 2, torch.float32, None, MC).has_site
