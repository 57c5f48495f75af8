"""The port's training path against the JAX package's, on the CPU.

- ``dropout_apply`` (the backward's mask) against ``_dropout_apply`` in the
  Pallas interpreter, bit for bit.
- The VJP of the trainable ``dropout_matmul`` against ``jax.vjp`` of the
  JAX custom-VJP function.
- One training step of full-width ``vgg11_me`` at batch 4: the JAX init
  variables with BatchNorm perturbed (as in ``test_torch_port_vgg.py``),
  the seeds each JAX ``BayesDense`` passes to its kernel captured by a
  test-local wrapper of ``bayestpu.nn.fused.dropout_matmul`` while
  ``jax.value_and_grad`` runs outside jit, then the loss, every gradient by
  name, the updated BN statistics and the parameters after one
  ``get_optimizer`` step (SGD 0.9 + weight decay + clip 10, active: the
  gradient norm at init is ~200).
- ``train_loop``, ``bn_reestimate``, ``step_seeds``, ``to_flax_variables``
  and the guards of the training entry points.

The port's wrappers run their plain versions because the tensors lie on
the CPU; ``chip_smoke.py`` holds the CUDA kernels against the same plain
versions on the card.
"""

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.nn.fused as jfused
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.kernels import masked_matmul as jmm
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu.train import loop as jloop
from bayestpu.train.losses import eed_loss as jax_eed_loss
from bayestpu.train.optim import get_optimizer as jax_get_optimizer
from bayestpu.train.optim import get_recipe as jax_get_recipe
from bayestpu_torch.core.config import BayesConfig
from bayestpu_torch.core.rng import EVAL_STEP0, sample_seeds, step_seeds
from bayestpu_torch.data.datasets import get_dataset, iterate_batches
from bayestpu_torch.engine.sharding import make_mesh
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.kernels import masked_matmul as tmm
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.losses import eed_loss
from bayestpu_torch.train.loop import (bn_reestimate, create_state,
                                       make_eval_step, make_train_step,
                                       train_loop)
from bayestpu_torch.train.optim import (apply_updates, get_optimizer,
                                        get_recipe)

RATE = 0.25
I = dict(interpret=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# one bf16 ulp is 2^-8..2^-7 of a value: an f32 sum taken in another order
# may round to the neighbouring bf16 value
BF16_RTOL = 2.0 ** -7


def _seeds(num, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.integers(-2 ** 31, 2 ** 31, size=(num, 2), dtype=np.int64)
    s[0] = (-5, -2 ** 31)                      # negative seeds, int32 min
    return s.astype(np.int32)


def _pair(a, bf16):
    return (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32))


# ------------------------------------------------------ dropout_apply


@pytest.mark.parametrize("m,k", [(128, 512), (37, 45), (300, 700)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_apply_bit_equal_jax(m, k, bf16):
    """Ragged M and K (the JAX kernel pads to 128-blocks, the port masks
    global coordinates), f32 and bf16 input, a negative seed."""
    x = np.random.default_rng(m + k).normal(size=(m, k)).astype(np.float32)
    jx, tx = _pair(x, bf16)
    seeds = _seeds(1)[0]
    want = np.asarray(jmm._dropout_apply(jx, jnp.asarray(seeds), RATE, 128,
                                         128, **I))
    got = tmm.dropout_apply(tx, torch.from_numpy(seeds), RATE)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmm.dropout_apply_plain(tx, torch.from_numpy(seeds), RATE).numpy(),
        want)


@pytest.mark.parametrize("shape", [(300, 70), (97, 13), (2, 9, 7, 64),
                                   (3, 5, 6, 36)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_apply_plain_ragged_and_conv_view_bit_equal_jax(shape, bf16):
    """``dropout_apply_plain`` at K a multiple of neither 4 nor 8 (the
    CUDA kernel's scalar path) and on the conv backward's (N·H·W, C) view
    of a small NHWC tensor (``mask_apply_nhwc``), against JAX's
    ``_dropout_apply`` and ``mask_apply_nhwc`` in the interpreter, bit for
    bit, with two seed pairs (the first negative)."""
    from bayestpu.kernels import masked_conv as jmc
    from bayestpu_torch.kernels import masked_conv as tmc
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    jx, tx = _pair(x, bf16)
    for seeds in _seeds(2, seed=7):
        ts = torch.from_numpy(seeds)
        if len(shape) == 2:
            want = np.asarray(jmm._dropout_apply(jx, jnp.asarray(seeds), RATE,
                                                 256, 128, **I))
            got = tmm.dropout_apply_plain(tx, ts, RATE)
        else:
            want = np.asarray(jmc.mask_apply_nhwc(jx, jnp.asarray(seeds),
                                                  RATE, **I))
            got = tmc.mask_apply_nhwc(
                tx.permute(0, 3, 1, 2), ts, RATE,
                tmm.dropout_apply_plain).permute(0, 2, 3, 1)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_apply_readout_uses_f32_scale_and_forward_mask(bf16):
    """ones → exactly {0, f32(1/0.75) = 1.3333334} under f32 and bf16 input
    (the forward's bf16 scale would be 1.3359375), and the nonzero pattern
    equals the forward kernel's readout ``ones @ eye``."""
    m, k = 40, 150
    seeds = torch.from_numpy(_seeds(2, seed=5)[1])
    dt = torch.bfloat16 if bf16 else torch.float32
    ones = torch.ones(m, k, dtype=dt)
    got = tmm.dropout_apply(ones, seeds, RATE)
    assert set(got.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert tmm.apply_scale(RATE) == float(np.float32(1 / 0.75))
    fwd = tmm.dropout_matmul(ones, torch.eye(k, dtype=dt), seeds, RATE)
    assert torch.equal(got != 0, fwd != 0)
    want = np.asarray(jmm._dropout_apply(jnp.ones((m, k), jnp.bfloat16 if bf16
                                                  else jnp.float32),
                                         jnp.asarray(seeds.numpy()), RATE,
                                         128, 128, **I))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_apply_rejects_bad_inputs():
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        tmm.dropout_apply(torch.ones(3), seeds, RATE)
    with pytest.raises(TypeError):
        tmm.dropout_apply(torch.ones(3, 4, dtype=torch.float16), seeds, RATE)
    with pytest.raises(ValueError):
        tmm.dropout_apply(torch.ones(3, 4), seeds.long(), RATE)
    with pytest.raises(ValueError):
        tmm.dropout_apply(torch.ones(3, 4), seeds, 1.0)
    with pytest.raises(ValueError, match="device"):
        tmm.dropout_apply(torch.empty(3, 4, device="meta"),
                          torch.empty(2, dtype=torch.int32, device="meta"),
                          RATE)


# ---------------------------------------------------------------- VJP


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("bf16", [False, True])
def test_dropout_matmul_vjp_matches_jax(rate, bf16):
    """f32: rtol 1e-5 (the f32 products run in another order). bf16: JAX
    and the port round the f32 dx and dw to bf16 at the end (at rate 0 JAX
    returns them f32 and autograd rounds the port's), so they may differ
    by one bf16 ulp."""
    rng = np.random.default_rng(7)
    m, k, n = 37, 70, 10
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    seeds = _seeds(1, seed=3)[0]
    (jx, tx), (jw, tw) = _pair(x, bf16), _pair(w, bf16)
    y, vjp = jax.vjp(lambda a, b: jmm.dropout_matmul(
        a, b, jnp.asarray(seeds), rate, **I), jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    ty = tmm.dropout_matmul(tx, tw, torch.from_numpy(seeds), rate)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
    assert tdx.dtype == tx.dtype and tdw.dtype == tw.dtype
    if rate > 0:
        assert jdx.dtype == jx.dtype and jdw.dtype == jw.dtype
    tol = (dict(rtol=BF16_RTOL, atol=1e-2 * BF16_RTOL) if bf16
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tdx.float().numpy(),
                               np.asarray(jdx, np.float32), **tol)
    np.testing.assert_allclose(tdw.float().numpy(),
                               np.asarray(jdw, np.float32), **tol)
    # the plain VJP is the Function's backward, bit for bit on the CPU
    pdx, pdw = tmm.dropout_matmul_vjp_plain(tx.detach(), tw.detach(),
                                            torch.from_numpy(seeds), rate,
                                            torch.from_numpy(g))
    assert torch.equal(pdx, tdx) and torch.equal(pdw, tdw)
    if rate > 0:   # dx is exactly 0 where the mask drops
        keep = tmm.keep_mask(torch.from_numpy(seeds), m, k, rate)
        assert bool((tdx[~keep] == 0).all())
        assert bool((tdx[keep] != 0).any())


def test_vjp_computes_only_the_needed_gradient():
    x = torch.randn(16, 20)
    w = torch.randn(20, 4, requires_grad=True)
    seeds = torch.tensor([3, -4], dtype=torch.int32)
    (dw,) = torch.autograd.grad(tmm.dropout_matmul(x, w, seeds, RATE).sum(),
                                (w,))
    _, want = tmm.dropout_matmul_vjp_plain(x, w.detach(), seeds, RATE,
                                           torch.ones(16, 4))
    assert torch.equal(dw, want)


# --------------------------------------------------------- model step


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


# the "vgg19" recipe: SGD(0.9) with coupled weight decay 5e-4, cosine LR,
# clip at 10
LR = 0.05
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module")
def step_setup():
    """Inputs, perturbed JAX init variables, and one JAX training step per
    (dtype, rate): loss, gradients, updated BN statistics, parameters after
    one optimizer update (all flat by dotted name) and the captured
    seeds."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 3, 7, 3], np.int32)
    v = jax.tree.map(np.asarray, jax_get_model(
        "vgg11_me", bayes=JBayes(rate=RATE), fused=True).init(
        {"params": jax.random.key(0), "bayes": jax.random.key(0)},
        jnp.asarray(x)))
    variables = {"params": _perturb(v["params"], rng),
                 "batch_stats": _perturb(v["batch_stats"], rng)}
    jtx = jax_get_optimizer(jax_get_recipe("vgg19", lr=LR),
                            STEPS_PER_EPOCH)
    out = {}
    for name, (jdt, _) in DTYPES.items():
        for rate in (0.0, RATE):
            jm = jax_get_model("vgg11_me", bayes=JBayes(rate=rate),
                               fused=True, dtype=jdt)
            seen = []
            orig = jfused.dropout_matmul

            def spy(xx, w, seeds, r, **kw):
                seen.append(np.asarray(seeds))
                return orig(xx, w, seeds, r, **kw)

            def loss_fn(params, bs):
                o, upd = jm.apply({"params": params, "batch_stats": bs},
                                  jnp.asarray(x), train=True,
                                  rngs={"bayes": jax.random.key(5)},
                                  mutable=["batch_stats"])
                return jax_eed_loss(o.logits, jnp.asarray(y),
                                    o.features), upd

            jfused.dropout_matmul = spy
            try:
                (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    variables["params"], variables["batch_stats"])
            finally:
                jfused.dropout_matmul = orig
            u, _ = jtx.update(grads, jtx.init(variables["params"]),
                              variables["params"])
            new = optax.apply_updates(variables["params"], u)
            out[name, rate] = dict(
                loss=float(loss), grads=_flat(jax.tree.map(np.asarray, grads)),
                batch_stats=_flat(jax.tree.map(np.asarray,
                                               upd["batch_stats"])),
                params=_flat(jax.tree.map(np.asarray, new)),
                seeds=(np.stack(seen).astype(np.int32) if seen
                       else np.zeros((0, 2), np.int32)))
    return x, y, variables, out


def _port_step(x, y, variables, seeds, rate, dtype):
    model = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=rate), fused=True, dtype=dtype),
        variables).train()
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(x), torch.from_numpy(seeds))
    loss = eed_loss(out.logits, torch.from_numpy(y), out.features)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    tx = get_optimizer(get_recipe("vgg19", lr=LR), STEPS_PER_EPOCH)
    with torch.no_grad():
        updates, _ = tx.update(grads, tx.init(params), params)
        apply_updates(params, updates)
    tv = to_flax_variables(model)
    return (float(loss.detach()), {k: _hwio(g) for k, g in grads.items()},
            _flat(tv["batch_stats"]), _flat(tv["params"]))


def _close(got, want, noise, floor):
    """Per tensor: ``‖got − want‖ ≤ 2·‖want − noise‖ + floor·‖want‖ +
    1e-5``. For f32, ``noise`` is ``want`` and the bound is the relative
    ``floor``. For bf16, ``noise`` is the JAX f32 result: bf16 rounds
    at other points in XLA and in oneDNN/cuBLAS, and at batch 4 BatchNorm
    amplifies a rounding difference by ~500× (the f32 gradients of the two
    packages differ by ~6e-5 relative from ~1e-7 roundoff), so some bf16
    gradients of JAX itself move by ~50% against its f32 ones; the port must
    stay as close to JAX bf16 as JAX bf16 is to JAX f32."""
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        bound = (2 * np.linalg.norm(want[k] - noise[k])
                 + floor * np.linalg.norm(want[k]) + 1e-5)
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_train_step_matches_jax(step_setup, name, rate):
    """Loss, every gradient by name, the updated BatchNorm statistics and
    the parameters after one SGD+clip update. f32 tolerance: 3e-4 of each
    tensor's norm (measured ≤ 6e-5: summation order amplified by BN at
    batch 4) and rtol 1e-5 on the loss."""
    x, y, variables, jax_steps = step_setup
    want = jax_steps[name, rate]
    assert want["seeds"].shape == ((5, 2) if rate else (0, 2))
    loss, grads, bstats, params = _port_step(
        x, y, variables, want["seeds"], rate, DTYPES[name][1])
    ref = jax_steps["f32", rate] if name == "bf16" else want
    floor = 3e-4 if name == "f32" else 2e-3
    np.testing.assert_allclose(
        loss, want["loss"],
        rtol=1e-5, atol=2 * abs(want["loss"] - ref["loss"]))
    _close(grads, want["grads"], ref["grads"], floor)
    _close(bstats, want["batch_stats"], ref["batch_stats"], floor)
    # the update, not the parameter, carries the step's error
    init = _flat(variables["params"])
    _close({k: params[k] - init[k] for k in init},
           {k: want["params"][k] - init[k] for k in init},
           {k: ref["params"][k] - init[k] for k in init}, floor)


def test_bf16_head_gradients_are_bf16_rounded(step_setup):
    """Under bf16 the VJP rounds dw of each head to bf16 before it reaches
    the f32 kernel (``masked_matmul.py:266``)."""
    x, y, variables, jax_steps = step_setup
    _, grads, _, _ = _port_step(x, y, variables,
                                jax_steps["bf16", RATE]["seeds"], RATE,
                                torch.bfloat16)
    for head in ("exit1.linear", "exit4.linear", "classifier"):
        g = torch.from_numpy(grads[f"{head}.kernel"])
        assert torch.equal(g, g.bfloat16().float()), head


# ------------------------------------------------------ entry points


def _tiny_data(n_train=48, n_test=16):
    return get_dataset("cifar10", data_dir="/nonexistent",
                       n_synth_train=n_train, n_synth_test=n_test)


def _sgd_state(seed=0, dtype=torch.float32, rate=RATE):
    model = get_model("vgg11_me", bayes=BayesConfig(rate=rate), fused=True,
                      dtype=dtype)
    tx = get_optimizer(get_recipe("vgg19", lr=0.01, t_max=2), 3)
    ds = _tiny_data()
    return model, tx, create_state(model, tx, seed, ds.x_train[:8],
                                   device="cpu"), ds


def _batches(ds, bsz=16):
    return lambda: iterate_batches(ds.x_train, ds.y_train, bsz, seed=1)


def _val(ds):
    return lambda: iterate_batches(ds.x_test, ds.y_test, 8, shuffle=False)


def test_create_state_and_train_step():
    model, tx, state, ds = _sgd_state()
    assert model.training and state.step == 0
    step = make_train_step(model, tx)
    x = torch.from_numpy(ds.x_train[:8])
    y = torch.from_numpy(ds.y_train[:8])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    m = step(state, x, y, step_seeds(0, 0, model.num_sites))
    assert state.step == 1
    assert {"loss", "grad_norm", "exit4_top1", "ens4_top1",
            "avg_maxprob"} <= set(m)
    assert all(t.dim() == 0 for t in m.values())
    assert float(m["grad_norm"]) > 10.0          # the clip is active
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(before)
    # lr_scale multiplies the updates: 0 freezes the parameters
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step(state, x, y, step_seeds(0, 1, model.num_sites), lr_scale=0.0)
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
    v = state.variables()
    assert set(v) == {"params", "batch_stats"}
    ev = make_eval_step(model)(x, y, step_seeds(0, EVAL_STEP0,
                                                model.num_sites))
    assert {"val_eed", "val_ce", "exit4_top1"} <= set(ev) and model.training


@pytest.mark.parametrize("val_mode", ["acc", "eed", "ce"])
def test_train_loop_history_and_best_params(val_mode):
    """Two epochs of three batches: history is filled, and with validation
    the loop hands back the parameters of the first best epoch."""
    model, tx, state, ds = _sgd_state()
    snaps = []

    def log_fn(msg):
        if msg.startswith("epoch"):
            snaps.append({k: p.detach().clone()
                          for k, p in model.named_parameters()})

    hist = {}
    out = train_loop(model, state, tx, _batches(ds), 3, 2,
                     val_batches=_val(ds), val_mode=val_mode, history=hist,
                     log_fn=log_fn)
    assert out is state and state.step == 6
    assert len(hist["train_loss"]) == 2 == len(hist["val_metric"])
    assert all(np.isfinite(hist["train_loss"]))
    vals = hist["val_metric"] if val_mode == "acc" else [
        -v for v in hist["val_metric"]]
    best = int(np.argmax(vals))
    for k, p in model.named_parameters():
        assert torch.equal(p, snaps[best][k]), k


def test_train_loop_reshuffle_is_a_function_of_seed_and_epoch():
    finals = []
    for reshuffle, seed in ((True, 3), (True, 3), (False, 3), (True, 4)):
        model, tx, state, ds = _sgd_state()
        train_loop(model, state, tx, _batches(ds), seed, 2,
                   reshuffle=reshuffle, log_fn=lambda m: None)
        finals.append(torch.cat([p.detach().reshape(-1)
                                 for p in model.parameters()]))
    assert torch.equal(finals[0], finals[1])
    assert not torch.equal(finals[0], finals[2])
    assert not torch.equal(finals[0], finals[3])


def test_train_loop_early_stop_and_plateau():
    """No training batches: the model and so the validation metric stay
    fixed, epoch 0 sets the best and every later epoch fails to improve.
    plateau_patience 1 scales the LR after each such epoch; patience 2
    stops after the second."""
    model, tx, state, ds = _sgd_state()
    logs, hist = [], {}
    train_loop(model, state, tx, lambda: [], 0, 6, val_batches=_val(ds),
               val_mode="ce", patience=2, plateau_factor=0.5,
               plateau_patience=1, history=hist, log_fn=logs.append)
    assert len(hist["train_loss"]) == 3 and state.step == 0
    assert len(set(hist["val_metric"])) == 1
    assert [m.strip() for m in logs if "plateau" in m] == [
        "plateau: lr scale → 5.00e-01", "plateau: lr scale → 2.50e-01"]
    assert "early stop" in logs[-1]


def test_train_loop_unported_options_raise(tmp_path):
    """Checkpoints are ported: ``checkpoint_dir`` writes one; ``mesh`` is
    ported: a 1x1 mesh (no process group) trains as the loop without one,
    bit for bit, and a mesh larger than the process count is refused."""
    model, tx, state, ds = _sgd_state()
    ref_model, ref_tx, ref_state, _ = _sgd_state()
    train_loop(model, state, tx, _batches(ds), 0, 1, mesh=make_mesh(),
               log_fn=lambda s: None)
    train_loop(ref_model, ref_state, ref_tx, _batches(ds), 0, 1,
               log_fn=lambda s: None)
    assert state.step == ref_state.step == 3
    for (k, p), q in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(p, q), k
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(2, 1)
    train_loop(model, state, tx, _batches(ds), 0, 1,
               checkpoint_dir=str(tmp_path / "ck"), log_fn=lambda s: None)
    assert (tmp_path / "ck" / "checkpoint.pt").is_file()
    with pytest.raises(ValueError):
        train_loop(model, state, tx, _batches(ds), 0, 1, val_mode="bogus")


def test_create_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True)
    tx = get_optimizer(get_recipe("vgg19"))
    x = np.zeros((2, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_state(model, tx, 0, x)
    with pytest.raises(ValueError, match="fit"):
        create_state(model, tx, 0, x[:, :16], device="cpu")


def test_train_mode_takes_one_sample_of_seeds():
    model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True)
    assert not model.training                  # built in eval mode
    model.train()
    with pytest.raises(ValueError, match="train mode"):
        model(torch.zeros(2, 32, 32, 3), torch.zeros(3, 5, 2,
                                                     dtype=torch.int32))


def test_bn_reestimate_matches_jax():
    """Rate 0 (no masks to capture inside the jitted JAX sweep): one pass
    over two batches of running-average updates; f32, rtol 1e-5."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    jm = jax_get_model("vgg11_me", bayes=JBayes(rate=0.0), fused=True)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(1), "bayes": jax.random.key(1)},
        jnp.asarray(xs[0])))
    want = jloop.bn_reestimate(jm, v["params"], v["batch_stats"],
                               jnp.asarray(xs), jax.random.key(0), passes=1)
    model = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=0.0), fused=True), v)
    got = bn_reestimate(model, list(xs), torch.zeros(0, 2, dtype=torch.int32),
                        passes=1)
    assert not model.training
    want = _flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------- seeds, interop


def test_step_seeds_pure_and_distinct():
    a = step_seeds(7, 3, 5)
    assert a.dtype == torch.int32 and a.shape == (5, 2)
    many = step_seeds(7, range(10), 5)
    assert many.shape == (10, 5, 2) and torch.equal(many[3], a)
    assert torch.equal(step_seeds(7, 3, 5), a)           # resumable
    assert len({tuple(r) for r in many.reshape(-1, 2).tolist()}) == 50
    assert not torch.equal(step_seeds(8, 3, 5), a)
    # another stream than the MC samples of the same seed
    assert not torch.equal(sample_seeds(7, 4, 5)[3], a)
    assert EVAL_STEP0 == 10_000_000


def test_to_flax_variables_inverts_load(step_setup):
    _, _, variables, _ = step_setup
    model = load_flax_variables(get_model(
        "vgg11_me", bayes=BayesConfig(rate=RATE), fused=True), variables)
    back = to_flax_variables(model)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(
                                     variables)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
