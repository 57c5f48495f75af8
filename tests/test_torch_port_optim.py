"""The port's EED loss, metrics, schedules and optimizer chains against the
JAX package's (optax), on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
optimizer chains run three updates on a small parameter dict whose
gradients are scaled so that the global-norm clip is active.
"""

import dataclasses

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.train import losses as jlosses
from bayestpu.train import optim as joptim
from bayestpu_torch.train import losses as tlosses
from bayestpu_torch.train import optim as toptim

from port_threads import thread_budget  # noqa: F401

CFGS = [tlosses.EEDConfig(),
        tlosses.EEDConfig(use_eed=False),
        tlosses.EEDConfig(loss_output="KL"),
        tlosses.EEDConfig(loss_output="KL", use_eed=False),
        tlosses.EEDConfig(use_feature_dist=True),
        tlosses.EEDConfig(loss_output="KL", use_feature_dist=True,
                          use_eed=False, temperature=2.0)]


def _jcfg(cfg):
    return jlosses.EEDConfig(**dataclasses.asdict(cfg))


def _logits(e=5, b=6, c=10, f=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, b, c)).astype(np.float32) * 2,
            rng.integers(0, c, size=b).astype(np.int32),
            rng.normal(size=(e, b, f)).astype(np.float32))


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: (
    f"{c.loss_output}-eed{int(c.use_eed)}-feat{int(c.use_feature_dist)}"))
def test_eed_loss_and_its_gradient_match_jax(cfg):
    """Value to rtol 1e-6; the gradient with respect to logits and features
    too (rtol 1e-5), which pins the detached distillation targets."""
    logits, labels, feats = _logits()
    jfn = lambda lg, ft: jlosses.eed_loss(lg, jnp.asarray(labels), ft,
                                          _jcfg(cfg))
    want, (jgl, jgf) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(feats))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tf = torch.from_numpy(feats).requires_grad_(True)
    got = tlosses.eed_loss(tl, torch.from_numpy(labels), tf, cfg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    gl, gf = torch.autograd.grad(got, (tl, tf), allow_unused=True)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-5,
                               atol=1e-7)
    if cfg.use_feature_dist:
        np.testing.assert_allclose(gf.numpy(), np.asarray(jgf), rtol=1e-5,
                                   atol=1e-7)
    else:
        assert gf is None and not np.asarray(jgf).any()


def test_eed_loss_single_exit_is_ce():
    logits, labels, _ = _logits(e=1)
    got = tlosses.eed_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jlosses.eed_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="loss_output"):
        tlosses.eed_loss(torch.from_numpy(_logits()[0]),
                         torch.from_numpy(labels),
                         cfg=tlosses.EEDConfig(loss_output="L1"))


@pytest.mark.parametrize("tops", [(1,), (1, 3)])
def test_multi_exit_accuracy_matches_jax(tops):
    logits, labels, _ = _logits(b=64, seed=3)
    want = jlosses.multi_exit_accuracy(jnp.asarray(logits),
                                       jnp.asarray(labels), tops)
    got = tlosses.multi_exit_accuracy(torch.from_numpy(logits),
                                      torch.from_numpy(labels), tops)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("scheduler", ["multistep", "cosine", "constant",
                                       "plateau"])
def test_schedules_match_optax_at_their_boundaries(scheduler):
    """f32 values at and around every boundary: exact, except that XLA's
    f32 ``cos`` and numpy's may differ in the last bit, which moves the
    cosine LR by at most ``lr·2⁻²³`` (``0.5·lr·ulp(1)`` after ``1 + cos``)."""
    recipe = joptim.TrainRecipe(scheduler=scheduler, lr=0.1,
                                milestones=(2, 5), t_max=4)
    spe = 3
    jsched = joptim.get_schedule(recipe, spe)
    tsched = toptim.get_schedule(toptim.TrainRecipe(**dataclasses.asdict(
        recipe)), spe)
    counts = sorted({0, 1, 5, 6, 7, 14, 15, 16, 11, 12, 13, 40})
    for c in counts:
        want = np.float32(jax.jit(jsched)(jnp.int32(c)))
        if scheduler == "cosine":
            np.testing.assert_allclose(tsched(c), want, rtol=0,
                                       atol=recipe.lr * 2.0 ** -23)
        else:
            assert np.float32(tsched(c)) == want, (scheduler, c)


def test_schedule_rejects_bad_arguments():
    with pytest.raises(ValueError):
        toptim.cosine_decay_schedule(0.1, 0)
    with pytest.raises(ValueError):
        toptim.piecewise_constant_schedule(0.1, {3: -1.0})
    with pytest.raises(ValueError, match="scheduler"):
        toptim.get_schedule(toptim.TrainRecipe(scheduler="bogus"), 1)
    with pytest.raises(ValueError, match="optimizer"):
        toptim.get_optimizer(toptim.TrainRecipe(optimizer="bogus"))


# ------------------------------------------------------------ optimizers


RECIPE_CASES = {
    # every recipe of RECIPES, as get_recipe returns it
    **{name: {} for name in joptim.RECIPES},
    "sgd-wd-accum2": dict(accum_steps=2),
    "sgd-no-momentum": dict(momentum=0.0),
    "adamw": dict(optimizer="adamw", scheduler="cosine", t_max=1),
    "sgd-no-clip": dict(grad_clip=0.0),
}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a.kernel": rng.normal(size=(5, 4)).astype(np.float32),
            "a.bias": rng.normal(size=(4,)).astype(np.float32),
            "b.scale": rng.normal(size=(7,)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(RECIPE_CASES))
def test_optimizer_chain_matches_optax(case):
    """Three updates on the same gradients (norm ~30, so clip 10 is active)
    with steps_per_epoch 1 so every schedule crosses a boundary early.
    rtol 1e-6: optax's global norm sums the leaves in another order."""
    backbone = case if case in joptim.RECIPES else "resnet18"
    overrides = dict(RECIPE_CASES[case], milestones=(1, 2))
    jrecipe = joptim.get_recipe(backbone, **overrides)
    trecipe = toptim.get_recipe(backbone, **overrides)
    assert dataclasses.asdict(jrecipe) == dataclasses.asdict(trecipe)
    jtx = joptim.get_optimizer(jrecipe, 1)
    ttx = toptim.get_optimizer(trecipe, 1)
    p = _params()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    rng = np.random.default_rng(1)
    for i in range(3):
        g = {k: (10 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in p.items()}
        u, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jstate, jp)
        jp = optax.apply_updates(jp, u)
        tu, tstate = ttx.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, tstate, tp)
        toptim.apply_updates(tp, tu)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{case} update {i} {k}")


def test_clip_matches_optax_below_and_above_the_norm():
    """Below max_norm the updates pass unchanged (bit for bit); above, they
    scale by max_norm/norm with no epsilon."""
    g = {"w": np.array([3.0, 4.0], np.float32)}          # norm 5
    for max_norm in (5.5, 5.0, 2.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {"w": jnp.asarray(g["w"])}, ())
        got, _ = toptim.clip_by_global_norm(max_norm).update(
            {"w": torch.from_numpy(g["w"])}, ())
        np.testing.assert_array_equal(got["w"].numpy(),
                                      np.asarray(want["w"]))
    assert float(toptim.global_norm({"w": torch.from_numpy(g["w"])})) == 5.0
