"""Augmentation and the epoch functions on the CPU
(``bayestpu_torch/data/augment.py``, ``make_train_epoch``,
``make_eval_epoch``, ``train_loop(augment_fn=, reshuffle=)``).

- ``crop_flip`` is bit-equal to JAX's ``random_crop_flip`` on the offsets
  and flips JAX drew (``jax.random.randint``/``bernoulli`` on JAX's folded
  key, called here); the padding is zeros.
- The port's own draws (a ``torch.Generator`` on ``fold_seed(seed,
  index)``) agree with JAX's in distribution only: each crop offset is
  uniform over [0, 2·pad] (χ² over 9 cells below 26.1, p = 0.001 at 8
  degrees of freedom) and the flips have mean 0.5 within 4σ.
- ``make_train_epoch`` equals the step loop bit for bit; ``train_loop``
  passes ``augment_fn`` the batch's index in the epoch on the stacked path
  and ``state.step`` on the per-step path, as JAX's two paths do.
- A reshuffled epoch is a permutation (a bijection) of the examples, a
  pure function of (seed, epoch).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.data.augment import random_crop_flip as jax_crop_flip
from bayestpu_torch.core.config import BayesConfig
from bayestpu_torch.core.rng import EVAL_STEP0, fold_seed, step_seeds
from bayestpu_torch.data.augment import crop_flip, random_crop_flip
from bayestpu_torch.data.datasets import get_dataset, iterate_batches
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.loop import (create_state, make_eval_epoch,
                                       make_eval_step, make_train_epoch,
                                       make_train_step, train_loop)
from bayestpu_torch.train.optim import get_optimizer, get_recipe

from port_threads import thread_budget  # noqa: F401


@pytest.mark.parametrize("pad,index,key", [(4, 0, 0), (4, 5, 3), (2, 7, 11)])
def test_crop_flip_equals_jax_on_jaxs_draws(pad, index, key):
    x = np.random.default_rng(index).normal(size=(32, 12, 10, 3)).astype(
        np.float32)
    k = jax.random.fold_in(jax.random.key(key), index)
    kc, kf = jax.random.split(k)
    offs = np.array(jax.random.randint(kc, (32, 2), 0, 2 * pad + 1))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (32,)))
    assert 0 < flips.sum() < 32
    want = np.asarray(jax_crop_flip(jax.random.key(key), jnp.asarray(x),
                                    pad, index))
    got = crop_flip(torch.from_numpy(x), torch.from_numpy(offs),
                    torch.from_numpy(flips), pad).numpy()
    np.testing.assert_array_equal(got, want)


def test_padding_is_zeros_and_bad_draws_raise():
    x = torch.ones(2, 6, 6, 1)
    out = crop_flip(x, torch.tensor([[0, 0], [8, 8]]),
                    torch.tensor([False, True]), 4)
    assert out.shape == x.shape
    assert torch.all(out[0, :4] == 0) and torch.all(out[0, :, :4] == 0)
    assert torch.all(out[0, 4:, 4:] == 1)
    # the far corner, mirrored: ones at the top left, zeros at the bottom
    assert torch.all(out[1, :2, 4:] == 1) and torch.all(out[1, 2:] == 0)
    with pytest.raises(ValueError, match="offsets"):
        crop_flip(x, torch.tensor([[0, 9], [0, 0]]), torch.zeros(2, dtype=bool))
    with pytest.raises(ValueError, match="fit"):
        crop_flip(x, torch.zeros(3, 2, dtype=torch.int64),
                  torch.zeros(2, dtype=bool))


def test_draws_are_uniform_and_fair():
    """Channel 0 of x holds the row, channel 1 the column (1-based): a
    pixel of the output names its crop offset and whether it was
    mirrored."""
    b, h, pad = 4500, 16, 4
    rows = torch.arange(1, h + 1, dtype=torch.float32)
    x = torch.stack(torch.broadcast_tensors(rows[:, None], rows[None, :]),
                    -1).expand(b, h, h, 2)
    out = random_crop_flip(123, x, pad, index=9)
    a, c = out[:, 8, 6, 1], out[:, 8, 9, 1]
    flipped = a > c
    oy = (out[:, 8, 6, 0] - (8 - pad + 1)).long()
    ox = torch.where(flipped, a - 6, a - 3).long()
    for off in (oy, ox):
        cnt = torch.bincount(off, minlength=2 * pad + 1).double()
        assert len(cnt) == 2 * pad + 1
        exp = b / (2 * pad + 1)
        assert float(((cnt - exp) ** 2 / exp).sum()) < 26.1
    assert abs(flipped.double().mean().item() - 0.5) < 4 * (0.25 / b) ** 0.5
    # a pure function of (seed, index), different across indices
    assert torch.equal(out, random_crop_flip(123, x, pad, index=9))
    assert not torch.equal(out, random_crop_flip(123, x, pad, index=10))


def _setup(n_train=64):
    ds = get_dataset("mnist", data_dir="/nonexistent", n_synth_train=n_train,
                     n_synth_test=32)
    model = get_model("lenet_me", bayes=BayesConfig(rate=0.25), fused=True)
    tx = get_optimizer(get_recipe("lenet"), 4)
    return model, tx, create_state(model, tx, 0, ds.x_train[:16],
                                   device="cpu"), ds


def _stacked(x, y, bsz=16):
    n = len(x) // bsz
    return (torch.from_numpy(x[:n * bsz]).reshape((n, bsz) + x.shape[1:]),
            torch.from_numpy(y[:n * bsz].astype(np.int64)).reshape(n, bsz))


def test_train_epoch_equals_the_step_loop():
    aug = lambda s, x, i: random_crop_flip(s, x, 4, i)  # noqa: E731
    model, tx, state, ds = _setup()
    xs, ys = _stacked(ds.x_train, ds.y_train)
    ms = make_train_epoch(model, tx, augment_fn=aug)(state, xs, ys, 9)
    ref_model, ref_tx, ref, _ = _setup()
    step = make_train_step(ref_model, ref_tx)
    losses = []
    for i in range(len(xs)):
        seeds = step_seeds(9, ref.step, ref_model.num_sites)
        x = aug(fold_seed(9, ref.step), xs[i], i)
        losses.append(step(ref, x, ys[i], seeds)["loss"])
    assert state.step == ref.step == 4
    for (k, p), q in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(p, q), k
    assert ms["loss"] == torch.stack(losses).mean()
    assert {"loss", "grad_norm", "exit0_top1", "exit1_top1"} <= set(ms)
    # the eval epoch: the mean of eval steps at EVAL_STEP0 + i
    ev = make_eval_epoch(model)(xs, ys, 9)
    one = make_eval_step(model)
    want = [one(xs[i], ys[i], step_seeds(9, EVAL_STEP0 + i, 2))
            for i in range(len(xs))]
    for k in ev:
        assert ev[k] == torch.stack([w[k].float() for w in want]).mean(), k


@pytest.mark.parametrize("uniform", [True, False])
def test_augment_index_follows_the_path(uniform):
    """Stacked batches: the index in the epoch; batches of mixed shapes
    (the last one short): the step. The seed is ``fold_seed(seed,
    step)`` either way."""
    model, tx, state, ds = _setup(n_train=56)
    seen = []

    def aug(s, x, i):
        seen.append((s, i, len(x)))
        return x

    batches = (lambda: iterate_batches(ds.x_train, ds.y_train, 16,
                                       drop_remainder=uniform))
    train_loop(model, state, tx, batches, 4, 2, augment_fn=aug,
               log_fn=lambda m: None)
    per = 3 if uniform else 4
    assert state.step == 2 * per
    steps = list(range(2 * per))
    assert [s for s, _, _ in seen] == [fold_seed(4, t) for t in steps]
    want = [t % per for t in steps] if uniform else steps
    assert [i for _, i, _ in seen] == want


def test_reshuffle_is_a_bijection_of_seed_and_epoch():
    """An augment_fn that returns x as it is records each epoch's batches;
    pixel (0, 0) of an example holds its id."""
    def epochs(seed):
        model, tx, state, ds = _setup(n_train=48)
        x = ds.x_train.copy()
        x[:, 0, 0, 0] = np.arange(len(x))
        seen = []
        train_loop(model, state, tx,
                   lambda: iterate_batches(x, ds.y_train, 16, shuffle=False),
                   seed, 3, reshuffle=True, log_fn=lambda m: None,
                   augment_fn=lambda s, xb, i: seen.append(
                       xb[:, 0, 0, 0].long()) or xb)
        return [torch.cat(seen[e * 3:(e + 1) * 3]).tolist()
                for e in range(3)]

    a, b, again = epochs(1), epochs(2), epochs(1)
    assert a == again
    for order in a + b:
        assert sorted(order) == list(range(48))
    assert len({tuple(o) for o in a + b}) == 6
