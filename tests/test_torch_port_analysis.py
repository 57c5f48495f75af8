"""The port's early exit, FLOPs, KDE-ECE and ``FullAnalysis`` against the
JAX package's, on the CPU.

- ``early_exit_select``, ``confidence_exiting`` and ``threshold_sweep`` on
  seeded (E, B, C) probabilities with ties planted (two classes equal at
  the top, a confidence equal to the threshold), ``max`` and ``margin``,
  ``first_exit`` 0-2: exit indices and selected probabilities equal,
  metrics within rtol 1e-6; the caller's tensor is not written.
- ``flops_standard`` and ``flops_ensembled`` for both tables, ``exit_only``
  both ways: equal integers.
- ``ece_kde(native=False)`` equal to JAX's ``ece_kde(native=False)`` on the
  cases of ``tests/test_kde_ece.py``.
- ``FullAnalysis.collect`` on ``lenet_me`` (the JAX test's model, unfused:
  threefry sites) against JAX's ``collect`` on the seeds each JAX batch
  drew (``capture_site_keys``), rtol 1e-5; the prefix mean of
  ``collect_samples`` equal to a fresh run with fewer passes.
- ``run``, ``multipass_experiment``, ``confidence_exiting_table`` (with
  FLOPs), ``save`` and ``save_validation`` against JAX's on the same (E, N,
  C) predictions (``collect``/``collect_samples`` replaced on both sides):
  counts equal, floats within rtol 1e-6, the CSV log text identical but
  for a float printed one unit of its sixth decimal away (an f32 mean
  summed in another order), each ``.npy`` record equal. JAX's KDE runs
  its numpy version, so that this file never builds the JAX package's
  native library in place.
"""

import functools
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.metrics.analysis as janalysis
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.rng import sample_keys
from bayestpu.engine import inference as jinf
from bayestpu.metrics import flops as jflops
from bayestpu.metrics import kde as jkde
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu_torch.core.config import BayesConfig
from bayestpu_torch.engine import inference as tinf
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.metrics import analysis as tanalysis
from bayestpu_torch.metrics import flops as tflops
from bayestpu_torch.metrics import kde as tkde
from bayestpu_torch.nn.zoo import get_model
from port_threads import thread_budget  # noqa: F401
from test_torch_port_threefry import capture_site_keys

RATE = 0.25


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


# ------------------------------------------------------------ early exit


def _probs(seed, e=4, b=64, c=10):
    """Seeded (E, B, C) softmax probabilities with ties planted: rows 0-3
    have two equal top classes at every exit (margin 0), rows 4-5 a top-1
    of exactly 0.5 (and 0.9), equal to a swept threshold."""
    rng = np.random.default_rng(seed)
    logits = 3 * rng.normal(size=(e, b, c))
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    p = p.astype(np.float32)
    p[:, :4, :] = 0.0
    p[:, :4, 2] = p[:, :4, 5] = 0.375
    p[:, :4, 7] = 0.25
    p[:, 4, :] = 0.5 / (c - 1)
    p[:, 4, 3] = 0.5
    p[:, 5, :] = np.float32(0.1) / (c - 1)
    p[:, 5, 1] = np.float32(0.9)
    labels = rng.integers(0, c, b)
    return p, labels


@pytest.mark.parametrize("first_exit", [0, 1, 2])
@pytest.mark.parametrize("rule", ["max", "margin"])
def test_early_exit_matches_jax(rule, first_exit):
    p, labels = _probs(first_exit + 3 * (rule == "margin"))
    pt = torch.from_numpy(p)
    before = pt.clone()
    for t in (0.0, 0.25, 0.5, 0.9, 0.99):
        want = jinf.early_exit_select(jnp.asarray(p), t, rule, first_exit)
        got = tinf.early_exit_select(pt, t, rule, first_exit)
        np.testing.assert_array_equal(got.exit_idx.numpy(),
                                      np.asarray(want.exit_idx))
        np.testing.assert_array_equal(got.probs.numpy(),
                                      np.asarray(want.probs))
        _close(got.exit_frac.numpy(), np.asarray(want.exit_frac))
        jm = jinf.confidence_exiting(jnp.asarray(p), jnp.asarray(labels), t,
                                     rule, first_exit)
        tm = tinf.confidence_exiting(pt, torch.from_numpy(labels), t, rule,
                                     first_exit)
        assert list(tm) == list(jm)
        for k in jm:
            _close(tm[k].item(), float(jm[k]))
    assert torch.equal(pt, before)          # the caller's tensor is intact
    want = jinf.threshold_sweep(jnp.asarray(p), jnp.asarray(labels),
                                rule=rule, first_exit=first_exit)
    got = tinf.threshold_sweep(pt, torch.from_numpy(labels), rule=rule,
                               first_exit=first_exit)
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert g["threshold"] == w["threshold"]
        _close([g[k] for k in w], [w[k] for k in w])
    assert tinf.REFERENCE_THRESHOLDS == jinf.REFERENCE_THRESHOLDS


def test_early_exit_ties_and_bad_rule():
    """A tie at the top is margin 0 and never exits early; a confidence
    equal to the threshold does not clear it; an unknown rule raises."""
    p, _ = _probs(9)
    got = tinf.early_exit_select(torch.from_numpy(p), 0.0, "margin")
    assert (got.exit_idx[:4] == p.shape[0] - 1).all()
    got = tinf.early_exit_select(torch.from_numpy(p), 0.5, "max")
    assert got.exit_idx[4] == p.shape[0] - 1
    with pytest.raises(ValueError, match="rule"):
        tinf.early_exit_select(torch.from_numpy(p), 0.5, "bogus")


# ----------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("exit_only", [True, False])
@pytest.mark.parametrize("model_type", ["vgg19", "resnet18"])
def test_flops_match_jax(model_type, exit_only):
    jt, tt = jflops.TABLES[model_type], tflops.TABLES[model_type]
    assert (tt.per_layer, tt.per_exit_convs, tt.per_exit) == (
        jt.per_layer, jt.per_exit_convs, jt.per_exit)
    assert tt.baseline == jt.baseline and tt.n_exits == jt.n_exits
    e = np.random.default_rng(len(model_type)).integers(0, tt.n_exits, 500)
    for mc in (1, 10, 49):
        for fn in ("flops_standard", "flops_ensembled"):
            got = getattr(tflops, fn)(e, tt, mc, exit_only)
            want = getattr(jflops, fn)(e, jt, mc, exit_only)
            assert type(got) is int and got == want


# ------------------------------------------------------------------- KDE


def _kde_cases():
    """The inputs of ``tests/test_kde_ece.py``: calibrated and
    overconfident binary, multiclass with int and one-hot labels."""
    out = []
    for conf, seed in ((0.7, 0), (0.85, 3)):
        rng = np.random.default_rng(seed)
        n = 8000
        labels = rng.integers(0, 2, n)
        correct = rng.random(n) < conf
        pred = np.where(correct, labels, 1 - labels)
        probs = np.zeros((n, 2))
        probs[np.arange(n), pred] = conf
        probs[np.arange(n), 1 - pred] = 1 - conf
        probs += rng.normal(0, 0.01, probs.shape)
        probs = np.clip(probs, 1e-6, 1)
        probs /= probs.sum(1, keepdims=True)
        out.append((probs, labels))
    rng = np.random.default_rng(1)
    n = 4000
    labels = rng.integers(0, 2, n)
    pred = rng.integers(0, 2, n)
    probs = np.zeros((n, 2))
    probs[np.arange(n), pred] = 0.95
    probs[np.arange(n), 1 - pred] = 0.05
    probs += rng.normal(0, 0.01, probs.shape)
    probs = np.clip(probs, 1e-6, 1)
    probs /= probs.sum(1, keepdims=True)
    out.append((probs, labels))
    rng = np.random.default_rng(2)
    n, c = 2000, 10
    logits = 3 * rng.normal(size=(n, c))
    labels = np.argmax(logits + rng.normal(size=(n, c)), axis=-1)
    probs = np.exp(logits)
    probs /= probs.sum(1, keepdims=True)
    out += [(probs, labels), (probs, np.eye(c)[labels])]
    return out


@pytest.mark.parametrize("case", range(5))
def test_numpy_kde_equals_jax(case):
    probs, labels = _kde_cases()[case]
    for order in (1, 2):
        got = tkde.ece_kde(probs, labels, order, native=False)
        want = jkde.ece_kde(probs, labels, order, native=False)
        assert got == want


# ---------------------------------------------------------- FullAnalysis


@pytest.fixture(scope="module")
def lenet():
    """The JAX test's setup (``tests/test_analysis.py:12-21``) at n = 40,
    batch 16 (a short last batch), S = 3: JAX's FullAnalysis and the port
    model on its variables."""
    key = jax.random.key(0)
    jm = jax_get_model("lenet_me", bayes=JBayes(rate=RATE))
    x = np.asarray(jax.random.normal(key, (40, 28, 28, 1)))
    y = np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (40,), 0,
                                      10))
    vs = jm.init({"params": key, "bayes": key}, jnp.asarray(x))
    vs = jax.tree.map(np.asarray, vs)
    jfa = janalysis.FullAnalysis(jm, vs, x, y, mc_passes=3, batch_size=16,
                                 key=key, use_kde=False)
    tm = load_flax_variables(get_model("lenet_me",
                                       bayes=BayesConfig(rate=RATE)), vs)
    return jfa, tm, jm, vs, x, y, key


def _captured_seeds(jm, vs, x, key, bs, s):
    """Each batch's seeds as JAX's FullAnalysis draws them: batch i under
    ``fold_in(key, i)``, one key a sample."""
    out = {}
    for start in range(0, x.shape[0], bs):
        keys = sample_keys(jax.random.fold_in(key, start), s)
        _, out[start] = capture_site_keys(jm, vs, x[start:start + bs], keys)
    return out


def test_collect_matches_jax(lenet):
    jfa, tm, jm, vs, x, y, key = lenet
    want = jfa.collect()
    seeds = _captured_seeds(jm, vs, x, key, 16, 3)
    assert seeds[0].shape == (3, tm.num_sites, 2)
    fa = tanalysis.FullAnalysis(tm, x, y, mc_passes=3, batch_size=16,
                                use_kde=False, device="cpu")
    fa._batch_seeds = lambda start, s: torch.from_numpy(seeds[start][:s])
    got = fa.collect()
    assert got.shape == want.shape == (2, 40, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_multipass_prefix_matches_fresh_run(lenet):
    """On the port's own seeds: the mean of the first p cached samples is a
    fresh p-pass ``collect``; a shorter ``collect_samples`` is served from
    the cache; batch i's seeds are ``fold_seed(seed, i)``'s."""
    _, tm, _, _, x, y, _ = lenet
    fa = tanalysis.FullAnalysis(tm, x, y, mc_passes=3, batch_size=16,
                                seed=5, device="cpu")
    samples = fa.collect_samples(3)
    assert samples.shape == (3, 2, 40, 10)
    np.testing.assert_allclose(samples[:2].mean(0), fa.collect(2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(fa.collect_samples(2), samples[:2])
    from bayestpu_torch.core.rng import fold_seed, sample_seeds
    assert torch.equal(fa._batch_seeds(32, 3),
                       sample_seeds(fold_seed(5, 32), 3, tm.num_sites))
    other = tanalysis.FullAnalysis(tm, x, y, mc_passes=3, batch_size=16,
                                   seed=6, device="cpu")
    assert not np.array_equal(other.collect(), fa.collect())


E, N, C = 5, 120, 10


def _fake_preds(n, seed=0, s=None):
    rng = np.random.default_rng(seed + n)
    shape = (E, n, C) if s is None else (s, E, n, C)
    p = np.exp(2 * rng.normal(size=shape))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.fixture
def same_preds(monkeypatch):
    """Both packages' FullAnalysis on the same predictions: ``collect`` and
    ``collect_samples`` replaced by seeded ones of the instance's size; the
    JAX KDE on its numpy version."""
    for mod in (janalysis, tanalysis):
        monkeypatch.setattr(mod.FullAnalysis, "collect",
                            lambda self, mc_passes=None: _fake_preds(
                                len(self.x)))
        monkeypatch.setattr(mod.FullAnalysis, "collect_samples",
                            lambda self, s: _fake_preds(len(self.x), 1, s))
    monkeypatch.setattr(janalysis, "ece_kde",
                        functools.partial(jkde.ece_kde, native=False))
    y = np.random.default_rng(3).integers(0, C, N)
    x = np.zeros((N, 2, 2, 1), np.float32)

    def make(use_kde=True, model_type=None):
        j = janalysis.FullAnalysis(None, None, x, y, mc_passes=10,
                                   use_kde=use_kde, model_type=model_type)
        t = tanalysis.FullAnalysis(torch.nn.Identity(), x, y, mc_passes=10,
                                   use_kde=use_kde, model_type=model_type,
                                   device="cpu")
        return j, t
    return make


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("cur_correct", "cum_correct", "unique_correct",
                  "destructive_overthinking"):
            assert getattr(g, f) == getattr(w, f), f
        _close([g.acc, g.ece_hist, g.nll, g.mse, g.ece_kde],
               [w.acc, w.ece_hist, w.nll, w.mse, w.ece_kde])


def test_run_matches_jax(same_preds):
    j, t = same_preds()
    want, got = j.run(), t.run()
    _rows_close(got.exits, want.exits)
    _rows_close(got.ensemble, want.ensemble)
    for f in ("preds", "ensemble_preds", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.mc_passes == want.mc_passes
    assert sum(r.destructive_overthinking for r in got.exits) > 0


def test_multipass_matches_jax(same_preds):
    j, t = same_preds()
    passes = [1, 2, 5, 9]
    want, got = j.multipass_experiment(passes), t.multipass_experiment(passes)
    assert list(got) == list(want) and got["passes"] == passes
    for k in ("acc", "ens_acc", "ece", "ens_ece"):
        _close(got[k], want[k])


@pytest.mark.parametrize("rule", ["max", "margin"])
def test_confidence_table_matches_jax(same_preds, rule):
    for model_type in ("vgg19", None):
        j, t = same_preds(use_kde=False, model_type=model_type)
        want = j.confidence_exiting_table(rule=rule)
        got = t.confidence_exiting_table(rule=rule)
        assert [list(r) for r in got] == [list(r) for r in want]
        for g, w in zip(got, want):
            for k in ("threshold", "mean_exit", "flops", "flops_ensembled"):
                assert g.get(k) == w.get(k), k
            _close([g[k] for k in w], [w[k] for k in w])
        assert ("flops" in got[0]) == (model_type is not None)


def test_save_and_save_validation_match_jax(same_preds, tmp_path):
    j, t = same_preds()
    ws, gs = j.save(str(tmp_path / "jax"), "e1"), t.save(
        str(tmp_path / "port"), "e1")
    with open(ws["log"]) as f:
        want_log = f.read().splitlines()
    with open(gs["log"]) as f:
        got_log = f.read().splitlines()
    # the same text, but that an f32 mean summed in PyTorch's order may
    # print one unit of its sixth decimal away from XLA's (Known
    # differences 23); the values themselves agree to 1e-6 (above)
    assert got_log[0] == want_log[0] and len(got_log) == len(want_log)
    for g, w in zip(got_log[1:], want_log[1:]):
        gf, wf = g.split(","), w.split(",")
        assert gf[0] == wf[0] and gf[6:] == wf[6:]
        for a, b in zip(gf[1:6], wf[1:6]):
            assert a == b or abs(float(a) - float(b)) <= 1.5e-6, (g, w)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / n),
                                          np.load(tmp_path / "jax" / n))
    with open(tmp_path / "port" / "summary_e1.json") as f:
        summary = json.load(f)
    assert summary["mc_passes"] == 10 and summary["log"] == gs["log"]
    _close([gs["final_acc"], gs["final_ece_kde"]],
           [ws["final_acc"], ws["final_ece_kde"]])
    xv = np.zeros((30, 2, 2, 1), np.float32)
    yv = np.arange(30) % C
    wp = j.save_validation(str(tmp_path / "jax"), xv, yv, "v")
    gp = t.save_validation(str(tmp_path / "port"), xv, yv, "v")
    assert os.path.basename(gp) == os.path.basename(wp)
    with open(wp, "rb") as fw, open(gp, "rb") as fg:
        for _ in range(3):
            np.testing.assert_array_equal(np.load(fg), np.load(fw))
