"""The rest of the port's engine (``compile``, ``benchmark``, ``autotune``,
``evaluate_repeated``, ``compare``, ``cost_analysis``) and its timing
helpers, on the CPU.

The engine serves the converter sweep's model (``cli/sweep.py:_point``:
``Sequential(convert_to_bayesian(lenet_specs(), MC 0.25, n = 3),
fused=True)``) at batch 4 on MNIST shapes, S = 4; the JAX engine serves
its twin for the key sets. On the CPU ``compile`` captures nothing (the
CUDA graph needs a card) and the timings come from the host clock, so
nothing here asserts which mapping is faster: only that the adopted one is
the faster of the timings ``autotune`` itself reports.
"""

import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.engine.engine import BayesEngine as JEngine
from bayestpu.nn import convert as jc
from bayestpu_torch.core.config import BayesConfig, EngineConfig, SamplingMode
from bayestpu_torch.core.rng import fold_seed
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.nn.convert import (MCDropoutModel, Sequential,
                                       convert_to_bayesian, lenet_specs)
from bayestpu_torch.utils.profiler import cost_report
from bayestpu_torch.utils.timing import measure_windows, paired_compare

BAYES = BayesConfig(rate=0.25, num_bayes_layers=3, num_samples=4)
CPU = torch.device("cpu")
FAST = dict(iters=2, min_diff_s=0.0)


def _x(batch=4):
    return np.random.default_rng(0).normal(size=(batch, 28, 28, 1)).astype(
        np.float32)


def _engine(mode=SamplingMode.SPATIAL):
    model = Sequential(convert_to_bayesian(lenet_specs(), BAYES), (28, 28, 1),
                       fused=True)
    return BayesEngine(model, BAYES, EngineConfig(mode=mode),
                       device="cpu").init(0, _x())


@pytest.fixture(scope="module")
def jax_keys():
    """The key sets of the JAX engine's reports on the sweep's model."""
    jb = JBayes(rate=0.25, num_bayes_layers=3, num_samples=4)
    x = jnp.asarray(_x())
    eng = JEngine(jc.Sequential(tuple(jc.convert_to_bayesian(
        jc.lenet_specs(), jb)), fused=True), jb).init(jax.random.key(0), x)
    return {"compile": set(eng.compile(x)),
            "benchmark": set(eng.benchmark(x, iters=1, min_diff_s=0.0,
                                           max_iters=1)),
            "cost_analysis": set(eng.cost_analysis(x)),
            "compare": set(eng.compare(x, jnp.full((4, 10), 0.1)))}


def test_compile_on_cpu_keeps_predict(jax_keys):
    eng = _engine()
    x = _x()
    before = eng.predict(x, seed=5)
    rep = eng.compile(x)
    assert set(rep) == jax_keys["compile"]
    assert rep["num_samples"] == 4 and rep["input_shape"] == (4, 28, 28, 1)
    assert rep["mode"] == "spatial" and rep["compile_seconds"] >= 0.0
    after = eng.predict(x, seed=5)
    for a, b in zip(before[:3], after[:3]):
        assert torch.equal(a, b)
    assert not torch.equal(eng.predict(x, seed=6).probs, after.probs)


def test_compile_refuses_an_uninitialized_engine():
    model = Sequential(convert_to_bayesian(lenet_specs(), BAYES), (28, 28, 1))
    with pytest.raises(RuntimeError, match="init"):
        BayesEngine(model, BAYES, device="cpu").compile(_x())


def test_compile_with_auto_tunes_first():
    eng = _engine(SamplingMode.AUTO)
    rep = eng.compile(_x())
    assert eng._tuned is not None and rep["mode"] == eng._tuned["mode"]
    assert rep["mode"] in ("spatial", "temporal")


def test_autotune_adopts_the_faster_of_its_timings():
    eng = _engine(SamplingMode.AUTO)
    rep = eng.autotune(_x(), iters=1)
    assert set(rep) == {"mode", "timings_s", "paired", "num_samples",
                        "input_shape"}
    t = rep["timings_s"]
    assert set(t) == {"spatial", "temporal"} and min(t.values()) > 0
    other = "temporal" if rep["mode"] == "spatial" else "spatial"
    assert t[rep["mode"]] <= t[other]
    assert eng._mode().value == rep["mode"]
    assert len(rep["paired"]["pairs"]) == 3
    assert rep["num_samples"] == 4 and rep["input_shape"] == (4, 28, 28, 1)


def test_benchmark_keys(jax_keys):
    eng = _engine()
    rep = eng.benchmark(_x(), **FAST)
    assert set(rep) == jax_keys["benchmark"]
    assert rep["rtt_fallback"] is False and rep["num_samples"] == 4
    assert rep["latency_s"] > 0
    np.testing.assert_allclose(rep["images_per_s"] * rep["latency_s"], 4)
    np.testing.assert_allclose(rep["samples_per_s"] * rep["latency_s"], 16)


def test_evaluate_repeated_matches_its_passes(tmp_path):
    eng = _engine()
    x, y = _x(), np.array([0, 1, 2, 3])
    log = tmp_path / "log_0.txt"
    out = eng.evaluate_repeated(x, y, passes=3, seed=9, log_path=str(log))
    runs = [eng.evaluate(x, y, fold_seed(9, p)) for p in range(3)]
    assert out["passes"] == 3
    for name in runs[0]:
        v = np.array([r[name] for r in runs])
        np.testing.assert_allclose(out[name], v.mean(), rtol=1e-12)
        np.testing.assert_allclose(out[f"{name}_std"], v.std(), rtol=1e-9,
                                   atol=1e-15)
    assert len({r["nll"] for r in runs}) == 3
    lines = log.read_text().splitlines()
    assert lines == [f"{k}: {v}" for k, v in out.items()]


def test_fold_seed_is_stable_and_distinct():
    seeds = [fold_seed(9, p) for p in range(50)] + [fold_seed(10, 0)]
    assert len(set(seeds)) == len(seeds)
    assert fold_seed(9, 3) == seeds[3] and 0 <= min(seeds)
    assert max(seeds) < 2 ** 64


def test_compare_matches_numpy(jax_keys):
    eng = _engine()
    x = _x()
    ref = np.random.default_rng(3).dirichlet(np.ones(10), size=4).astype(
        np.float32)
    rep = eng.compare(x, ref, seed=2)
    assert set(rep) == jax_keys["compare"]
    p = eng.predict(x, seed=2).probs[-1].numpy()
    d = np.abs(p - ref)
    np.testing.assert_allclose(rep["max_abs_diff"], d.max(), rtol=1e-6)
    np.testing.assert_allclose(rep["mean_abs_diff"], d.mean(), rtol=1e-6)
    assert rep["top1_agreement"] == np.mean(p.argmax(-1) == ref.argmax(-1))


def test_cost_analysis_keys_and_sizes(jax_keys):
    eng = _engine()
    x = _x()
    rep = eng.cost_analysis(x)
    assert set(rep) == jax_keys["cost_analysis"] | {"device_ms", "launches"}
    for k in ("generated_code_size_in_bytes", "device_ms", "launches"):
        assert rep[k] is None, k
    assert rep["temp_size_in_bytes"] > 0
    m = eng.model
    want = sum(t.numel() * 4 for t in (*m.parameters(), *m.buffers()))
    assert rep["argument_size_in_bytes"] == want + x.size * 4 + 4 * 3 * 2 * 4
    # probs and var (E, B, C), entropy (E, B), f32
    assert rep["output_size_in_bytes"] == 4 * (2 * 40 + 4)
    assert rep["bytes_accessed"] == (rep["argument_size_in_bytes"]
                                     + rep["output_size_in_bytes"])
    # the operations of one predict, as utils.profiler counts them
    seeds = eng.seeds(0, 4)
    want = cost_report(eng._predict_fn(), torch.from_numpy(x), seeds)
    assert rep["flops"] == want["flops"] > 0


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    model = Sequential(convert_to_bayesian(lenet_specs(), BAYES), (28, 28, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        BayesEngine(model, BAYES)
    with pytest.raises(RuntimeError, match="CUDA"):
        MCDropoutModel(lenet_specs())


def test_timing_helpers_on_the_host_clock():
    """``measure_windows`` grows its window until it lasts ``min_diff_s``;
    ``paired_compare`` alternates the two functions and names the faster
    by the median per-pair ratio (a 1 ms sleep against a 6 ms one)."""
    res = measure_windows(lambda: time.sleep(0.001), CPU, iters=1,
                          min_diff_s=0.01)
    assert res.k in (4, 16) and len(res.windows) == 3
    assert res.median_s >= 0.001
    cmp = paired_compare(lambda: time.sleep(0.001),
                         lambda: time.sleep(0.006), CPU, iters=1,
                         labels=("fast", "slow"))
    assert cmp["winner"] == "fast" and len(cmp["pairs"]) == 3
    assert cmp["median_ratio_a_over_b"] < 1
    assert cmp["median_fast_s"] < cmp["median_slow_s"]
