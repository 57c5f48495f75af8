"""The port's sampler, metrics and engine against the JAX package's, on the
CPU, plus the port's import guards.

The spatial predictive is compared on the same weights (JAX init variables)
and the seeds each JAX site passed to its kernel, captured per sample key
(``sample_keys`` folds the sample index into the key) with a test-local
wrapper of ``bayestpu.nn.fused.dropout_matmul_inference``.
"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.nn.fused as jfused
from bayestpu.core import config as jconfig
from bayestpu.core.rng import sample_keys
from bayestpu.engine import sampler as jsampler
from bayestpu.metrics import ece as jece
from bayestpu.metrics import entropy as jentropy
from bayestpu.nn import multiexit as jmultiexit
from bayestpu.nn.zoo import get_model as jax_get_model
from bayestpu_torch.core import config as tconfig
from bayestpu_torch.core.rng import sample_seeds
from bayestpu_torch.engine import sampler as tsampler
from bayestpu_torch.engine import sharding
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.metrics import ece as tece
from bayestpu_torch.metrics import entropy as tentropy
from bayestpu_torch.nn import multiexit as tmultiexit
from bayestpu_torch.nn.zoo import get_model

REPO = Path(__file__).resolve().parent.parent
S = 3
RATE = 0.25


@pytest.fixture(scope="module")
def flagship():
    """JAX vgg11_me (f32, fused), its variables as numpy, an input, and the
    JAX spatial predictive with the seeds its sites drew."""
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = jax_get_model("vgg11_me", bayes=jconfig.BayesConfig(rate=RATE),
                       fused=True)
    key = jax.random.key(0)
    variables = jm.init({"params": key, "bayes": key}, jnp.asarray(x))
    pkey = jax.random.key(5)
    pred = jsampler.predictive(jm, variables, jnp.asarray(x), pkey, S,
                               jconfig.SamplingMode.SPATIAL)
    seen = []
    orig = jfused.dropout_matmul_inference

    def spy(xx, w, seeds, rate, **kw):
        seen.append(np.asarray(seeds))
        return orig(xx, w, seeds, rate, **kw)

    jfused.dropout_matmul_inference = spy
    try:
        for i, k in enumerate(sample_keys(pkey, S)):
            jm.apply(variables, jnp.asarray(x), sample_idx=i, train=False,
                     rngs={"bayes": k})
    finally:
        jfused.dropout_matmul_inference = orig
    seeds = np.stack(seen).reshape(S, 5, 2).astype(np.int32)
    return x, jax.tree.map(np.asarray, variables), pred, seeds


def _port(variables):
    model = get_model("vgg11_me", bayes=tconfig.BayesConfig(rate=RATE),
                      fused=True)
    return load_flax_variables(model, variables).eval()


# ------------------------------------------------------------- sampler


def test_spatial_predictive_matches_jax(flagship):
    """Same weights and seeds: f32 values agree to summation order."""
    x, variables, want, seeds = flagship
    model = _port(variables)
    with torch.inference_mode():
        got = tsampler.predictive(model, torch.from_numpy(x),
                                  torch.from_numpy(seeds))
    assert got.num_samples == S
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(want.entropy),
                               rtol=1e-5, atol=1e-6)


def test_temporal_and_spatial_bit_identical(flagship):
    x, variables, _, seeds = flagship
    model = _port(variables)
    xt, st = torch.from_numpy(x), torch.from_numpy(seeds)
    with torch.inference_mode():
        sp = tsampler.mc_logits(model, xt, st, tconfig.SamplingMode.SPATIAL)
        tm = tsampler.mc_logits(model, xt, st, tconfig.SamplingMode.TEMPORAL)
        mom = tsampler.mc_moments(model, xt, st)
        pred = tsampler.predictive(model, xt, st)
    assert sp.shape == (S, 5, 2, 10)
    assert torch.equal(sp, tm)
    # streaming moments: the same formulas as JAX's mc_moments
    np.testing.assert_allclose(mom.probs.numpy(), pred.probs.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mom.var.numpy(), pred.var.numpy(), atol=1e-6)
    assert bool((mom.var >= 0).all())


def test_mc_moments_formulas_match_jax():
    """mean, clamped variance and eps-entropy on the same per-sample
    probabilities, through both packages' moment formulas."""
    logits = np.random.default_rng(2).normal(size=(6, 5, 4, 10)).astype(
        np.float32) * 3
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    s1, s2 = p.sum(0), (p * p).sum(0)
    mean = s1 / 6
    want_var = jnp.maximum(s2 / 6 - mean * mean, 0.0)

    class Replay(torch.nn.Module):
        def forward(self, x, seeds, sample_idx=None):
            return tmultiexit.ExitOutputs(torch.from_numpy(
                logits[int(seeds[0, 0])]))

    seeds = torch.arange(6, dtype=torch.int32)[:, None, None].expand(
        6, 1, 2)
    got = tsampler.mc_moments(Replay(), None, seeds)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(mean),
                               rtol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want_var),
                               atol=1e-7)
    np.testing.assert_allclose(got.entropy.numpy(),
                               np.asarray(jsampler._entropy(mean)),
                               rtol=1e-6)


# ------------------------------------------------------------- metrics


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(200, 10)).astype(np.float32) * 2
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    labels = rng.integers(0, 10, size=200)
    want = jece.eval_metrics(jnp.asarray(probs), jnp.asarray(labels))
    got = tece.eval_metrics(torch.from_numpy(probs),
                            torch.from_numpy(labels))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        float(tentropy.mean_predictive_entropy(torch.from_numpy(probs))),
        float(jentropy.mean_predictive_entropy(jnp.asarray(probs))),
        rtol=1e-6)


def test_exit_ensembles_match_jax():
    logits = np.random.default_rng(4).normal(size=(5, 3, 10)).astype(
        np.float32)
    np.testing.assert_allclose(
        tmultiexit.exit_ensemble_probs(torch.from_numpy(logits)).numpy(),
        np.asarray(jmultiexit.exit_ensemble_probs(jnp.asarray(logits))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tmultiexit.ensemble_logit_mean(torch.from_numpy(logits)).numpy(),
        np.asarray(jmultiexit.ensemble_logit_mean(jnp.asarray(logits))),
        rtol=1e-6)


# -------------------------------------------------------------- config


def test_config_copies_serialise_like_jax():
    for jc, tc in [(jconfig.BayesConfig(), tconfig.BayesConfig()),
                   (jconfig.EngineConfig(), tconfig.EngineConfig()),
                   (jconfig.QuantConfig(int8_infer=True),
                    tconfig.QuantConfig(int8_infer=True)),
                   (jconfig.BayesConfig(kind=jconfig.DropoutKind.MASK,
                                        rate=0.1),
                    tconfig.BayesConfig(kind=tconfig.DropoutKind.MASK,
                                        rate=0.1))]:
        assert json.loads(tconfig.to_json(tc)) == json.loads(
            jconfig.to_json(jc))
    for name in ("DropoutKind", "SamplingMode", "InsertStrategy"):
        assert ([m.value for m in getattr(tconfig, name)]
                == [m.value for m in getattr(jconfig, name)])
    for name in ("QuantConfig", "BayesConfig", "EngineConfig"):
        tf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(tconfig, name))]
        jf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jconfig, name))]
        assert [n for n, _ in tf] == [n for n, _ in jf]


def test_config_validation():
    with pytest.raises(ValueError):
        tconfig.BayesConfig(rate=1.5)
    with pytest.raises(ValueError):
        tconfig.BayesConfig(kind=tconfig.DropoutKind.MASK, num_masks=1)
    with pytest.raises(ValueError):
        tconfig.QuantConfig(total_bits=1)
    assert tconfig.BayesConfig(kind=tconfig.DropoutKind.MASK,
                               num_masks=6).effective_samples == 6


# ----------------------------------------------------------------- rng


def test_sample_seeds_prefix_stable_and_distinct():
    a = sample_seeds(7, 4, 5)
    b = sample_seeds(7, 9, 5)
    assert a.dtype == torch.int32 and a.shape == (4, 5, 2)
    assert torch.equal(b[:4], a)               # sample i ignores S
    assert len(set(map(tuple, b.reshape(-1, 2).tolist()))) == 45
    assert not torch.equal(sample_seeds(8, 4, 5), a)
    assert torch.equal(sample_seeds(-1, 2, 5), sample_seeds(2 ** 64 - 1, 2,
                                                            5))


# -------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engine():
    model = get_model("vgg11_me", bayes=tconfig.BayesConfig(rate=RATE),
                      fused=True, dtype=torch.bfloat16)
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    return BayesEngine(model, device="cpu").init(0, x), x


def test_engine_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    model = get_model("vgg11_me", bayes=tconfig.BayesConfig(rate=RATE),
                      fused=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        BayesEngine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        BayesEngine(model, device="cuda")


def test_engine_predict_and_one_sample(engine):
    eng, x = engine
    pred = eng.predict(x, seed=3, num_samples=4)
    assert pred.probs.shape == (5, 4, 10) and pred.entropy.shape == (5, 4)
    assert bool(torch.isfinite(pred.probs).all())
    np.testing.assert_allclose(pred.probs.sum(-1).numpy(), 1.0, atol=1e-5)
    one = [eng.predict(x, seed=3, sample_idx=i) for i in range(4)]
    np.testing.assert_allclose(torch.stack(one).mean(0).numpy(),
                               pred.probs.numpy(), rtol=1e-5, atol=1e-7)
    other = eng.predict(x, seed=4, num_samples=4)
    assert not torch.allclose(other.probs, pred.probs)


def test_engine_temporal_equals_spatial(engine):
    eng, x = engine
    tm = BayesEngine(eng.model, config=tconfig.EngineConfig(
        mode=tconfig.SamplingMode.TEMPORAL), device="cpu")
    tm.ready = True
    a = eng.predict(x, seed=1, num_samples=3)
    b = tm.predict(x, seed=1, num_samples=3)
    np.testing.assert_allclose(a.probs.numpy(), b.probs.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_engine_evaluate(engine):
    eng, x = engine
    y = np.array([0, 1, 2, 3])
    mets = eng.evaluate(x, y, seed=0, num_samples=3)
    assert set(mets) == {"acc", "nll", "mse", "ece_hist", "ece_ew10", "aPE"}
    assert all(isinstance(v, float) and np.isfinite(v)
               for v in mets.values())
    assert 0.0 <= mets["acc"] <= 1.0


def test_engine_guards(engine):
    eng, x = engine
    model = get_model("vgg11_me", bayes=tconfig.BayesConfig(rate=RATE),
                      fused=True)
    with pytest.raises(RuntimeError, match="init"):
        BayesEngine(model, device="cpu").predict(x)
    with pytest.raises(ValueError, match="fit"):
        BayesEngine(model, device="cpu").init(0, x[:, :16])
    # SHARDED runs as spatial on one process, as in JAX; a 1x1 mesh (no
    # process group) serves the same predictive through the sharded path
    want = eng.predict(x, seed=4, num_samples=3)
    sharded = BayesEngine(eng.model, config=tconfig.EngineConfig(
        mode=tconfig.SamplingMode.SHARDED), device="cpu")
    sharded.ready = True
    meshed = BayesEngine(eng.model, device="cpu", mesh=sharding.make_mesh())
    meshed.ready = True
    for got in (sharded.predict(x, seed=4, num_samples=3),
                meshed.predict(x, seed=4, num_samples=3)):
        assert got.num_samples == 3
        torch.testing.assert_close(got.probs, want.probs, rtol=0, atol=1e-7)
        torch.testing.assert_close(got.var, want.var, rtol=0, atol=1e-7)


# -------------------------------------------------------------- guards


def test_import_pulls_in_no_jax():
    code = ("import sys, bayestpu_torch, bayestpu_torch.engine.engine, "
            "bayestpu_torch.nn.zoo, bayestpu_torch.kernels._build, "
            "bayestpu_torch.train.loop, bayestpu_torch.data.datasets, "
            "bayestpu_torch.nn.bayes, bayestpu_torch.kernels.mask_bank, "
            "bayestpu_torch.kernels.masked_conv, bayestpu_torch.nn.fused, "
            "bayestpu_torch.nn.convert, bayestpu_torch.nn.zoo.autobayes, "
            "bayestpu_torch.utils.timing, bayestpu_torch.metrics, "
            "bayestpu_torch.metrics.analysis, bayestpu_torch.native, "
            "bayestpu_torch.engine.inference, bayestpu_torch.data.pipeline, "
            "bayestpu_torch.engine.sharding, bayestpu_torch.engine.distributed, "
            "bayestpu_torch.train.checkpoint, bayestpu_torch.data.augment, "
            "bayestpu_torch.utils.profiler, bayestpu_torch.utils.rundb, "
            "bayestpu_torch.interop.torch_import, "
            "bayestpu_torch.interop.keras_import, bayestpu_torch.cli, "
            "bayestpu_torch.cli.common, bayestpu_torch.cli.train, "
            "bayestpu_torch.cli.predict, bayestpu_torch.cli.analyze, "
            "bayestpu_torch.cli.build, bayestpu_torch.cli.sweep, "
            "bayestpu_torch.cli.figures, bayestpu_torch.cli.time_cost, "
            "bayestpu_torch.cli.verify_accuracy, bayestpu_torch.bench, "
            "bayestpu_torch.bench.kernels, bayestpu_torch.bench.scaling, "
            "bayestpu_torch.bench.timing"
            "\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
            "'bayestpu') or m.startswith(('jax.', 'flax.', 'optax.', "
            "'bayestpu.'))]\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|bayestpu)(\s|\.|,|$)", re.M)
    files = sorted((REPO / "bayestpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    # nor does a port module name a path under the JAX package (its native
    # sources included): a string that starts with the package's directory
    # (chip_smoke.py names the TPU kernels' lines it reports against)
    path = re.compile(r"""["']bayestpu(/|["'])""")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
        assert f.name == "chip_smoke.py" or not path.search(f.read_text()), f


def test_no_port_module_reads_the_jax_package(tmp_path):
    """Import every port module, build the native library into an empty
    directory and call both of its entry points, with an audit hook that
    records every file opened, and every argument of a started process,
    under ``bayestpu/``: none."""
    code = f"""
import os, sys
root = os.path.realpath("bayestpu") + os.sep
seen = []
def under(a):
    try:
        return os.path.realpath(os.fsdecode(a)).startswith(root)
    except (TypeError, ValueError):
        return False
def hook(event, args):
    if event == "open" and under(args[0]):
        seen.append(args[0])
    if event == "subprocess.Popen":
        seen.extend(a for a in (args[1] or []) if under(a))
sys.addaudithook(hook)
import pkgutil, importlib, numpy as np
import bayestpu_torch
for m in pkgutil.walk_packages(bayestpu_torch.__path__, "bayestpu_torch."):
    importlib.import_module(m.name)
from bayestpu_torch import native
native.BUILD_DIR = __import__("pathlib").Path({str(tmp_path)!r})
p = np.full((8, 3), 0.2); p[:, 0] = 0.6
native.kde_ece(p, np.zeros(8, np.int64))
native.augment_gather(np.ones((4, 6, 6, 1), np.float32), np.arange(2),
                      np.zeros(1), np.ones(1), 2, 1, True)
assert list(native.BUILD_DIR.glob("*.so")), "nothing was built"
print(seen)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
