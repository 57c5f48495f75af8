"""The port's tooling against the JAX package's, on the CPU: ``utils.rundb``
(a byte copy), ``utils.profiler`` (the cost of row 3's call, the
roofline's keys), ``interop.torch_import`` and ``interop.keras_import``
(on a state dict and an ``.h5`` file written here: nothing is fetched, and
the JAX package's keras test needs TensorFlow, which this environment
lacks), and the public names of ROADMAP 14h (``sampler.split_apply``,
``layers.global_avg_pool``, ``native.available``).
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bayestpu.utils.rundb as jrundb
from bayestpu.core.config import BayesConfig as JBayes
from bayestpu.core.config import DropoutKind as JKind
from bayestpu.core.rng import BAYES_RNG
from bayestpu.engine.sampler import split_apply as jsplit_apply
from bayestpu.interop import keras_import as jkeras
from bayestpu.interop import torch_import as jti
from bayestpu.nn.layers import global_avg_pool as jgap
from bayestpu.nn.zoo import get_model as jget_model
from bayestpu.utils import profiler as jprofiler
from bayestpu_torch import native
from bayestpu_torch.core.config import BayesConfig, DropoutKind
from bayestpu_torch.engine.sampler import split_apply
from bayestpu_torch.interop import keras_import as tkeras
from bayestpu_torch.interop import torch_import as tti
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.kernels import masked_matmul as mm
from bayestpu_torch.nn.layers import global_avg_pool
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.utils import profiler, rundb

REPO = Path(__file__).resolve().parents[1]


def _trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


# ------------------------------------------------------------------ rundb


def test_rundb_is_a_byte_copy():
    assert ((REPO / "bayestpu_torch/utils/rundb.py").read_bytes()
            == (REPO / "bayestpu/utils/rundb.py").read_bytes())


@pytest.mark.parametrize("mod", [jrundb, rundb], ids=["jax", "port"])
def test_rundb_roundtrip(mod, tmp_path):
    run = mod.Run(str(tmp_path), config={"lr": 0.1, "model": "lenet"},
                  name="t")
    run.log_metrics(0, loss=1.5, acc=0.2)
    run.log_metrics(1, loss=1.2, acc=0.4)
    with run.capture_stdout():
        print("hello from the run")
    run.close()
    d = tmp_path / str(run.run_id)
    cfg = json.loads((d / "config.json").read_text())
    assert cfg["config"]["lr"] == 0.1 and cfg["name"] == "t"
    lines = (d / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[1])["loss"] == 1.2
    assert "hello from the run" in (d / "log.txt").read_text()
    r2 = mod.Run(str(tmp_path))
    assert r2.run_id == run.run_id + 1
    r2.close()


# --------------------------------------------------------------- profiler


def _row3_args(s=3, m=8, k=16, n=4):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(m, k, generator=g), torch.randn(k, n, generator=g),
            torch.arange(2 * s, dtype=torch.int32).reshape(s, 2))


def _row3(x, w, seeds):
    return mm.dropout_matmul_samples(x, w, seeds, 0.25)


def test_cost_report_counts_row_3():
    """Row 3 at (S, M, K, N) = (3, 8, 16, 4): 2·S·M·N·K operations (the
    plain version's matmuls on the CPU; the kernel's recorded work on a
    card, and no launch here), each argument read once and the output
    written once."""
    x, w, seeds = _row3_args()
    mm.reset_launch_counts()
    rep = profiler.cost_report(_row3, x, w, seeds)
    assert rep["flops"] == 2 * 3 * 8 * 4 * 16
    assert rep["argument_bytes"] == 4 * (8 * 16 + 16 * 4 + 3 * 2)
    assert rep["output_bytes"] == 4 * 3 * 8 * 4
    assert rep["bytes_accessed"] == rep["argument_bytes"] + rep["output_bytes"]
    assert rep["temp_bytes"] >= 0 and rep["transcendentals"] is None
    assert profiler.kernel_work() == 0 and not any(mm.launch_counts.values())


def test_roofline_keys_are_jaxs():
    x, w, seeds = _row3_args()
    want = jprofiler.roofline(lambda a: a @ a, jnp.ones((64, 64)), gen="cpu",
                              seconds=1e-3)
    got = profiler.roofline(_row3, x, w, seeds, gen="cpu", seconds=1e-3)
    assert set(got) - {"note"} == set(want) - {"note"}
    flops, byts = 2 * 3 * 8 * 4 * 16, 4 * (8 * 16 + 16 * 4 + 6 + 96)
    assert got["bound"] == "memory"     # intensity under the cpu row's ridge
    assert got["speed_of_light_s"] == byts / profiler.PEAKS["cpu"]["hbm"]
    assert got["achieved_tflops"] == flops / 1e-3 / 1e12
    assert got["chip"] == "cpu" and got["seconds"] == 1e-3
    assert profiler.measure(_row3, x, w, seeds, iters=2,
                            min_diff_s=0.0) > 0
    assert profiler.chip_generation("cpu") == "cpu"


def test_h100_peaks_and_trace(tmp_path):
    assert profiler.PEAKS["h100"] == {"bf16": 989e12, "int8": 1979e12,
                                      "tf32": 495e12, "f32": 67e12,
                                      "hbm": 3.35e12}
    with profiler.trace(str(tmp_path / "tr")) as d:
        _row3(*_row3_args())
    assert json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiler.chip_generation()


# ---------------------------------------------------------------- interop


def test_torch_layout_helpers_equal_jaxs():
    rng = np.random.default_rng(0)
    conv, lin = rng.normal(size=(6, 3, 3, 2)), rng.normal(size=(5, 24))
    np.testing.assert_array_equal(tti.conv_weight(conv),
                                  jti.conv_weight(conv))
    np.testing.assert_array_equal(tti.linear_weight(lin),
                                  jti.linear_weight(lin))
    np.testing.assert_array_equal(tti.flatten_permutation(6, 2, 2),
                                  jti.flatten_permutation(6, 2, 2))
    np.testing.assert_array_equal(
        tti.linear_weight_after_flatten(lin, 6, 2, 2),
        jti.linear_weight_after_flatten(lin, 6, 2, 2))
    sd = {"bn.weight": 1.0 + lin[0], "bn.bias": lin[1],
          "bn.running_mean": lin[2], "bn.running_var": 1 + lin[3] ** 2}
    _trees_equal(tti.batchnorm_params("bn", sd), jti.batchnorm_params("bn",
                                                                      sd))
    with pytest.raises(ValueError, match="mismatch"):
        tti.check_weight_load(lin, lin + 1)


def _resnet_sd(params, stats, rng):
    """A state dict under the reference's names
    (``resnet18.py``/``ResNet18EarlyExit``) for the shapes of a template."""
    sd = {}

    def convbn(p, s, conv, bn):
        sd[conv + ".weight"] = rng.normal(size=np.shape(
            p["conv"]["kernel"])).transpose(3, 2, 0, 1).astype(np.float32)
        c = np.shape(p["bn"]["scale"])
        sd[bn + ".weight"] = rng.normal(size=c).astype(np.float32)
        sd[bn + ".bias"] = rng.normal(size=c).astype(np.float32)
        sd[bn + ".running_mean"] = rng.normal(size=c).astype(np.float32)
        sd[bn + ".running_var"] = rng.uniform(0.5, 2, size=c).astype(
            np.float32)

    def linear(p, name):
        sd[name + ".weight"] = rng.normal(size=np.shape(
            p["kernel"])[::-1]).astype(np.float32)
        sd[name + ".bias"] = rng.normal(size=np.shape(p["bias"])).astype(
            np.float32)

    convbn(params["stem"], stats["stem"], "conv1", "bn1")
    for name, p in params.items():
        m = re.fullmatch(r"layer(\d)_(\d)", name)
        if m:
            t = f"layer{m[1]}.{m[2]}"
            for i in (1, 2):
                convbn(p[f"convbn{i}"], None, f"{t}.conv{i}", f"{t}.bn{i}")
            if "downsample" in p:
                convbn(p["downsample"], None, f"{t}.downsample.0",
                       f"{t}.downsample.1")
        m = re.fullmatch(r"exit(\d)", name)
        if m:
            for k, q in p.items():
                if k.startswith("convbn"):
                    convbn(q, None, f"ex{m[1]}conv{k[6:]}", f"ex{m[1]}bn{k[6:]}")
            linear(p["linear"], f"ex{m[1]}linear")
    linear(params["linear"], "linear")
    return sd


def test_import_reference_resnet18_equals_jaxs():
    """A narrow multi-exit resnet18 (planes 8, 16, 16, 16): JAX's import
    into JAX's template and the port's into the port's give one tree,
    which the port model loads."""
    planes = (8, 16, 16, 16)
    jm = jget_model("resnet18_me", num_classes=10,
                    bayes=JBayes(kind=JKind.NONE), dropout_exit=False,
                    stage_planes=planes)
    key = jax.random.key(0)
    jt = jax.tree.map(np.asarray, jm.init({"params": key, BAYES_RNG: key},
                                          jnp.zeros((1, 32, 32, 3))))
    model = get_model("resnet18_me", num_classes=10,
                      bayes=BayesConfig(kind=DropoutKind.NONE),
                      dropout_exit=False, stage_planes=planes)
    sd = _resnet_sd(jt["params"], jt["batch_stats"],
                    np.random.default_rng(1))
    want = jti.import_reference_resnet18(sd, jt)
    got = tti.import_reference_resnet18(sd, to_flax_variables(model))
    _trees_equal(got, want)
    load_flax_variables(model, got)
    np.testing.assert_array_equal(
        got["params"]["layer2_0"]["convbn1"]["conv"]["kernel"],
        np.transpose(sd["layer2.0.conv1.weight"], (2, 3, 1, 0)))


def test_import_reference_vgg19_equals_jaxs():
    """``vgg19_me`` at full width (its config has no width knob), one
    template for both functions; the backbone convs carry a bias, folded
    into the BN mean."""
    model = get_model("vgg19_me", num_classes=10,
                      bayes=BayesConfig(kind=DropoutKind.NONE),
                      dropout_exit=False)
    tmpl = to_flax_variables(model)
    p, rng, sd = tmpl["params"], np.random.default_rng(2), {}
    for b in (k for k in p if k.startswith("block")):
        for j, k in enumerate(sorted(q for q in p[b] if
                                     q.startswith("convbn"))):
            kern = p[b][k]["conv"]["kernel"]
            c = kern.shape[-1]
            base = f"blocks.{b[5:]}"
            sd[f"{base}.{3 * j}.weight"] = rng.normal(
                size=kern.shape).transpose(3, 2, 0, 1).astype(np.float32)
            sd[f"{base}.{3 * j}.bias"] = rng.normal(size=c).astype(np.float32)
            for n, v in (("weight", 1.0), ("bias", 0.0),
                         ("running_mean", 0.0), ("running_var", 1.0)):
                sd[f"{base}.{3 * j + 1}.{n}"] = (
                    v + 0.1 * rng.normal(size=c)).astype(np.float32)
    for e in (k for k in p if k.startswith("exit")):
        for j in range(sum(q.startswith("convbn") for q in p[e])):
            kern = p[e][f"convbn{j + 1}"]["conv"]["kernel"]
            c = kern.shape[-1]
            fe = f"ex{e[4:]}featureextractor"
            sd[f"{fe}.{3 * j}.weight"] = rng.normal(
                size=kern.shape).transpose(3, 2, 0, 1).astype(np.float32)
            for n in ("weight", "bias", "running_mean"):
                sd[f"{fe}.{3 * j + 1}.{n}"] = rng.normal(size=c).astype(
                    np.float32)
            sd[f"{fe}.{3 * j + 1}.running_var"] = np.ones(c, np.float32)
        k = p[e]["linear"]["kernel"]
        sd[f"ex{e[4:]}linear.0.weight"] = rng.normal(size=k.shape[::-1])
        sd[f"ex{e[4:]}linear.0.bias"] = rng.normal(size=k.shape[1])
    k = p["classifier"]["kernel"]
    sd["classifier.0.weight"] = rng.normal(size=k.shape[::-1])
    sd["classifier.0.bias"] = rng.normal(size=k.shape[1])
    want = jti.import_reference_vgg19(sd, tmpl)
    got = tti.import_reference_vgg19(sd, tmpl)
    _trees_equal(got, want)
    load_flax_variables(model, got)


def _write_keras_h5(path, model_vars, rng):
    """The lenet's weights in Keras's HDF5 layout:
    ``model_weights/<layer>/<layer>/<name>:0``."""
    import h5py
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        for layer, ws in model_vars["params"].items():
            sub = g.create_group(layer).create_group(layer)
            for name, v in ws.items():
                sub.create_dataset(f"{name}:0", data=rng.normal(
                    size=np.shape(v)).astype(np.float32))
        g.create_group("activation").create_group("activation")


def test_keras_import_equals_jaxs(tmp_path):
    model = get_model("lenet", bayes=BayesConfig(kind=DropoutKind.NONE))
    tmpl = to_flax_variables(model)
    path = str(tmp_path / "lenet.h5")
    _write_keras_h5(path, tmpl, np.random.default_rng(3))
    w_port, w_jax = tkeras.read_h5_weights(path), jkeras.read_h5_weights(path)
    _trees_equal(w_port, w_jax)
    assert set(w_port) == {"conv2d_1", "conv2d_2", "fc_1", "fc_2"}
    got = tkeras.assign_by_name(tmpl, w_port)
    _trees_equal(got, jkeras.assign_by_name(tmpl, w_jax))
    load_flax_variables(model, got)
    w_port["fc_2"]["kernel"] = w_port["fc_2"]["kernel"][:, :5]
    with pytest.raises(ValueError, match="shape mismatch"):
        tkeras.assign_by_name(tmpl, w_port)


# ------------------------------------------------------ the names of 14h


def test_split_apply_equals_jaxs():
    """The backbone runs once and the head once a sample, index i on
    sample i; the head here ignores its key or seeds, which differ."""
    x = np.random.default_rng(4).normal(size=(3, 4, 4, 2)).astype(
        np.float32)
    calls = []

    def backbone(a):
        calls.append(1)
        return a * 2

    want = jsplit_apply(lambda a: a * 2, lambda h, k, i: h + i,
                        jnp.asarray(x), jax.random.key(0), 5)
    got = split_apply(backbone, lambda h, s, i: h + i, torch.from_numpy(x),
                      0, 5, num_sites=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(calls) == 1
    seen = []
    split_apply(lambda a: a, lambda h, s, i: seen.append(s) or h,
                torch.from_numpy(x), 7, 3, num_sites=2)
    assert [tuple(s.shape) for s in seen] == [(2, 2)] * 3
    assert not torch.equal(seen[0], seen[1])


def test_global_avg_pool_equals_jaxs():
    x = np.random.default_rng(5).normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(global_avg_pool(torch.from_numpy(x)).numpy(),
                               np.asarray(jgap(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


def test_native_available_reports(monkeypatch, tmp_path):
    """True where the library builds (g++ is here); False, with nothing
    loaded, where its build fails."""
    assert native.available() is True
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    assert native.available() is False
    assert native._lib is None
