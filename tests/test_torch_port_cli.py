"""The port's CLIs (``bayestpu_torch/cli/``) end to end on the CPU
(``--device cpu``, synthetic MNIST), with the JAX CLIs' flags and keys.

One module fixture trains ``lenet_me`` for one epoch with the arguments of
the JAX package's ``tests/test_cli.py``; ``predict``, ``analyze``,
``build``, ``sweep``, ``time_cost``, ``figures`` and ``verify_accuracy``
then run, ``build`` with ``--mem_limit 1`` degrading to the temporal
mapping, and ``--resume`` continues from ``<out>_last``. The MC numbers
are held against the port's own library calls on the same weights and
seeds. Against the JAX CLIs, where that is cheap: every CLI's flags (its
``--help``: the JAX flags plus ``--device``), ``common``'s defaults and
choices, and ``figures`` drawn by both from one sweep JSON.
"""

import argparse
import json
import os
import re
from pathlib import Path

import pytest
import torch

from bayestpu.cli import common as jcommon
from bayestpu.cli import figures as jfigures
from bayestpu_torch.cli import (analyze, build, common, figures, predict,
                                sweep, time_cost, train, verify_accuracy)
from bayestpu_torch.core.config import EngineConfig, SamplingMode
from bayestpu_torch.data.datasets import get_dataset
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.train.checkpoint import restore_variables

CLIS = ["train", "predict", "analyze", "build", "sweep", "figures",
        "time_cost", "verify_accuracy"]
ARGS = ["--model", "lenet_me", "--dataset", "mnist", "--dropout_type", "mc",
        "--mc_samples", "3", "--data_dir", "/nonexistent", "--device", "cpu"]
REPO = Path(__file__).resolve().parents[1]
EVAL_KEYS = {"acc", "nll", "mse", "ece_hist", "ece_ew10", "aPE", "aPE_ood"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module, restored after it: the suite
    runs several test processes on the box's cores, and these small
    training steps slow down by two orders of magnitude when their
    threads compete for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run") / "ckpt")
    res = train.main(ARGS + ["--epochs", "1", "--batch_size", "64",
                             "--out", out])
    return out, res


def _engine(out, mode=SamplingMode.SPATIAL):
    """The port's engine on the checkpoint's weights, as the CLIs build
    it."""
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    a = p.parse_args(ARGS)
    return BayesEngine(common.build_model(a), common.bayes_from_args(a),
                       EngineConfig(mode=mode),
                       device="cpu").attach(restore_variables(out))


def _jax_flags(name):
    """The flags a JAX CLI declares, read from its source (importing the
    JAX CLIs costs seconds): its own ``add_argument`` calls and, where it
    calls ``common.add_model_args``, common's."""
    def declared(path):
        return set(re.findall(r'add_argument\(\s*"(--\w+)"',
                              (REPO / path).read_text()))
    src = f"bayestpu/cli/{name}.py"
    flags = declared(src) | {"--help"}
    if "common.add_model_args" in (REPO / src).read_text():
        flags |= declared("bayestpu/cli/common.py")
    return flags


@pytest.mark.parametrize("name", CLIS)
def test_flags_are_jaxs_plus_device(name, capsys):
    """Each port CLI's ``--help`` lists the JAX CLI's flags and
    ``--device`` (``figures`` runs no model and has none)."""
    import importlib
    with pytest.raises(SystemExit):
        importlib.import_module(f"bayestpu_torch.cli.{name}").main(
            ["--help"])
    got = set(re.findall(r"^  (?:-\w, )?(--\w+)", capsys.readouterr().out,
                         re.M))
    extra = set() if name == "figures" else {"--device"}
    assert got == _jax_flags(name) | extra


def test_common_defaults_and_choices_are_jaxs():
    def actions(mod):
        p = argparse.ArgumentParser()
        mod.add_model_args(p)
        return {a.dest: (a.default, a.choices, a.type, a.nargs)
                for a in p._actions if a.dest not in ("help", "device")}

    assert actions(common) == actions(jcommon)
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    assert p.parse_args([]).device == "cuda"
    a = p.parse_args(["--model", "vgg11_me", "--dataset", "cifar10",
                      "--dropout_type", "mask", "--scale", "3"])
    assert common.run_suffix(a) == "me_mask_scale3"


def test_train_cli(trained):
    out, res = trained
    assert set(res) == {"checkpoint", "synthetic"} | EVAL_KEYS
    assert res["synthetic"] is True and os.path.isdir(res["checkpoint"])
    assert os.path.isdir(out + "_last")
    assert os.path.isfile(out + "_loss_curve.png")
    ds = get_dataset("mnist", "/nonexistent")
    want = _engine(out).evaluate(ds.x_test[:1000], ds.y_test[:1000],
                                 ood_check=True, dataset="mnist")
    assert {k: res[k] for k in want} == want


def test_predict_cli(trained, tmp_path):
    out, _ = trained
    res = predict.main(ARGS + ["--load_model", out, "--eval_images", "64"])
    ds = get_dataset("mnist", "/nonexistent")
    for mode in (SamplingMode.TEMPORAL, SamplingMode.SPATIAL):
        want = _engine(out, mode).evaluate(ds.x_test[:64], ds.y_test[:64],
                                           ood_check=True)
        assert res[mode.value] == want
    log = str(tmp_path / "log_0.txt")
    rep = predict.main(ARGS + ["--load_model", out, "--eval_images", "32",
                               "--passes", "2", "--log", log])
    assert rep["spatial"]["passes"] == 2 and "acc_std" in rep["spatial"]
    assert os.path.exists(log + ".spatial") and os.path.exists(
        log + ".temporal")


def test_analyze_cli(trained, tmp_path):
    out, _ = trained
    res = analyze.main(ARGS + ["--load_model", out, "--eval_images", "64",
                               "--out", str(tmp_path / "an")])
    assert os.path.exists(res["log"])
    assert os.path.exists(res["validation_npy"])
    assert res["early_exit"]


def test_build_cli_degrades_under_mem_limit(trained, tmp_path):
    out, _ = trained
    rep = build.main(ARGS + ["--load_model", out, "--batch", "16",
                             "--mem_limit", "1",
                             "--output_dir", str(tmp_path / "b")])
    assert rep["degraded_to_resource"] is True
    assert rep["strategy_mode"] == "temporal" and rep["mode"] == "temporal"
    assert rep["latency_build_temp_bytes"] > 1
    assert rep["flops"] > 0 and rep["mem_limit"] == 1
    assert rep["requested_strategy"] == "latency"
    assert set(rep["kernel_mapping"]) == {
        "masked_conv_fused_min_in_ch", "int8_conv_min_ch", "int8_det_pallas",
        "entry_block_batch_chunk"}
    eng = _engine(out)
    want = ({"strategy_mode", "degraded_to_resource", "mem_limit",
             "requested_strategy", "kernel_mapping",
             "latency_build_temp_bytes"}
            | set(eng.compile(get_dataset("mnist", "/nonexistent")
                              .x_test[:16]))
            | set(eng.cost_analysis(get_dataset("mnist", "/nonexistent")
                                    .x_test[:16])))
    assert set(rep) == want
    with open(tmp_path / "b" / "build_report.json") as f:
        assert json.load(f)["degraded_to_resource"] is True
    plain = build.main(ARGS + ["--load_model", out, "--batch", "16",
                               "--output_dir", str(tmp_path / "c")])
    assert plain["strategy_mode"] == "spatial"
    assert plain["degraded_to_resource"] is False


def test_sweep_and_figures_cli(tmp_path):
    res = sweep.main(["dropouts", "--max_n", "2", "--mc_samples", "2",
                      "--out", str(tmp_path), "--device", "cpu"])
    assert res["device"] == "cpu" and len(res["rows"]) == 2
    for i, row in enumerate(res["rows"]):
        assert set(row) == {"n_bayes_layers", "compile_s", "latency_ms",
                            "samples_per_s", "flops", "bytes_accessed",
                            "code_bytes"}
        assert row["n_bayes_layers"] == i + 1
        assert row["latency_ms"] > 0 and row["samples_per_s"] > 0
        assert row["flops"] > 0 and row["code_bytes"] is None
    path = str(tmp_path / "dropouts.json")
    with open(path) as f:
        assert json.load(f)["rows"] == res["rows"]
    got = figures.main([path, "--out", str(tmp_path / "port")])
    want = jfigures.main([path, "--out", str(tmp_path / "jax")])
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == ["dropouts_sweep.png"]
    assert all(os.path.getsize(p) > 0 for p in got)
    curve = figures.loss_curve([1.0, 0.5], [0.2, 0.4],
                               str(tmp_path / "l.png"))
    assert os.path.exists(curve)


def test_time_cost_cli(tmp_path):
    res = time_cost.main(["lenet", "--loops", "2", "--out_dir",
                          str(tmp_path), "--device", "cpu"])
    assert set(res) == {"net", "convert_s", "compile_s", "file"}
    assert res["convert_s"] >= 0 and res["compile_s"] > 0
    with open(tmp_path / "lenet.txt") as f:
        assert f.read().startswith("Conversion time of lenet: ")


def _tiny_mnist(root, n_train=640, n_test=128):
    """The first images of the synthetic MNIST in MNIST's own idx files,
    so that a CLI trains on ``n_train`` of them."""
    import struct

    import numpy as np
    ds = get_dataset("mnist", "/nonexistent")

    def write(name, a):
        a = np.asarray(a, np.uint8)
        with open(os.path.join(root, name), "wb") as f:
            f.write(struct.pack(">I", 0x0800 | a.ndim))
            f.write(struct.pack(f">{a.ndim}I", *a.shape))
            f.write(a.tobytes())

    write("train-images-idx3-ubyte", ds.x_train[:n_train, ..., 0] * 255)
    write("train-labels-idx1-ubyte", ds.y_train[:n_train])
    write("t10k-images-idx3-ubyte", ds.x_test[:n_test, ..., 0] * 255)
    write("t10k-labels-idx1-ubyte", ds.y_test[:n_test])
    return str(root)


def test_verify_accuracy_cli(tmp_path):
    """On 640 training images written as MNIST's idx files (10 steps)."""
    res = verify_accuracy.main(["--epochs", "1", "--eval_images", "64",
                                "--data_dir", _tiny_mnist(tmp_path),
                                "--device", "cpu"])
    assert res["pass"] is True and len(res["per_mask"]) == 4
    assert set(res["per_mask"][0]) == {"mask_index", "acc_golden",
                                       "acc_fused", "max_abs_diff"}
    assert set(res["averaged"]) == {"acc_golden", "acc_fused",
                                    "max_abs_diff"}


def test_train_cli_resumes(tmp_path, capsys, monkeypatch):
    """A run of one epoch on 640 images (MNIST's idx files), then
    ``--resume`` to two: it continues from ``<out>_last`` at epoch 1; here
    without matplotlib (as on the chip machine), so the second run says it
    draws no loss curve."""
    import importlib.util
    from bayestpu_torch.train.checkpoint import _read
    tiny = (tmp_path / "data").mkdir() or _tiny_mnist(tmp_path / "data")
    args = list(ARGS)
    args[args.index("--data_dir") + 1] = tiny
    out = str(tmp_path / "ckpt")
    train.main(args + ["--epochs", "1", "--batch_size", "64", "--out", out])
    one = _read(out)["step"]
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    capsys.readouterr()
    os.remove(out + "_loss_curve.png")
    res = train.main(args + ["--epochs", "2", "--batch_size", "64",
                             "--out", out, "--resume"])
    printed = capsys.readouterr().out
    assert f"resumed from {out}_last: step {one} (epoch 1)" in printed
    assert "no loss curve: matplotlib is not installed" in printed
    assert not os.path.exists(out + "_loss_curve.png")
    assert _read(out)["step"] == 2 * one
    assert _read(out + "_last")["aux"]["epoch"] == 1
    assert set(res) == {"checkpoint", "synthetic"} | EVAL_KEYS
    assert res["synthetic"] is False
    with pytest.raises(FileNotFoundError, match="resume"):
        train.main(args + ["--epochs", "1", "--out", str(tmp_path / "none"),
                           "--resume"])


def test_the_card_is_the_default_and_is_not_replaced(trained, tmp_path):
    """Without ``--device`` the CLIs and bench twins ask for the card and
    raise where there is none; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    from bayestpu_torch.bench import kernels, scaling
    out, _ = trained
    card = [a for a in ARGS if a not in ("--device", "cpu")]
    calls = [
        lambda: train.main(card + ["--epochs", "1", "--out",
                                   str(tmp_path / "t")]),
        lambda: predict.main(card + ["--load_model", out]),
        lambda: build.main(card + ["--load_model", out, "--output_dir",
                                   str(tmp_path / "b")]),
        lambda: sweep.main(["dropouts", "--max_n", "1", "--out",
                            str(tmp_path / "s")]),
        lambda: time_cost.main(["--loops", "1", "--out_dir",
                                str(tmp_path / "c")]),
        lambda: kernels.bench_shape(8, 16, 4),
        lambda: scaling.main(["--ranks", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
