"""The port's spans and counters (``bayestpu_torch.utils.profiler``) and the
benchmark's readers of them, on the CPU.

Spans record only under an active ``torch.profiler``; the served predict
(``engine.*``), the int8 quantization (``quant.*``) and the training step
(``train.*``) hold them. On the CPU a device span has no events, so
``device_ms`` is None; the graph-captured spans (``GraphSpans``) are
checked here with stand-in events, and on the card by the benchmark's
traced runs.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import profile

from bayestpu_torch.core.config import BayesConfig, QuantConfig
from bayestpu_torch.core.rng import step_seeds
from bayestpu_torch.engine.engine import BayesEngine, _has_device_spans
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train import optim
from bayestpu_torch.train.loop import TrainState, make_train_step
from bayestpu_torch.utils import profiler
from bayestpu_torch.utils.profiler import SpanRecord

from port_threads import thread_budget  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BAYES = BayesConfig(rate=0.25)
# every conv but the entry one on the int8 route, so im2col runs
INT8_ALL = QuantConfig(8, 0, int8_infer=True, int8_conv_min_ch=0)


@pytest.fixture(autouse=True)
def fresh_log():
    profiler.reset_spans()
    yield
    profiler.reset_spans()


def _x(batch=3):
    return np.random.default_rng(0).normal(size=(batch, 28, 28, 1)).astype(
        np.float32)


def _engine(quant=None):
    model = get_model("lenet_me", bayes=BAYES, quant=quant)
    return BayesEngine(model, device="cpu").init(0, _x())


def _by_name(log):
    out = {}
    for r in log:
        out.setdefault(r.name, []).append(r)
    return out


def test_span_off_is_the_shared_noop_and_records_nothing():
    for device in (False, True):
        sp = profiler.span("engine.predict", device)
        assert sp is profiler.NO_SPAN
        with sp as inner:
            inner.stop_clock()
    _engine().predict(_x(), seed=1, num_samples=2)
    assert profiler.span_log() == []
    # counters count whether or not spans record
    assert profiler.counters() == {"engine.eager_predicts": 1}


def test_eager_predict_spans_in_trace_and_log(tmp_path):
    eng = _engine()
    x = _x()
    want = eng.predict(x, seed=1, num_samples=4)
    before = profiler.counters().get("engine.eager_predicts", 0)
    with profiler.trace(str(tmp_path)):
        assert profiler.span("s") is not profiler.NO_SPAN
        got = eng.predict(x, seed=1, num_samples=4)
    assert torch.equal(got.probs, want.probs)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("ph") == "X" and e["name"].startswith("engine.")}
    assert set(spans) == {"engine.predict", "engine.seeds"}
    root, seeds = spans["engine.predict"], spans["engine.seeds"]
    assert root["ts"] <= seeds["ts"]
    assert seeds["ts"] + seeds["dur"] <= root["ts"] + root["dur"]
    log = _by_name(profiler.span_log())
    (r,), (s,) = log["engine.predict"], log["engine.seeds"]
    assert r.parent is None and r.root == r.id
    assert s.parent == r.id and s.root == r.id
    assert r.device_ms is None and s.device_ms is None
    assert 0 < s.host_ms <= r.host_ms
    assert r.start_ns <= s.start_ns and s.end_ns <= r.end_ns
    c = profiler.counters()
    assert c["engine.eager_predicts"] == before + 1
    assert "engine.graph_replays" not in c


def test_int8_forward_records_the_quantization_spans():
    eng = _engine(INT8_ALL)
    x = _x()
    want = eng.predict(x, seed=2, num_samples=3)
    with profile():
        got = eng.predict(x, seed=2, num_samples=3)
    for a, b in zip(want[:3], got[:3]):
        assert torch.equal(a, b)
    log = profiler.span_log()
    names = _by_name(log)
    assert {"quant.weights", "quant.inputs", "quant.im2col"} <= set(names)
    (root,) = names["engine.predict"]
    for name in ("quant.weights", "quant.inputs", "quant.im2col"):
        for r in names[name]:
            assert r.root == root.id and r.device_ms is None
            assert r.host_ms >= 0


def test_train_step_records_its_phases_under_one_root():
    torch.manual_seed(0)
    model = get_model("lenet_me", bayes=BAYES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train()
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(
        optim.cosine_decay_schedule(0.01, 10), 0.9))
    state = TrainState(model, tx.init(dict(model.named_parameters())))
    step = make_train_step(model, tx)
    x = torch.from_numpy(_x(4))
    y = torch.tensor([0, 1, 2, 3])
    seeds = step_seeds(0, [0, 1], model.num_sites)
    step(state, x, y, seeds[0])
    assert profiler.span_log() == []
    with profile():
        step(state, x, y, seeds[1])
    names = _by_name(profiler.span_log())
    assert set(names) == {"train.step", "train.forward", "train.backward",
                          "train.update"}
    (root,) = names["train.step"]
    assert root.parent is None
    phases = [names[n][0] for n in ("train.forward", "train.backward",
                                    "train.update")]
    for p in phases:
        assert p.parent == root.id and p.root == root.id
        assert p.device_ms is None
    assert [p.start_ns for p in phases] == sorted(p.start_ns for p in phases)
    assert sum(p.host_ms for p in phases) <= root.host_ms
    assert state.step == 2


class _Ev:
    """A stand-in CUDA event: its time in ms."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_graph_spans_give_one_record_a_captured_span_a_replay():
    """Captured spans (inner exits first) keep their nesting; a span with
    no captured parent hangs under the span open at the replay, and every
    record takes that replay's root."""
    spans = profiler.GraphSpans()
    outer = SimpleNamespace(name="quant.inputs", id=10, parent=1,
                            start=_Ev(0.0), stop=_Ev(3.0))
    inner = SimpleNamespace(name="quant.im2col", id=11, parent=10,
                            start=_Ev(1.0), stop=_Ev(1.5))
    spans.spans += [inner, outer]
    for up_id, root in ((100, 99), (200, 199)):
        spans.settle()          # before the replay
        spans.replayed(SimpleNamespace(id=up_id, root=root))
    log = profiler.span_log()
    assert len(log) == 4
    for rec_root, up_id in ((99, 100), (199, 200)):
        recs = {r.name: r for r in log if r.root == rec_root}
        assert recs["quant.inputs"].parent == up_id
        assert recs["quant.im2col"].parent == recs["quant.inputs"].id
        assert recs["quant.inputs"].device_ms == 3.0
        assert recs["quant.im2col"].device_ms == 0.5
        assert recs["quant.inputs"].host_ms is None
    profiler.reset_spans()
    assert profiler.span_log() == []


def test_only_quantized_models_get_a_timed_twin():
    assert _has_device_spans(get_model("lenet_me", bayes=BAYES,
                                       quant=INT8_ALL))
    assert not _has_device_spans(get_model("lenet_me", bayes=BAYES))


def test_log_is_bounded():
    with profile():
        for _ in range(profiler.LOG_SPANS + 5):
            with profiler.span("s"):
                pass
    log = profiler.span_log()
    assert len(log) == profiler.LOG_SPANS
    assert log[0].id < log[-1].id


# ------------------------------------------------------------- readers

# reader → (root, span, clock)
READERS = {
    "engine_seeds_ms.predict": ("engine.predict", "engine.seeds", "host"),
    "engine_launch_ms.predict": ("engine.predict", "engine.launch", "host"),
    "engine_outputs_ms.predict": ("engine.predict", "engine.outputs",
                                  "host"),
    "engine_wait_ms.predict": ("engine.predict", "engine.predict", "device"),
    "quant_weights_ms.predict": ("engine.predict", "quant.weights",
                                 "device"),
    "quant_inputs_ms.predict": ("engine.predict", "quant.inputs", "device"),
    "quant_im2col_ms.predict": ("engine.predict", "quant.im2col", "device"),
    "stem_ms.predict": ("engine.predict", "resnet.stem", "device"),
    "site_convs_ms.predict": ("engine.predict", "sites.conv", "device"),
    "site_window_ms.predict": ("engine.predict", "sites.window_conv",
                               "device"),
    "train_forward_ms.train": ("train.step", "train.forward", "device"),
    "train_backward_ms.train": ("train.step", "train.backward", "device"),
    "train_update_ms.train": ("train.step", "train.update", "device"),
}


def _reader(name):
    from perfbench import harness
    return harness.reader(ROOT, name)


def _synthetic_log(root, name, clock):
    """Three roots of ``root``: a warm one, then two traced units whose
    ``name`` spans take 1 + 2 and 5 ms (the root itself: 3 and 5 ms)."""
    log, ids = [], iter(range(1, 1000))

    def rec(nm, parent, rt, ms):
        i = next(ids)
        host = clock == "host"
        return SpanRecord(nm, i, parent, rt if rt else i,
                          0 if host else None,
                          int(ms * 1e6) if host else None,
                          None if host else ms)

    for unit_ms in ([40.0], [1.0, 2.0], [5.0]):
        if name == root:
            log.append(rec(root, None, None, sum(unit_ms)))
            continue
        r = rec(root, None, None, 100.0)
        log.append(r)
        log.append(rec("other.span", r.id, r.id, 7.0))
        log += [rec(name, r.id, r.id, ms) for ms in unit_ms]
    return log


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_a_mean_per_traced_unit(metric, monkeypatch):
    root, name, clock = READERS[metric]
    read = _reader(metric)
    kind = "train" if root == "train.step" else "predict"
    traced = SimpleNamespace(record=SimpleNamespace(
        kind=kind, trace=SimpleNamespace(units=2)))
    untraced = SimpleNamespace(record=SimpleNamespace(kind=kind, trace=None))
    monkeypatch.setattr(profiler, "span_log",
                        lambda: _synthetic_log(root, name, clock))
    assert read(untraced) is None
    assert read(traced) == pytest.approx(4.0)
    monkeypatch.setattr(profiler, "span_log", lambda: [])
    assert read(traced) is None
    # a program without spans gives nothing to read
    monkeypatch.delattr(profiler, "span_log")
    assert read(traced) is None


def test_a_graph_without_captured_spans_adds_nothing():
    spans = profiler.GraphSpans()
    spans.replayed(SimpleNamespace(id=1, root=1))
    spans.settle()
    assert profiler.span_log() == []


def test_device_events_leave_out_the_spans_device_ranges():
    """A recorded span's ``record_function`` lands on the card as a device
    range over the gaps between its kernels too; ``device_events`` keeps
    the kernels, copies and memsets alone, and no CPU row."""
    def row(key, device, annotation):
        return SimpleNamespace(key=key, device_type=f"DeviceType.{device}",
                               is_user_annotation=annotation)

    rows = [row("engine.predict", "CPU", True),
            row("engine.predict", "CUDA", True),
            row("conv_mma_kernel", "CUDA", False),
            row("Memcpy HtoD", "CUDA", False), row("aten::mul", "CPU", False)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert [e.key for e in profiler.device_events(prof)] == [
        "conv_mma_kernel", "Memcpy HtoD"]
    with profile() as prof:
        with profiler.span("quant.inputs"):
            torch.ones(4).mul(2)
    assert profiler.device_events(prof) == []
