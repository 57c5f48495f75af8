"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the harness's look for a
card skipped) at a small batch and the cell's widths, in f32 so that the
sound run agrees with the reference to rounding, with one fault planted
in the program: an answer altered where it is produced, half of the
samples or of the batch left out with the mean taken over the rest, a
training step that returns its state unchanged."""

import time

import pytest
import torch

from conftest import SMALL, copy_root
from perfbench import harness


def run(tmp_path, cell_name, seconds=0.3):
    copy_root(tmp_path, SMALL, {"dtype": "float32"})
    cell = harness.load_cell(tmp_path, cell_name)
    return harness.run(cell, 2 ** 31 + 21, seconds, False,
                       torch.device("cpu"), time.perf_counter())


def altered_answer(monkeypatch):
    from bayestpu_torch.engine import sampler

    real = sampler.predictive

    def predictive(*a, **k):
        p = real(*a, **k)
        probs = p.probs.clone()
        probs[0, 0, 0] += 0.1
        return p._replace(probs=probs)

    monkeypatch.setattr(sampler, "predictive", predictive)


def half_the_samples(monkeypatch):
    from bayestpu_torch.engine import sampler

    real = sampler.predictive
    monkeypatch.setattr(sampler, "predictive", lambda model, x, seeds, *a:
                        real(model, x, seeds[:seeds.shape[0] // 2], *a))


def unchanged_state(monkeypatch):
    from bayestpu_torch.train import loop

    real = loop.make_train_step

    def make(model, tx, *a, **k):
        step = real(model, tx, *a, **k)

        def frozen(state, x, y, seeds, lr_scale=1.0):
            saved = ({n: p.detach().clone()
                      for n, p in model.named_parameters()},
                     state.opt_state, state.step)
            m = step(state, x, y, seeds, lr_scale)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(saved[0][n])
            state.opt_state = saved[1]
            state.step = saved[2] + 1
            return m

        return frozen

    monkeypatch.setattr(loop, "make_train_step", make)


def half_the_batch(monkeypatch):
    from bayestpu_torch.train import loop

    real = loop.make_train_step

    def make(model, tx, *a, **k):
        step = real(model, tx, *a, **k)
        return lambda state, x, y, seeds, lr_scale=1.0: step(
            state, x[:x.shape[0] // 2], y[:y.shape[0] // 2], seeds, lr_scale)

    monkeypatch.setattr(loop, "make_train_step", make)


PREDICT = ["vgg11_me_bf16.predict_b128", "resnet18_me_int8.predict_b128"]
TRAIN = ["vgg11_me_bf16.train_b4096"]


@pytest.mark.parametrize("cell", PREDICT + TRAIN)
def test_sound_run_is_correct(tmp_path, cell):
    line = run(tmp_path, cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [altered_answer, half_the_samples])
@pytest.mark.parametrize("cell", PREDICT)
def test_predict_fault_is_caught(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run(tmp_path, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_caught(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run(tmp_path, cell)
    assert not line["correct"], line["checks"]
