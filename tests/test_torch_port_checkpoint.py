"""Checkpoints and resumable training (``bayestpu_torch/train/checkpoint.py``,
``train_loop(checkpoint_dir=, start_epoch=, best0=)``) on the CPU.

A ``lenet_me`` run (the ``"lenet"`` recipe: Adam, 16 synthetic MNIST
images a batch, 4 batches an epoch) is stopped after two of three epochs,
restored into a model of another init with ``restore_checkpoint(
with_aux=True)`` and continued: its parameters, buffers, optimizer state
and step are bit-identical to an uninterrupted run's, with validation and
early stopping, with ``reshuffle`` and with ``augment_fn``. A 2-rank gloo
world (this file run as a script, ``python test_torch_port_checkpoint.py
RANK DIR``, a ``file://`` rendezvous, every wait bounded by TIMEOUT_S)
trains data-parallel with a checkpoint every epoch: only the first rank
writes.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

TIMEOUT_S = 120
REPO = Path(__file__).resolve().parents[1]


def _setup(seed=0, n_train=64):
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.data.datasets import get_dataset
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train.loop import create_state
    from bayestpu_torch.train.optim import get_optimizer, get_recipe
    ds = get_dataset("mnist", data_dir="/nonexistent", n_synth_train=n_train,
                     n_synth_test=32)
    model = get_model("lenet_me", bayes=BayesConfig(rate=0.25), fused=True)
    tx = get_optimizer(get_recipe("lenet"), 4)
    return model, tx, create_state(model, tx, seed, ds.x_train[:16],
                                   device="cpu"), ds


def _batches(ds, bsz=16):
    from bayestpu_torch.data.datasets import iterate_batches
    return lambda: iterate_batches(ds.x_train, ds.y_train, bsz, seed=1)


def _worker(rank: int, workdir: str) -> None:
    """One rank of the 2-rank world: 2 epochs data-parallel with a
    checkpoint each epoch; every call of ``save_checkpoint`` appends the
    rank to ``writers``."""
    from bayestpu_torch.engine import distributed, sharding
    from bayestpu_torch.train import checkpoint
    from bayestpu_torch.train.loop import train_loop
    torch.set_num_threads(1)
    save = checkpoint.save_checkpoint

    def recording(*args, **kw):
        with open(os.path.join(workdir, "writers"), "a") as f:
            f.write(f"{rank}\n")
        return save(*args, **kw)

    checkpoint.save_checkpoint = recording
    distributed.initialize(f"file://{workdir}/rendezvous", 2, rank, "gloo")
    model, tx, state, ds = _setup(seed=rank, n_train=32)
    train_loop(model, state, tx, _batches(ds), 5, 2,
               mesh=sharding.make_mesh(2, 1),
               checkpoint_dir=os.path.join(workdir, "ck"),
               log_fn=lambda m: None)
    torch.save({k: p.detach() for k, p in model.named_parameters()},
               os.path.join(workdir, f"params{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
    sys.exit(0)


import pytest  # noqa: E402

from bayestpu_torch.data.augment import random_crop_flip  # noqa: E402
from bayestpu_torch.data.datasets import iterate_batches  # noqa: E402
from bayestpu_torch.engine.engine import BayesEngine  # noqa: E402
from bayestpu_torch.train.checkpoint import (FILE, load_best,  # noqa: E402
                                             restore_checkpoint,
                                             restore_variables, save_best,
                                             save_checkpoint)
from bayestpu_torch.train.loop import train_loop  # noqa: E402

from port_threads import thread_budget  # noqa: E402,F401


def _assert_same(a, b, path="opt_state"):
    """Two nests of dicts, tuples, lists, tensors and numbers equal bit for
    bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


CASES = {
    "validation": dict(val=True, patience=2, val_mode="eed"),
    "reshuffle": dict(reshuffle=True),
    "augment": dict(val=True, reshuffle=True,
                    augment_fn=lambda s, x, i: random_crop_flip(s, x, 4, i)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resumed_run_is_bit_identical(case, tmp_path):
    kw = dict(CASES[case])
    val = kw.pop("val", False)

    def run(model, state, tx, ds, epochs, **more):
        vb = ((lambda: iterate_batches(ds.x_test, ds.y_test, 16,
                                       shuffle=False)) if val else None)
        hist = {}
        train_loop(model, state, tx, _batches(ds), 7, epochs, val_batches=vb,
                   history=hist, log_fn=lambda m: None, **kw, **more)
        return hist

    model, tx, state, ds = _setup()
    whole = run(model, state, tx, ds, 3, checkpoint_dir=str(tmp_path / "a"))
    # stopped after two epochs, restored into another init, continued
    m1, tx1, s1, _ = _setup()
    run(m1, s1, tx1, ds, 2, checkpoint_dir=str(tmp_path / "b"))
    m2, tx2, template, _ = _setup(seed=3)
    s2, seed, aux = restore_checkpoint(str(tmp_path / "b"), template,
                                       with_aux=True)
    assert seed == 7 and aux["epoch"] == 1 and s2.step == 8
    rest = run(m2, s2, tx2, ds, 3, start_epoch=aux["epoch"] + 1,
               best0=(aux["best_metric"], aux["best_params"],
                      aux["since_best"]),
               checkpoint_dir=str(tmp_path / "c"))
    assert rest["train_loss"] == whole["train_loss"][2:]
    assert s2.step == state.step == 12
    for (k, p), q in zip(model.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), k
    for (k, b), c in zip(model.named_buffers(), m2.buffers()):
        assert torch.equal(b, c), k
    _assert_same(state.opt_state, s2.opt_state)
    # the two runs' last checkpoints hold the same state
    a, _, aux_a = restore_checkpoint(str(tmp_path / "a"), _setup()[2],
                                     with_aux=True)
    c, _, aux_c = restore_checkpoint(str(tmp_path / "c"), _setup()[2],
                                     with_aux=True)
    _assert_same(a.opt_state, c.opt_state)
    assert aux_a["epoch"] == aux_c["epoch"] == 2
    assert aux_a["best_metric"] == aux_c["best_metric"]
    _assert_same(aux_a["best_params"], aux_c["best_params"], "best_params")
    assert sorted(os.listdir(tmp_path / "a")) == [FILE]


def test_checkpoint_defaults_and_variables(tmp_path):
    """The default aux is JAX's; ``restore_variables`` gives the nested
    numpy tree that a ``BayesEngine`` attaches, whose predictive equals the
    live model's; ``save_best``/``load_best`` round-trip the parameters;
    a template of another model refuses the checkpoint."""
    model, tx, state, ds = _setup()
    train_loop(model, state, tx, _batches(ds), 0, 1, log_fn=lambda m: None)
    path = save_checkpoint(str(tmp_path / "ck"), state, 11)
    _, seed, aux = restore_checkpoint(path, _setup()[2], with_aux=True)
    assert seed == 11 and aux["epoch"] == -1 and aux["since_best"] == 0
    assert aux["best_metric"] == -float("inf")
    _assert_same(aux["best_params"], dict(model.named_parameters()),
                 "best_params")
    variables = restore_variables(path)
    assert set(variables) == {"params", "batch_stats"}
    x = ds.x_test[:8]
    live = BayesEngine(model, device="cpu")
    live.ready = True
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.nn.zoo import get_model
    other = BayesEngine(get_model("lenet_me", bayes=BayesConfig(rate=0.25),
                                  fused=True), device="cpu").attach(variables)
    want, got = live.predict(x, seed=2), other.predict(x, seed=2)
    for a, b in zip(want[:3], got[:3]):
        assert torch.equal(a, b)
    save_best(str(tmp_path / "best"), dict(model.named_parameters()))
    _assert_same(load_best(str(tmp_path / "best")),
                 {k: p.detach() for k, p in model.named_parameters()},
                 "best")
    wrong = get_model("lenet", bayes=BayesConfig(rate=0.25))
    from bayestpu_torch.train.loop import TrainState
    with pytest.raises(KeyError, match="params"):
        restore_checkpoint(path, TrainState(wrong, state.opt_state))


def test_two_ranks_write_from_the_first_only(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r),
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    assert (tmp_path / "writers").read_text().split() == ["0", "0"]
    assert (tmp_path / "ck" / FILE).is_file()
    p0, p1 = (torch.load(tmp_path / f"params{r}.pt") for r in range(2))
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    ck = torch.load(tmp_path / "ck" / FILE, weights_only=True)
    assert ck["step"] == 4 and ck["aux"]["epoch"] == 1
    for k in p0:
        assert torch.equal(ck["params"][k], p0[k]), k
