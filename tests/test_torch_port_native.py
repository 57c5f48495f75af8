"""The port's native library and host batch pipeline against the JAX
package's, on the CPU.

- ``bayestpu_torch/native/*.cc`` are byte copies of ``bayestpu/native/*.cc``
  (read as files; the JAX package's library is never built here).
- The native KDE-ECE within rtol 1e-9 of JAX's numpy ``ece_kde`` (the
  tolerance of ``tests/test_native.py:23-41``); ``ece_kde``'s default runs
  it; a failed build raises.
- ``augment_gather`` (native) and ``augment_gather_ref`` bit-equal to JAX's
  ``augment_gather_ref``; a ``BatchPipeline`` epoch (order and batches)
  equal to JAX's; ``PrefetchIterator`` hands the same batches over.
- Two processes that build the library at once into an empty directory:
  both load it, and one library is left.
"""

import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bayestpu.data import pipeline as jpipe
from bayestpu.metrics import kde as jkde
from bayestpu_torch import native
from bayestpu_torch.data import pipeline as tpipe
from bayestpu_torch.metrics import kde as tkde

from port_threads import thread_budget  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
MEAN = np.array([0.49, 0.48, 0.45], np.float32)
STD = np.array([0.25, 0.24, 0.26], np.float32)


@pytest.mark.parametrize("name", ["kde_ece.cc", "data_pipeline.cc"])
def test_sources_are_byte_copies(name):
    assert ((REPO / "bayestpu_torch" / "native" / name).read_bytes()
            == (REPO / "bayestpu" / "native" / name).read_bytes())


def _case(seed, n=4000, c=10):
    rng = np.random.default_rng(seed)
    logits = 3 * rng.normal(size=(n, c))
    labels = np.argmax(logits + rng.normal(size=(n, c)), -1)
    probs = np.exp(logits)
    probs /= probs.sum(1, keepdims=True)
    return probs, labels


def _binary():
    rng = np.random.default_rng(3)
    n = 2000
    labels = rng.integers(0, 2, n)
    pred = np.where(rng.random(n) < 0.8, labels, 1 - labels)
    probs = np.zeros((n, 2))
    probs[np.arange(n), pred] = 0.8 + rng.normal(0, 0.02, n)
    probs[:, 0] = np.clip(probs[:, 0], 0.01, 0.99)
    probs[:, 1] = 1 - probs[:, 0]
    return probs, labels


@pytest.mark.parametrize("case", ["0", "1", "2", "binary", "onehot"])
def test_native_kde_matches_jax_numpy(case):
    if case == "binary":
        probs, labels = _binary()
    else:
        probs, labels = _case(int(case) if case.isdigit() else 4)
        if case == "onehot":
            labels = np.eye(probs.shape[1])[labels]
    for order in (1, 2):
        want = jkde.ece_kde(probs, labels, order, native=False)
        got = native.kde_ece(probs, labels, order)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        assert tkde.ece_kde(probs, labels, order) == got       # default
        assert tkde.ece_kde(probs, labels, order, native=True) == got


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses: ``load`` raises, and so does ``ece_kde``'s
    default; nothing falls back to numpy, nothing is left half-written."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    probs, labels = _binary()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tkde.ece_kde(probs, labels)
    assert not list((tmp_path / "build").glob("*.so*"))


def test_library_name_covers_the_host_cpu(monkeypatch):
    """``-march=native`` builds for the host's CPU: the library's name
    changes with it, so a library built on another CPU is never loaded."""
    here = native.lib_path()
    assert platform.machine().encode() in native._host_cpu()
    monkeypatch.setattr(native, "_host_cpu", lambda: b"x86_64\nflags: sse2")
    other = native.lib_path()
    assert other != here and other.parent == here.parent


@pytest.mark.parametrize("train", [True, False])
def test_augment_gather_matches_jax(train):
    rng = np.random.default_rng(7)
    src = rng.random((512, 32, 32, 3), dtype=np.float32)
    idx = rng.integers(0, 512, 64)
    want = jpipe.augment_gather_ref(src, idx, MEAN, STD, 4, 99, train)
    got = tpipe.augment_gather(src, idx, MEAN, STD, 4, 99, train)
    ref = tpipe.augment_gather_ref(src, idx, MEAN, STD, 4, 99, train)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(
        tpipe.augment_gather(src, idx, MEAN, STD, 4, 99, train,
                             use_native=False), want)
    for bad in ([512], [-1]):
        with pytest.raises(IndexError):
            native.augment_gather(src, np.array(bad), MEAN, STD, 4, 0, train)
    for seed in (0, 2 ** 64 - 1, -3):
        oy, ox, flip = tpipe._draws(seed, 64, 4)
        for a, b in zip((oy, ox, flip), jpipe._draws(seed, 64, 4)):
            np.testing.assert_array_equal(a, b)


def test_batch_pipeline_epoch_matches_jax():
    """Two epochs and a seek: the same order and batches as JAX's pipeline
    (its numpy twin, so that the JAX library is not built here)."""
    rng = np.random.default_rng(0)
    x = rng.random((100, 28, 28, 1), dtype=np.float32)
    y = np.arange(100) % 10
    want = jpipe.BatchPipeline(x, y, 32, pad=4, train=True, seed=3,
                               use_native=False)
    got = tpipe.BatchPipeline(x, y, 32, pad=4, train=True, seed=3)
    for epoch in range(2):
        wb, gb = list(want), list(got)
        assert len(gb) == len(wb) == 3
        for (gx, gy), (wx, wy) in zip(gb, wb):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    got.seek(1)
    want.seek(1)
    np.testing.assert_array_equal(next(iter(got))[0], next(iter(want))[0])
    ev = tpipe.BatchPipeline(x, y, 32, train=False)
    np.testing.assert_array_equal(next(iter(ev))[0], x[:32])


def test_prefetch_iterator_hands_over_the_batches():
    x = np.random.default_rng(1).random((64, 8, 8, 3), dtype=np.float32)
    y = np.arange(64) % 10
    pipe = tpipe.BatchPipeline(x, y, 16, seed=2)
    want = list(pipe)
    pipe.seek(0)
    got = list(tpipe.PrefetchIterator(iter(pipe), depth=2, device="cpu"))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor)
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)

    def broken():
        yield x[:2], y[:2]
        raise OSError("disk gone")

    it = tpipe.PrefetchIterator(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_concurrent_builds(tmp_path):
    """Two processes build the library at once into an empty directory:
    one compiles under the lock, the other waits and loads its result;
    both compute the KDE, and one library and no temporary file are
    left."""
    code = f"""
import sys, time, pathlib, numpy as np
from bayestpu_torch import native
native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
while time.time() < float(sys.argv[1]):
    pass
p = np.full((8, 3), 0.2); p[:, 0] = 0.6
print(native.kde_ece(p, np.arange(8) % 3))
"""
    import time
    start = str(time.time() + 2.0)
    procs = [subprocess.Popen([sys.executable, "-c", code, start], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    vals = [float(out.strip().splitlines()[-1]) for out, _ in outs]
    assert vals[0] == vals[1] and np.isfinite(vals[0])
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))
