"""The port's copy of the dataset module against the JAX package's, on the
CPU: the same seed gives equal arrays (synthetic easy and hard data, splits
and batches), so a run of either package trains on the same examples."""

import numpy as np
import pytest

from bayestpu.data import datasets as jds
from bayestpu_torch.data import datasets as tds

from port_threads import thread_budget  # noqa: F401

NO_DIR = "/nonexistent"


def _equal(a, b):
    assert a.meta == b.meta
    for name in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name,difficulty", [
    ("cifar10", "easy"), ("cifar10", "hard"), ("mnist", "easy"),
    ("cifar100", "hard"), ("jet", "easy"), ("chestx", "hard")])
def test_get_dataset_synthetic_equals_jax(name, difficulty):
    kw = dict(data_dir=NO_DIR, n_synth_train=96, n_synth_test=24,
              synth_difficulty=difficulty)
    got = tds.get_dataset(name, **kw)
    _equal(got, jds.get_dataset(name, **kw))
    assert got.meta["synthetic"] and got.meta["name"] == name


def test_normalize_and_constants_equal_jax():
    kw = dict(data_dir=NO_DIR, n_synth_train=32, n_synth_test=8,
              normalize=True)
    _equal(tds.get_dataset("svhn", **kw), jds.get_dataset("svhn", **kw))
    assert tds.DATASET_STATS == jds.DATASET_STATS
    assert tds._SHAPES == jds._SHAPES
    for k in ("HARD_PROTO_AMP", "HARD_NOISE", "HARD_CORR_NOISE",
              "HARD_CORR_K", "HARD_LABEL_NOISE"):
        assert getattr(tds, k) == getattr(jds, k), k
    assert [f for f in tds.Dataset._fields] == list(jds.Dataset._fields)


def test_default_data_dir_reads_the_same_variable():
    assert tds.DEFAULT_DATA_DIR == jds.DEFAULT_DATA_DIR


def test_unknown_or_missing_dataset_raises():
    with pytest.raises(KeyError, match="unknown dataset"):
        tds.get_dataset("bogus")
    with pytest.raises(FileNotFoundError):
        tds.get_dataset("cifar10", data_dir=NO_DIR, allow_synthetic=False)


@pytest.mark.parametrize("seed", [0, 5])
def test_split_and_batches_equal_jax(seed):
    kw = dict(data_dir=NO_DIR, n_synth_train=70, n_synth_test=10)
    tr, xv, yv = tds.train_val_split(tds.get_dataset("cifar10", **kw), 0.2,
                                     seed)
    jtr, jxv, jyv = jds.train_val_split(jds.get_dataset("cifar10", **kw),
                                        0.2, seed)
    _equal(tr, jtr)
    np.testing.assert_array_equal(xv, jxv)
    np.testing.assert_array_equal(yv, jyv)
    for shuffle, drop in ((True, True), (False, True), (True, False)):
        got = list(tds.iterate_batches(tr.x_train, tr.y_train, 16, shuffle,
                                       seed, drop))
        want = list(jds.iterate_batches(jtr.x_train, jtr.y_train, 16,
                                        shuffle, seed, drop))
        assert len(got) == len(want) == (3 if drop else 4)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_flagship_training_set_shape():
    """The chip run's training data: 10,000 hard synthetic CIFAR-10
    images, NHWC f32 in [0, 1], int32 labels."""
    ds = tds.get_dataset("cifar10", data_dir=NO_DIR, synth_difficulty="hard")
    assert ds.x_train.shape == (10_000, 32, 32, 3)
    assert ds.x_test.shape == (2_000, 32, 32, 3)
    assert ds.x_train.dtype == np.float32 and ds.y_train.dtype == np.int32
    assert 0.0 <= ds.x_train.min() and ds.x_train.max() <= 1.0
    assert ds.meta["difficulty"] == "hard"
