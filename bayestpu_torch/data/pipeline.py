"""Host-side batch pipeline: fused gather + augment + normalize (counterpart
of ``bayestpu/data/pipeline.py``).

The reference assembles training batches through per-image transform
stacks (torchvision ``RandomCrop(32, padding=4)`` + ``RandomHorizontalFlip``
+ ``Normalize`` in ``DataLoader`` workers,
``Software_Artifact/software/datasets/dataset_loader.py:103-108``). Here
one native call (``bayestpu_torch/native/data_pipeline.cc``) assembles the
whole batch: the gather of the shuffled rows, the zero-pad random crop, the
horizontal flip and the channel normalization in one threaded pass.

Each row's crop and flip come from splitmix64(seed, row), which the numpy
twin ``augment_gather_ref`` reproduces exactly, so the two are bit-equal.
``augment_gather`` runs the native path unless ``use_native=False``; a
library that does not build or load raises, where the JAX package falls
back to numpy quietly. The batches are numpy on the host;
``PrefetchIterator`` copies them to the card ahead of the step that needs
them.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64, as ``data_pipeline.cc`` computes it."""
    with np.errstate(over="ignore"):
        x = (x + _GOLD).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _draws(seed: int, n: int, pad: int
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each row's (oy, ox, flip), the C++ derivation."""
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        r = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) ^ (i * _GOLD))
    span = np.uint64(2 * pad + 1)
    oy = (r % span).astype(np.int64)
    r2 = _splitmix64(r)
    ox = (r2 % span).astype(np.int64)
    flip = (_splitmix64(r2) & np.uint64(1)).astype(bool)
    return oy, ox, flip


def augment_gather_ref(src: np.ndarray, idx: np.ndarray,
                       mean: np.ndarray, std: np.ndarray,
                       pad: int, seed: int, train: bool) -> np.ndarray:
    """The numpy twin of ``native.augment_gather``."""
    src = np.asarray(src, np.float32)
    batch = src[np.asarray(idx, np.int64)]
    b, h, w, c = batch.shape
    mean = np.asarray(mean, np.float32).reshape(c)
    std = np.asarray(std, np.float32).reshape(c)
    if train and pad > 0:
        oy, ox, flip = _draws(seed, b, pad)
        padded = np.pad(batch,
                        ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        out = np.empty_like(batch)
        for i in range(b):
            img = padded[i, oy[i]:oy[i] + h, ox[i]:ox[i] + w]
            out[i] = img[:, ::-1] if flip[i] else img
        batch = out
    return ((batch - mean) / std).astype(np.float32)


def augment_gather(src: np.ndarray, idx: np.ndarray,
                   mean: np.ndarray | None = None,
                   std: np.ndarray | None = None,
                   pad: int = 4, seed: int = 0, train: bool = True,
                   use_native: bool | None = None) -> np.ndarray:
    """Assemble one batch: the native library unless ``use_native`` is
    False, then the numpy twin."""
    c = src.shape[-1]
    mean = np.zeros(c, np.float32) if mean is None else mean
    std = np.ones(c, np.float32) if std is None else std
    if use_native is not False:
        from bayestpu_torch import native
        return native.augment_gather(src, idx, mean, std, pad, seed, train)
    return augment_gather_ref(src, idx, mean, std, pad, seed, train)


class BatchPipeline:
    """Epoch iterator over (x, y) with fused batch assembly: shuffles each
    epoch (unless ``train`` is False), drops the remainder (fixed shapes;
    Masksembles' batch split), assembles each batch with one call."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 mean=None, std=None, pad: int = 4, train: bool = True,
                 seed: int = 0, use_native: bool | None = None):
        self.x = np.ascontiguousarray(x, np.float32)
        self.y = np.asarray(y)
        self.batch_size = batch_size
        self.mean, self.std = mean, std
        self.pad, self.train = pad, train
        self.seed = seed
        self.use_native = use_native
        self._epoch = 0

    def seek(self, epoch: int) -> None:
        """Set the epoch counter: the shuffle and the augmentation are pure
        functions of it, so a resumed run replays the same batches."""
        self._epoch = epoch

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = self.x.shape[0]
        rng = np.random.default_rng(self.seed + self._epoch)
        order = rng.permutation(n) if self.train else np.arange(n)
        bs = self.batch_size
        for start in range(0, n - n % bs, bs):
            idx = order[start:start + bs]
            xb = augment_gather(self.x, idx, self.mean, self.std, self.pad,
                                seed=self.seed * 1_000_003 + self._epoch
                                * 131 + start,
                                train=self.train,
                                use_native=self.use_native)
            yield xb, self.y[idx]
        self._epoch += 1


class PrefetchIterator:
    """Overlap the host's batch assembly and the copy to the card with the
    device's work: a worker thread runs the wrapped (x, y) iterator and
    copies the next ``depth`` batches to ``device`` (from pinned memory on a
    card) while the current step runs (``DataLoader(num_workers=…)``'s
    prefetch in the reference, ``dataset_loader.py:160-172``). A failure in
    the worker is raised to the consumer."""

    def __init__(self, it, depth: int = 2,
                 device: str | torch.device = "cuda"):
        import queue
        import threading

        from bayestpu_torch.engine.engine import resolve_device

        dev = resolve_device(device)
        self._q = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None

        def put(a) -> torch.Tensor:
            t = torch.as_tensor(a)
            if dev.type == "cuda":
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)

        def work():
            try:
                for x, y in it:
                    self._q.put((put(x), put(y)))
            except BaseException as e:  # raised on the consumer's side
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
