"""Import Keras ``.h5`` checkpoints — the reference's HW model format (a
copy of ``bayestpu/interop/keras_import.py``; the variables tree is the
nested-numpy one of ``interop.from_flax``).

The HW artifact saves trained QKeras models as HDF5
(``mc_model.model.save('.h5')``, ``Hardware_Artifact/bayes_hw/
train_qkeras_mcme.py:263``) and reloads them with a custom-object registry
(``hls4ml_build.py:61-63``). This module reads those files directly with
h5py — no TF/QKeras needed at import time — and maps weights onto bayestpu
zoo models **by layer name**: the zoo deliberately reuses the reference's
layer names (``conv2d_1``, ``fc_1``, ``fused_convbn_*`` …), and both sides
are channels-last (keras conv kernels are already HWIO, dense kernels
(in, out)), so no transposes are required — only name lookup.

QKeras note: quantizers live in the layer *config*, not the weights; the
stored weights are the float "shadow" weights, which is exactly what our
fake-quant layers consume (quantization re-applied on the fly, matching
QKeras semantics).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def read_h5_weights(path: str) -> dict[str, dict[str, np.ndarray]]:
    """All weight arrays from a keras HDF5 file, keyed
    ``{layer_name: {weight_name: array}}``.

    Handles both the legacy layout (``model_weights/<layer>/<layer>/
    kernel:0``) and flat variations by walking every dataset.
    """
    import h5py

    out: dict[str, dict[str, np.ndarray]] = {}

    def visit(name: str, obj) -> None:
        if not isinstance(obj, h5py.Dataset):
            return
        parts = [p for p in name.split("/") if p]
        if parts and parts[0] in ("model_weights", "layers"):
            parts = parts[1:]
        if not parts:
            return
        layer = parts[0]
        wname = parts[-1].split(":")[0]
        out.setdefault(layer, {})[wname] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


_KERAS_TO_FLAX = {"kernel": "kernel", "bias": "bias",
                  "gamma": "scale", "beta": "bias",
                  "moving_mean": "mean", "moving_variance": "var"}


def assign_by_name(variables: dict, weights: dict[str, dict[str, np.ndarray]],
                   rename: Callable[[str], str] | None = None,
                   strict: bool = True) -> dict:
    """Fill a ``variables`` tree (``to_flax_variables(model)``) from keras
    layer weights; the filled leaves are numpy arrays.

    Walks ``variables['params']`` (and BN stats); for each module whose name
    matches a keras layer (after optional ``rename``), replaces same-shaped
    arrays. Returns the updated variables; raises on any shape mismatch and
    (if ``strict``) on params whose layer exists but weight is missing.
    """
    def fill(tree: Any, path: tuple[str, ...], mapping_for) -> Any:
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,), mapping_for) for k, v in
                    tree.items()}
        # leaf: path = (..., layer-ish..., weight_name)
        wname = _KERAS_TO_FLAX.get(path[-1], path[-1])
        for i in range(len(path) - 1, 0, -1):
            layer = rename(path[i - 1]) if rename else path[i - 1]
            if layer in weights:
                cand = weights[layer]
                for kname, fname in _KERAS_TO_FLAX.items():
                    if fname == wname and kname in cand:
                        arr = cand[kname]
                        if arr.shape != tuple(np.shape(tree)):
                            raise ValueError(
                                f"shape mismatch at {'/'.join(path)}: "
                                f"h5 {arr.shape} vs model {np.shape(tree)}")
                        return np.asarray(arr)
                if strict:
                    raise KeyError(
                        f"layer {layer!r} in h5 lacks weight for "
                        f"{'/'.join(path)}")
        return tree

    return {coll: fill(tree, (), None) for coll, tree in variables.items()}
