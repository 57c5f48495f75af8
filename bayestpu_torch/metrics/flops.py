"""FLOPs accounting for multi-exit inference under confidence gating (a
numpy copy of ``bayestpu/metrics/flops.py``).

The reference's FLOPs machinery
(``Software_Artifact/software/train/results_analyzer.py``):

- ``TABLES`` (``get_flops_per_module``, ``:568-580``): the per-backbone-
  block, per-exit-conv and per-exit-head FLOPs of vgg19 and resnet18,
  verbatim, the paper's accounting baseline;
- ``flops_standard`` (``flop_saver``, ``:639-672``): each instance pays the
  backbone up to its exit block, that exit's conv cascade, and its head
  once per MC pass (``exit_only``) or the whole path per pass;
- ``flops_ensembled`` (``flop_saver_ensembled``, ``:674-725``): the exit
  ensemble also pays every earlier exit's cascade and head;
- ``FlopsTable.baseline`` (``:579``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlopsTable:
    per_layer: tuple[int, ...]        # backbone block FLOPs
    per_exit_convs: tuple[int, ...]   # exit feature-extractor cascades
    per_exit: tuple[int, ...]         # exit classifier heads

    @property
    def n_exits(self) -> int:
        return len(self.per_layer)

    @property
    def baseline(self) -> int:
        return (sum(self.per_layer) + self.per_exit_convs[-1]
                + self.per_exit[-1])


# results_analyzer.py:571-578, verbatim
TABLES: dict[str, FlopsTable] = {
    "vgg19": FlopsTable(
        per_layer=(40173568, 56950784, 132448256, 132284416, 37789696),
        per_exit_convs=(14227456, 9467904, 4728832, 0, 0),
        per_exit=(51200,) * 5),
    "resnet18": FlopsTable(
        per_layer=(154402816, 135036928, 134627328, 134422528),
        per_exit_convs=(56909824, 37871616, 18915328, 0),
        per_exit=(51200,) * 4),
}


def flops_standard(exit_idx: np.ndarray, table: FlopsTable,
                   mc_passes: int = 10, exit_only: bool = True) -> int:
    """Total FLOPs when instance b exits at block ``exit_idx[b]``:
    ``exit_only`` (dropout only in the exit heads) re-runs only the head per
    MC pass, else the whole path."""
    cum_layers = np.cumsum(table.per_layer)
    convs = np.asarray(table.per_exit_convs)
    heads = np.asarray(table.per_exit)
    e = np.asarray(exit_idx)
    if exit_only:
        per_inst = cum_layers[e] + convs[e] + mc_passes * heads[e]
    else:
        per_inst = mc_passes * (cum_layers[e] + convs[e] + heads[e])
    return int(per_inst.sum())


def flops_ensembled(exit_idx: np.ndarray, table: FlopsTable,
                    mc_passes: int = 10, exit_only: bool = True) -> int:
    """The exit ensemble: every exit up to the chosen one is evaluated."""
    cum_layers = np.cumsum(table.per_layer)
    cum_convs = np.cumsum(table.per_exit_convs)
    cum_heads = np.cumsum(table.per_exit)
    e = np.asarray(exit_idx)
    if exit_only:
        per_inst = cum_layers[e] + cum_convs[e] + mc_passes * cum_heads[e]
    else:
        per_inst = mc_passes * (cum_layers[e] + cum_convs[e] + cum_heads[e])
    return int(per_inst.sum())
