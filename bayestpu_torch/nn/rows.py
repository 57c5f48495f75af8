"""Where a layer's batch sits in the global batch under data sharding.

Under a sharded ``jax.jit`` the JAX package computes exactly what it
computes on the whole batch, and three layers of the port must know that
the tensor they get is one rank's rows of a larger batch to do the same
(``engine.sharding`` runs them so):

- every MC mask is keyed on the *global* row: the hash-keyed kernels and
  the threefry masks take ``row0``, the global row of the tensor's first
  row;
- the Masksembles training split is global: global row r belongs to group
  ``r // (batch / num_masks)``;
- a train-mode ``BatchNorm`` takes its statistics over the global batch,
  through the data axis's process group.

A module that reads its place has the class attribute ``rows`` (``WHOLE``:
the tensor is the whole batch), which ``engine.sharding.at_rows`` sets on
the instances of one model for one call.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class Rows(NamedTuple):
    """row0: the global batch row of the tensor's first row; batch: the
    global batch size (None: the tensor's own); group: the process group
    of the data axis (None: no collective)."""

    row0: int = 0
    batch: int | None = None
    group: Any = None


WHOLE = Rows()


class RowAware:
    """A module whose output depends on where its rows sit in the global
    batch; ``rows`` is ``WHOLE`` unless ``engine.sharding.at_rows`` sets
    it."""

    rows: Rows = WHOLE
