"""The typed configuration of the port: a copy of ``bayestpu.core.config``.

Same enums, frozen dataclasses, field names, defaults, validation and
``to_json`` output as the JAX package, so a configuration serialised by
one package reads the same in the other. The copy exists because the port
never imports ``bayestpu`` (its ``__init__`` imports JAX).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any


class DropoutKind(str, enum.Enum):
    """Which Bayesian mask family a site uses: Monte-Carlo dropout
    (``mc``), a Masksembles fixed mask bank (``mask``), or none."""

    MC = "mc"
    MASK = "mask"
    NONE = "none"


class SamplingMode(str, enum.Enum):
    """How MC samples are mapped onto the device.

    ``temporal`` re-runs the whole network once per sample; ``spatial`` runs
    the deterministic backbone once and every sample of the stochastic heads
    in one launch each; ``sharded`` runs as spatial on one process (a
    ``BayesEngine`` with a mesh splits samples and rows over ranks:
    ``engine.sharding``); ``auto`` runs as spatial until ``autotune``
    measures it.
    """

    TEMPORAL = "temporal"
    SPATIAL = "spatial"
    SHARDED = "sharded"
    AUTO = "auto"


class InsertStrategy(str, enum.Enum):
    """Where Bayesian layers are inserted when converting a plain net."""

    DEFAULT = "default"
    LAST = "last"
    FULL = "full"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Fixed-point quantization operating point (QKeras
    ``quantized_bits(total_bits, integer_bits, alpha=1)`` semantics).

    ``int8_det_pallas`` is the JAX package's routing of a deterministic
    int8 conv that a fused kernel takes (``conv_int8_fused`` rather than
    XLA's int8 conv and epilogue), and the port follows it on the CPU,
    where the tests hold it to JAX. On a CUDA device such a conv always
    runs ``conv_int8_fused``, whatever this says (``nn.fused.BayesConv``).
    """

    total_bits: int = 8
    integer_bits: int = 0
    keep_negative: bool = True
    round_mode: str = "AP_RND"
    int8_infer: bool = False
    int8_conv_min_ch: int = 64
    int8_det_pallas: bool = False
    int8_dense_min_dim: int = 0

    def __post_init__(self) -> None:
        if self.total_bits < 2 or self.total_bits > 32:
            raise ValueError(f"total_bits out of range: {self.total_bits}")


@dataclasses.dataclass(frozen=True)
class BayesConfig:
    """Configuration of the Bayesian behaviour of a model."""

    kind: DropoutKind = DropoutKind.MC
    rate: float = 0.25               # MCD drop probability
    num_masks: int = 4               # Masksembles: number of masks (n)
    scale: float = 2.0               # Masksembles: overlap scale (s)
    num_samples: int = 10            # MC forward passes / samples
    num_bayes_layers: int = 1        # how many Bayesian sites to insert
    strategy: InsertStrategy = InsertStrategy.DEFAULT

    def __post_init__(self) -> None:
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1): {self.rate}")
        if self.kind is DropoutKind.MASK and self.num_masks < 2:
            raise ValueError("Masksembles needs at least 2 masks")

    @property
    def effective_samples(self) -> int:
        """For Masksembles, a 'sample' is a mask index."""
        return self.num_masks if self.kind is DropoutKind.MASK else self.num_samples


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """How the engine executes MC inference."""

    mode: SamplingMode = SamplingMode.SPATIAL
    data_axis: str = "data"
    sample_axis: str = "sample"
    compute_dtype: str = "bfloat16"
    quant: QuantConfig | None = None


def to_json(cfg: Any) -> str:
    """Serialize any of the dataclass configs to JSON."""
    def default(o: Any):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        if isinstance(o, enum.Enum):
            return o.value
        raise TypeError(type(o))
    return json.dumps(cfg, default=default, indent=2)
