"""Operations and bytes of a predictive whose MC sites sit inside the
backbone (block sites), from the shapes of a configuration's reference
(``layer_shapes``: ``carried`` on every layer that runs once a sample,
``site`` on the masked convs of a block site, ``x_carries`` where that
conv's input already holds the S samples).

A spatial predictive of such a model runs the layers before the first
site once and every later layer, the head included, S times; the counts
are of that work, whatever the program launches to do it. The least time
of a masked site conv is the larger of its operations (2·S·N·Cin·Cout·k²
a output pixel) at the compute type's peak and its bytes at the HBM rate:
the input elements it reads, once (S times where x carries the samples;
a 1×1 conv reads only the pixels at its stride), the kernel, and the S
outputs written in the compute type.
"""

from __future__ import annotations

from perfbench.work import ELT_BYTES, PEAK_BYTES, PEAK_OPS, layer_ops

# the program's masked-conv kernel, the one the block sites launch
SITE_KERNEL = "conv_mma_kernel"


def is_site_kernel(name: str) -> bool:
    return SITE_KERNEL in name


def sampled_ops(shapes: list[dict], batch: int, samples: int) -> int:
    """Operations of one spatial predictive of ``batch`` images at S
    samples: the layers before the first site once, the rest S times."""
    return batch * sum(layer_ops(s) * (samples if s.get("carried") else 1)
                       for s in shapes)


def site_conv_bound_s(conv: dict, batch: int, samples: int, compute: str
                      ) -> float:
    """The least time of one masked site conv's launch for S samples."""
    elt = ELT_BYTES[compute]
    ops = samples * batch * layer_ops(conv)
    read = conv["pixels"] if conv["k"] == 1 else conv["hin"] ** 2
    x_bytes = (samples if conv["x_carries"] else 1) * batch * read * (
        conv["cin"] * elt)
    w_bytes = conv["cin"] * conv["cout"] * conv["k"] ** 2 * elt
    out_bytes = samples * batch * conv["pixels"] * conv["cout"] * elt
    return max(ops / PEAK_OPS[compute],
               (x_bytes + w_bytes + out_bytes) / PEAK_BYTES)


def site_convs_bound_s(shapes: list[dict], batch: int, samples: int,
                       compute: str) -> float:
    """The least time of every masked site conv of one predictive."""
    return sum(site_conv_bound_s(s, batch, samples, compute)
               for s in shapes if s.get("site"))
