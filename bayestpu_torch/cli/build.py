"""Build CLI — ≙ ``Hardware_Artifact/bayes_hw/hls4ml_build.py`` (counterpart
of ``bayestpu/cli/build.py``).

The reference's build stage loads a trained ``.h5``, derives per-layer
ReuseFactor tables from ``--mem_limit`` (``hls4ml_build.py:23-58,88-100``),
emits HLS with ``Bayes=True`` (``:103-110``), compiles the csim library
(``:113``) and launches Vivado synthesis (``:114``), whose reports are later
scraped for LUT/FF/BRAM/latency.

Here: load a checkpoint, ``BayesEngine.compile`` the MC predict for the
requested batch and sample count (on a card a CUDA graph, where the JAX
package AOT-compiles an executable; ``compile_seconds`` is the capture),
and write a build report with ``BayesEngine.cost_analysis`` (FLOPs,
bytes, the measured peak temporary memory, device time and launches).

Strategy mapping (≙ ``--strategy {latency,resource}``):

- ``latency``  → spatial mapping (all MC samples in one predict, the
  ``S_*`` replicated-head layout) — minimum latency, maximum live memory.
- ``resource`` → temporal mapping (one sample at a time ≙ ReuseFactor
  time-multiplexing of MACs) — minimum live memory.

``--mem_limit`` is the knob that selects the reuse tables in the
reference: if the latency build's measured ``temp_size_in_bytes`` exceeds
it, the build degrades to the resource mapping and records that.
``kernel_mapping`` records the port's own routing knobs.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from bayestpu_torch.cli import common
from bayestpu_torch.core.config import EngineConfig, SamplingMode
from bayestpu_torch.data.datasets import get_dataset
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.train.checkpoint import restore_variables


def _build_one(model, variables, bayes, mode: SamplingMode, x,
               device: str) -> dict:
    eng = BayesEngine(model, bayes, EngineConfig(mode=mode), device=device)
    eng.attach(variables)
    stats = eng.compile(x)
    cost = eng.cost_analysis(x)
    return {"strategy_mode": mode.value, **stats, **cost}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--load_model", required=True,
                   help="checkpoint dir from bayestpu_torch.cli.train "
                        "(≙ --load_model m.h5)")
    p.add_argument("--output_dir", default="build_prj",
                   help="report directory (≙ the HLS project dir)")
    p.add_argument("--build_strategy", default="latency",
                   choices=["latency", "resource", "auto"],
                   help="≙ hls4ml Strategy: latency=spatial, "
                        "resource=temporal time-multiplexing, auto=measure "
                        "both and keep the winner")
    p.add_argument("--mem_limit", type=int, default=0,
                   help="max temporary bytes of a predict; 0 = unlimited "
                        "(≙ --mem_limit driving the ReuseFactor tables)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--bench", action="store_true",
                   help="also measure the latency of the compiled predict")
    a = p.parse_args(argv)

    ds = get_dataset(a.dataset, a.data_dir)
    model = common.build_model(a)
    bayes = common.bayes_from_args(a)
    x = ds.x_test[:a.batch]
    variables = restore_variables(a.load_model)

    if a.build_strategy == "auto":
        # time both mappings for this (model, batch, S), keep the winner
        eng = BayesEngine(model, bayes, EngineConfig(mode=SamplingMode.AUTO),
                          device=a.device)
        eng.attach(variables)
        tuned = eng.autotune(x)
        mode = SamplingMode(tuned["mode"])
        report = _build_one(model, variables, bayes, mode, x, a.device)
        report["autotune"] = tuned
    else:
        mode = (SamplingMode.SPATIAL if a.build_strategy == "latency"
                else SamplingMode.TEMPORAL)
        report = _build_one(model, variables, bayes, mode, x, a.device)
    report["degraded_to_resource"] = False
    temp = report.get("temp_size_in_bytes") or 0
    if a.mem_limit and mode is SamplingMode.SPATIAL and temp > a.mem_limit:
        # over budget: re-build time-multiplexed, as the reference's reuse
        # tables do when mem_limit shrinks (hls4ml_build.py:23-58)
        report = _build_one(model, variables, bayes,
                            SamplingMode.TEMPORAL, x, a.device)
        report["degraded_to_resource"] = True
        report["latency_build_temp_bytes"] = int(temp)
    report["mem_limit"] = a.mem_limit
    report["requested_strategy"] = a.build_strategy
    # the port's routing knobs behind these numbers (the JAX report lists
    # the TPU's block sizes here); its VGG runs the entry block unchunked
    from bayestpu_torch.nn.fused import (MASKED_CONV_FUSE_MIN_CH,
                                         det_int8_on_kernel)
    q = getattr(model, "quant", None)
    report["kernel_mapping"] = {
        "masked_conv_fused_min_in_ch": MASKED_CONV_FUSE_MIN_CH,
        "int8_conv_min_ch": getattr(q, "int8_conv_min_ch", None),
        # the route of a deterministic int8 conv that a fused kernel takes
        "int8_det_conv": None if q is None or not q.int8_infer else (
            "conv_int8_fused" if det_int8_on_kernel(q, torch.device(a.device))
            else "int8_conv2d"),
        "entry_block_batch_chunk": None,
    }

    if a.bench:
        eng = BayesEngine(
            model, bayes,
            EngineConfig(mode=SamplingMode(report["strategy_mode"])),
            device=a.device).attach(variables)
        eng.compile(x)
        report["benchmark"] = eng.benchmark(x)

    os.makedirs(a.output_dir, exist_ok=True)
    out_path = os.path.join(a.output_dir, "build_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
