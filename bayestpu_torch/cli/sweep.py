"""Sweeps: cost vs number of Bayesian layers / masks / scale (counterpart
of ``bayestpu/cli/sweep.py``).

≙ the autobayes sweeps — ``diff_dropouts.py`` (n = 1..8 inserted MCD layers),
``diff_masksembles.py`` (n Masksembles layers), ``diff_scale.py`` (scale
sweep) — which built one HLS project per point and scraped latency/LUT
reports. Here each point compiles the MC predictive (``BayesEngine.compile``:
on a card a CUDA graph; ``compile_s`` is its capture time, where the JAX
package reports XLA's compile time) and records the measured latency and
samples/s of the compiled predict and ``cost_analysis``'s counted FLOPs and
bytes (``code_bytes`` is None: nothing is generated). Results go to
``<out>/<sweep>.json`` and can be plotted with ``bayestpu_torch.cli.figures``.

    python -m bayestpu_torch.cli.sweep dropouts --max_n 8
    python -m bayestpu_torch.cli.sweep masks    --max_n 8
    python -m bayestpu_torch.cli.sweep scale    --values 1.5 2 3 4
    python -m bayestpu_torch.cli.sweep samples  --model lenet --values 2 3 5

The ``samples`` sweep is the latency/resource experiment matrix of
``bayes_hw/scripts/lat_resource_eval/*`` (mc_samples ∈ {2,3,5,7,9} ×
spatial/temporal mapping × any zoo model).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from bayestpu_torch.cli.common import add_device_arg
from bayestpu_torch.core.config import (
    BayesConfig,
    DropoutKind,
    EngineConfig,
    InsertStrategy,
    SamplingMode,
)
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.nn.convert import (Sequential, convert_to_bayesian,
                                       lenet_specs)


def _model_point(name: str, bayes: BayesConfig, mode: SamplingMode,
                 batch: int, iters: int, fused: bool, device: str) -> dict:
    from bayestpu_torch.nn.zoo import get_model
    model = get_model(name, bayes=bayes, fused=fused)
    x = np.zeros((batch,) + tuple(model.input_shape), np.float32)
    eng = BayesEngine(model, bayes, EngineConfig(mode=mode),
                      device=device).init(0, x)
    return _measure(eng, x, iters)


def _measure(eng: BayesEngine, x: np.ndarray, iters: int) -> dict:
    t0 = time.perf_counter()
    eng.compile(x)
    compile_s = time.perf_counter() - t0
    bench = eng.benchmark(x, iters=iters)
    cost = eng.cost_analysis(x)
    return {
        "compile_s": compile_s,
        "latency_ms": bench["latency_s"] * 1e3,
        "samples_per_s": bench["samples_per_s"],
        "flops": cost.get("flops"),
        "bytes_accessed": cost.get("bytes_accessed"),
        "code_bytes": cost.get("generated_code_size_in_bytes"),
    }


def _point(bayes: BayesConfig, device: str, batch: int = 32,
           iters: int = 10, fused: bool = False) -> dict:
    specs = tuple(convert_to_bayesian(lenet_specs(), bayes))
    model = Sequential(specs, (28, 28, 1), fused=fused)
    x = np.zeros((batch, 28, 28, 1), np.float32)
    eng = BayesEngine(model, bayes, device=device).init(0, x)
    return _measure(eng, x, iters)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sweep", choices=["dropouts", "masks", "scale", "samples"])
    p.add_argument("--max_n", type=int, default=4)
    p.add_argument("--values", type=float, nargs="*", default=None)
    p.add_argument("--mc_samples", type=int, default=4)
    p.add_argument("--model", default="lenet",
                   help="zoo model for the `samples` sweep")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--dropout_type", default="mc", choices=["mc", "mask"],
                   help="`samples` sweep: MC dropout or Masksembles "
                        "(≙ the mc_dropout/ vs mask_ensemble/ script trees)")
    p.add_argument("--modes", nargs="*", default=["spatial", "temporal"],
                   choices=["spatial", "temporal"],
                   help="`samples` sweep mappings (≙ Strategy "
                        "latency/resource)")
    p.add_argument("--fused", action="store_true",
                   help="fuse the (Bayes site -> conv/dense) pairs into the "
                        "masked CUDA kernels (the dropout-in-fabric "
                        "synthesis the reference sweeps measure)")
    p.add_argument("--out", default="sweeps")
    add_device_arg(p)
    a = p.parse_args(argv)
    dev = a.device

    rows = []
    if a.sweep == "dropouts":
        # diff_dropouts.py: n=1..max inserted MCD layers, strategy counts
        # from the back (ap_fixed<8,8> there; float here — quant sweeps are
        # a separate axis)
        for n in range(1, a.max_n + 1):
            cfg = BayesConfig(kind=DropoutKind.MC, rate=0.25,
                              num_bayes_layers=n, num_samples=a.mc_samples,
                              strategy=InsertStrategy.FULL if n > 4
                              else InsertStrategy.DEFAULT)
            rows.append({"n_bayes_layers": n,
                         **_point(cfg, dev, fused=a.fused)})
    elif a.sweep == "masks":
        for n in range(2, a.max_n + 1):
            cfg = BayesConfig(kind=DropoutKind.MASK, num_masks=n, scale=2.0,
                              num_bayes_layers=1)
            rows.append({"num_masks": n, **_point(cfg, dev, fused=a.fused)})
    elif a.sweep == "scale":
        values = a.values or [1.5, 2.0, 3.0, 4.0]
        for s in values:
            cfg = BayesConfig(kind=DropoutKind.MASK, num_masks=4, scale=s,
                              num_bayes_layers=1)
            rows.append({"scale": s, **_point(cfg, dev, fused=a.fused)})
    else:  # samples — lat_resource_eval matrix (mc|mask × mapping × model)
        values = [int(v) for v in (a.values or [2, 3, 5, 7, 9])]
        for s in values:
            if a.dropout_type == "mask":
                # mask_ensemble scripts sweep the #masks (= #samples)
                cfg = BayesConfig(kind=DropoutKind.MASK, num_masks=s,
                                  scale=2.0, num_samples=s)
            else:
                cfg = BayesConfig(kind=DropoutKind.MC, rate=0.25,
                                  num_samples=s)
            for mode in (SamplingMode(m) for m in a.modes):
                rows.append({"mc_samples": s, "mode": mode.value,
                             **_model_point(a.model, cfg, mode, a.batch,
                                            iters=10, fused=a.fused,
                                            device=dev)})

    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, f"{a.sweep}.json")
    device = (torch.cuda.get_device_name(torch.device(dev))
              if dev == "cuda" else "cpu")
    out = {"sweep": a.sweep, "device": device, "rows": rows}
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
