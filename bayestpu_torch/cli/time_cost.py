"""Conversion/compile-time benchmark — ≙ ``Hardware_Artifact/autobayes/
time_cost.py`` (100-loop timeit of Keras→BNN conversion and hls compile)
(counterpart of ``bayestpu/cli/time_cost.py``).

Times (a) spec conversion NN→BNN and (b) building the model, its
parameters and ``BayesEngine.compile`` of the MC predictive (on a card the
CUDA-graph capture, where the JAX package times XLA's compile; on the CPU
``compile`` captures nothing), and writes ``timing/<net>.txt`` in the
reference's format.
"""

from __future__ import annotations

import argparse
import json
import os
import timeit

import numpy as np

from bayestpu_torch.cli.common import add_device_arg
from bayestpu_torch.core.config import BayesConfig, DropoutKind, InsertStrategy
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.nn.convert import (Sequential, convert_to_bayesian,
                                       lenet_specs)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("net", nargs="?", default="LeNet")
    p.add_argument("--loops", type=int, default=100)
    p.add_argument("--out_dir", default="timing")
    add_device_arg(p)
    a = p.parse_args(argv)

    specs = lenet_specs()
    bayes = BayesConfig(kind=DropoutKind.MC, rate=0.25,
                        strategy=InsertStrategy.FULL, num_samples=4)

    t_convert = timeit.timeit(
        lambda: convert_to_bayesian(specs, bayes), number=a.loops) / a.loops

    converted = tuple(convert_to_bayesian(specs, bayes))
    x = np.zeros((1, 28, 28, 1), np.float32)

    def build_and_compile():
        model = Sequential(converted, (28, 28, 1))
        eng = BayesEngine(model, bayes, device=a.device).init(0, x)
        eng.compile(x)

    n_compile = max(a.loops // 20, 1)  # the compile is the slow leg
    t_compile = timeit.timeit(build_and_compile, number=n_compile) / n_compile

    os.makedirs(a.out_dir, exist_ok=True)
    path = os.path.join(a.out_dir, f"{a.net}.txt")
    with open(path, "w") as f:
        f.write(f"Conversion time of {a.net}: {t_convert}\n")
        f.write(f"Compile time of {a.net}: {t_compile}\n")
    out = {"net": a.net, "convert_s": t_convert, "compile_s": t_compile,
           "file": path}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
