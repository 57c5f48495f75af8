"""Prediction/verification CLI — ≙ ``Hardware_Artifact/bayes_hw/hls4ml_pred.py``
(counterpart of ``bayestpu/cli/predict.py``).

Loads a checkpoint, runs MC (or per-mask) predictive inference, and prints
accuracy, ECE and aPE (on dataset-matched gaussian noise) side by side for
the temporal and spatial mappings — the acceptance test of the flow
(``hls4ml_pred.py:89-119`` prints Keras-vs-HLS; here the golden pair is
temporal-vs-spatial).

    python -m bayestpu_torch.cli.predict --model lenet_me \
        --load_model snapshots/run [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from bayestpu_torch.cli import common
from bayestpu_torch.core.config import EngineConfig, SamplingMode
from bayestpu_torch.data.datasets import get_dataset
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.train.checkpoint import restore_variables


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--load_model", required=True,
                   help="checkpoint dir from bayestpu_torch.cli.train")
    p.add_argument("--eval_images", type=int, default=200,
                   help="≙ hls4ml_pred.py --eval_imgs default 200")
    p.add_argument("--passes", type=int, default=1,
                   help=">1 repeats the evaluation with fresh seeds and "
                        "reports mean±std (≙ evaluate.py:12-18)")
    p.add_argument("--log", default=None,
                   help="write a log_<id>.txt-style metric dump here")
    a = p.parse_args(argv)

    ds = get_dataset(a.dataset, a.data_dir)
    model = common.build_model(a)
    variables = restore_variables(a.load_model)
    x = ds.x_test[:a.eval_images]
    y = ds.y_test[:a.eval_images]
    bayes = common.bayes_from_args(a)

    out = {}
    for mode in (SamplingMode.TEMPORAL, SamplingMode.SPATIAL):
        eng = BayesEngine(model, bayes, EngineConfig(mode=mode),
                          device=a.device).attach(variables)
        if a.passes > 1:
            out[mode.value] = eng.evaluate_repeated(
                x, y, passes=a.passes, seed=a.seed,
                log_path=(f"{a.log}.{mode.value}" if a.log else None))
        else:
            out[mode.value] = eng.evaluate(x, y, ood_check=True)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
