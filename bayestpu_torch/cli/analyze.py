"""Analysis CLI — ≙ the ``results_analyzer.py`` __main__ (``:736-789``)
(counterpart of ``bayestpu/cli/analyze.py``).

Loads a checkpoint and runs the FullAnalysis battery: per-exit +
exit-ensemble acc/ECE(KDE+hist)/NLL/MSE, overthinking counts, the
confidence-threshold early-exit sweep with FLOPs accounting, and (optional)
the 1..49 multipass sweep. Writes the reference's artifact set into --out.
"""

from __future__ import annotations

import argparse
import json

from bayestpu_torch.cli import common
from bayestpu_torch.data.datasets import get_dataset, train_val_split
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.metrics.analysis import FullAnalysis
from bayestpu_torch.train.checkpoint import restore_variables


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--load_model", required=True)
    p.add_argument("--out", default="analysis_out")
    p.add_argument("--eval_images", type=int, default=1000)
    p.add_argument("--multipass", action="store_true",
                   help="run the 1..49 MC-pass sweep (slow)")
    p.add_argument("--model_type", default=None,
                   choices=[None, "vgg19", "resnet18"],
                   help="FLOPs table for the early-exit sweep")
    p.add_argument("--experiment_id", default="0")
    a = p.parse_args(argv)

    ds = get_dataset(a.dataset, a.data_dir)
    model = load_flax_variables(common.build_model(a),
                                restore_variables(a.load_model))
    fa = FullAnalysis(model, ds.x_test[:a.eval_images],
                      ds.y_test[:a.eval_images], mc_passes=a.mc_samples,
                      model_type=a.model_type, device=a.device)
    summary = fa.save(a.out, a.experiment_id)
    # validation artifact (≙ save_validation, results_analyzer.py:218-223)
    _, x_val, y_val = train_val_split(ds, 0.1, a.seed)
    summary["validation_npy"] = fa.save_validation(
        a.out, x_val[:a.eval_images], y_val[:a.eval_images],
        a.experiment_id)
    summary["early_exit"] = fa.confidence_exiting_table()
    if a.multipass:
        summary["multipass"] = fa.multipass_experiment()
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
