"""Golden-model verification CLI (counterpart of
``bayestpu/cli/verify_accuracy.py``).

≙ ``Hardware_Artifact/autobayes/verify_accuracy.py`` (Keras vs HLS-csim
accuracy per mask index and mask-averaged) and
``autobayes/verify_masksembles.py`` (converter-produced vs hand-built
Masksembles equivalence). The golden pair here is the **unfused** plain
path (the Masksembles row materialized, then a plain dense) vs the
**fused** path (the bank kernels on a card) — compared per ``mask_index``
(``model(x, seeds, i)``, ``verify_accuracy.py:88-92``) and on the
mask-averaged prediction.

    python -m bayestpu_torch.cli.verify_accuracy --epochs 1
"""

from __future__ import annotations

import argparse
import json

import torch

from bayestpu_torch.cli.common import add_device_arg
from bayestpu_torch.core.config import BayesConfig, DropoutKind
from bayestpu_torch.core.rng import step_seeds
from bayestpu_torch.data.datasets import get_dataset, iterate_batches
from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                              to_flax_variables)
from bayestpu_torch.metrics.ece import accuracy
from bayestpu_torch.nn.zoo import get_model
from bayestpu_torch.train.loop import create_state, make_train_step
from bayestpu_torch.train.optim import adam, constant_schedule


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--num_masks", type=int, default=4)
    p.add_argument("--scale", type=float, default=2.0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--eval_images", type=int, default=512)
    add_device_arg(p)
    a = p.parse_args(argv)

    ds = get_dataset(a.dataset, a.data_dir)
    bayes = BayesConfig(kind=DropoutKind.MASK, num_masks=a.num_masks,
                        scale=a.scale)

    # Train once with the golden (unfused) model; both models share params.
    golden = get_model("lenet", bayes=bayes, fused=False)
    fused = get_model("lenet", bayes=bayes, fused=True)
    tx = adam(constant_schedule(1e-3))
    state = create_state(golden, tx, 0, ds.x_train[:64], device=a.device)
    dev = next(golden.parameters()).device
    step = make_train_step(golden, tx)
    for _ in range(a.epochs):
        for x, y in iterate_batches(ds.x_train, ds.y_train, 64):
            step(state, torch.as_tensor(x, device=dev),
                 torch.as_tensor(y, dtype=torch.int64, device=dev),
                 step_seeds(0, state.step, golden.num_sites).to(dev))
    golden.eval()
    fused = load_flax_variables(fused, to_flax_variables(golden)).to(
        dev).eval()

    x = torch.as_tensor(ds.x_test[:a.eval_images], device=dev)
    y = torch.as_tensor(ds.y_test[:a.eval_images], dtype=torch.int64,
                        device=dev)
    seeds = torch.zeros((golden.num_sites, 2), dtype=torch.int32,
                        device=dev)

    report: dict = {"per_mask": []}
    g_sum = f_sum = None
    with torch.no_grad():
        for i in range(a.num_masks):
            pg = torch.softmax(golden(x, seeds, i).logits[-1], dim=-1)
            pf = torch.softmax(fused(x, seeds, i).logits[-1], dim=-1)
            report["per_mask"].append({
                "mask_index": i,
                "acc_golden": float(accuracy(pg, y)),
                "acc_fused": float(accuracy(pf, y)),
                "max_abs_diff": float((pg - pf).abs().max()),
            })
            g_sum = pg if g_sum is None else g_sum + pg
            f_sum = pf if f_sum is None else f_sum + pf

    report["averaged"] = {
        "acc_golden": float(accuracy(g_sum / a.num_masks, y)),
        "acc_fused": float(accuracy(f_sum / a.num_masks, y)),
        "max_abs_diff": float((g_sum - f_sum).abs().max() / a.num_masks),
    }
    worst = max(r["max_abs_diff"] for r in report["per_mask"])
    report["pass"] = bool(worst < 1e-3 and
                          abs(report["averaged"]["acc_golden"]
                              - report["averaged"]["acc_fused"]) < 1e-6)
    print(json.dumps(report, indent=2))
    if not report["pass"]:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
