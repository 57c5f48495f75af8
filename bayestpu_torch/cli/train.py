"""Training CLI — ≙ ``Hardware_Artifact/bayes_hw/train_qkeras_mcme.py`` and
the sacred pipeline of ``Software_Artifact/software/main.py`` (counterpart
of ``bayestpu/cli/train.py``).

Trains a (multi-exit) Bayesian model with the EED loss, early stopping on
validation accuracy, then saves a full checkpoint and prints the evaluation
battery. Example (on the card; ``--device cpu`` on the CPU):

    python -m bayestpu_torch.cli.train --model lenet_me --dataset mnist \
        --dropout_type mc --mc_samples 5 --epochs 5 --quant_tbit 8

A rolling checkpoint ``<out>_last`` is written every ``--checkpoint_every``
epochs; ``--resume`` continues from it bit-identically. With ``--opt_mode
sharded`` inside a process group (``engine.distributed.initialize``: the
``RANK``/``WORLD_SIZE`` environment of a launcher) the training is
data-parallel over every rank, the first rank writing the checkpoints;
without one it trains on one process, as JAX does on one device. The
loss curve ``<out>_loss_curve.png`` needs matplotlib; where it is not
installed the run says so and draws none (the checkpoint and the
evaluation do not depend on it).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import torch
import torch.distributed as dist

from bayestpu_torch.cli import common
from bayestpu_torch.core.rng import step_seeds
from bayestpu_torch.data.augment import random_crop_flip
from bayestpu_torch.data.datasets import (get_dataset, iterate_batches,
                                          train_val_split)
from bayestpu_torch.engine.engine import BayesEngine
from bayestpu_torch.interop.from_flax import buffers_by_collection
from bayestpu_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from bayestpu_torch.train.loop import create_state, train_loop
from bayestpu_torch.train.losses import EEDConfig
from bayestpu_torch.train.optim import get_optimizer, get_recipe


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--loss_output", default="MSE", choices=["MSE", "KL"])
    p.add_argument("--no_eed", action="store_true")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation (train_base.py:28-34)")
    p.add_argument("--val_mode", default="acc", choices=["acc", "eed", "ce"],
                   help="early-stop metric (train_utils.py:40-65)")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--pipeline", default="device", choices=["device", "host"],
                   help="augment on the device (random_crop_flip) or on "
                        "the host (the native fused gather+crop+flip, "
                        "data.pipeline.BatchPipeline)")
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--out", default="snapshots/run")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>_last (full state: params + opt "
                        "+ seed + step); continues bit-identically")
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="rolling <out>_last checkpoint every N epochs "
                        "(0 = off)")
    p.add_argument("--runs_db", default=None,
                   help="record config/stdout/metrics under this runs_db "
                        "dir (≙ sacred FileStorageObserver, main.py:10-13); "
                        "omit to disable")
    a = p.parse_args(argv)

    seed = a.seed
    ds = get_dataset(a.dataset, a.data_dir)
    overrides = {k: v for k, v in
                 {"epochs": a.epochs, "batch_size": a.batch_size,
                  "lr": a.lr,
                  "accum_steps": a.accum_steps if a.accum_steps > 1 else None,
                  }.items() if v is not None}
    recipe = get_recipe(a.model.split("_")[0], **overrides)
    ds, x_val, y_val = train_val_split(ds, a.val_fraction, a.seed)
    steps = max(len(ds.x_train) // recipe.batch_size, 1)

    model = common.build_model(a)
    tx = get_optimizer(recipe, steps)
    state = create_state(model, tx, seed, ds.x_train[:recipe.batch_size],
                         device=a.device)

    start_epoch, best0 = 0, None
    # a sibling of the final checkpoint, as in the JAX CLI
    resume_path = a.out.rstrip("/") + "_last"
    if a.resume:
        if not os.path.isdir(resume_path):
            raise FileNotFoundError(
                f"--resume: no checkpoint at {resume_path}")
        state, seed, aux = restore_checkpoint(resume_path, state,
                                              with_aux=True)
        start_epoch = aux["epoch"] + 1
        best0 = (aux["best_metric"], aux["best_params"], aux["since_best"])
        print(f"resumed from {resume_path}: step {state.step} "
              f"(epoch {start_epoch})")

    if a.pipeline == "host":
        from bayestpu_torch.data.pipeline import BatchPipeline
        pipe = BatchPipeline(ds.x_train, ds.y_train, recipe.batch_size,
                             pad=4 if a.augment else 0, train=True,
                             seed=a.seed)
        pipe.seek(start_epoch)  # resumed runs replay the right shuffles
        augment_fn = None  # the host pipeline already augments

        def train_batches():
            return iter(pipe)
    else:
        augment_fn = ((lambda s, x, i: random_crop_flip(s, x, 4, i))
                      if a.augment else None)

        def train_batches():
            # consumed once: train_loop caches the stacked batches on the
            # device and reshuffles them there each epoch
            return iterate_batches(ds.x_train, ds.y_train,
                                   recipe.batch_size, seed=a.seed)

    def val_batches():
        return iterate_batches(x_val, y_val, recipe.test_batch_size,
                               shuffle=False)

    run = None
    if a.runs_db:
        from bayestpu_torch.utils.rundb import Run
        run = Run(a.runs_db, config=vars(a), name=common.run_suffix(a))

    def log_fn(msg: str) -> None:
        print(msg)
        if run is not None:
            run.log_text(msg)

    mesh = None
    if a.opt_mode == "sharded":
        from bayestpu_torch.engine import distributed, sharding
        distributed.initialize()
        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = sharding.make_mesh(dist.get_world_size(), 1)
            log_fn(f"data-parallel training over {mesh}")

    history: dict = {}
    state = train_loop(
        model, state, tx, train_batches, seed, recipe.epochs,
        val_batches=val_batches,
        eed_cfg=EEDConfig(use_eed=not a.no_eed, loss_output=a.loss_output),
        patience=recipe.patience, val_mode=a.val_mode,
        augment_fn=augment_fn, mesh=mesh,
        checkpoint_dir=resume_path, checkpoint_every=a.checkpoint_every,
        start_epoch=start_epoch, best0=best0,
        plateau_factor=(recipe.plateau_factor
                        if recipe.scheduler == "plateau" else None),
        plateau_patience=recipe.plateau_patience,
        reshuffle=(a.pipeline == "device"), history=history, log_fn=log_fn)

    if a.quant_tbit > 0 and buffers_by_collection(model)["batch_stats"]:
        # QAT: re-estimate the BN running statistics with frozen parameters
        # before the checkpoint and the evaluation (train.loop.bn_reestimate)
        from bayestpu_torch.train.loop import bn_reestimate
        bs = recipe.batch_size
        xs = [ds.x_train[i:i + bs]
              for i in range(0, len(ds.x_train) - bs + 1, bs)]
        bn_reestimate(model, xs, step_seeds(seed, 0, model.num_sites).to(
            next(model.parameters()).device))
        log_fn("BN running stats re-estimated (QAT)")

    first = mesh is None or dist.get_rank() == mesh.first
    ckpt = os.path.abspath(a.out)
    if first:
        save_checkpoint(a.out, state, seed)
    if first and history.get("train_loss"):
        if importlib.util.find_spec("matplotlib") is None:
            log_fn("no loss curve: matplotlib is not installed")
        else:
            from bayestpu_torch.cli.figures import loss_curve
            loss_curve(history["train_loss"], history.get("val_metric", []),
                       a.out.rstrip("/") + "_loss_curve.png")
    eng = BayesEngine(model, common.bayes_from_args(a),
                      common.engine_from_args(a), device=a.device).attach(
                          state.variables())
    from bayestpu_torch.metrics.entropy import NOISE_STATS
    mets = eng.evaluate(ds.x_test[:1000], ds.y_test[:1000], ood_check=True,
                        dataset=(a.dataset if a.dataset in NOISE_STATS
                                 else None))
    result = {"checkpoint": ckpt, "synthetic": ds.meta["synthetic"], **mets}
    if run is not None:
        run.log_metrics(state.step, **{k: v for k, v in mets.items()
                                       if isinstance(v, float)})
        run.log_text(json.dumps(result))
        run.close()
        result["run_id"] = run.run_id
    if mesh is not None:
        # the other ranks return once the first has written
        dist.broadcast(torch.zeros(1, device=next(model.parameters()).device),
                       src=mesh.first)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
