"""FullAnalysis — the uncertainty and overthinking measurements of the
paper (counterpart of ``bayestpu/metrics/analysis.py``, itself the
reference's ``results_analyzer.py`` ``FullAnalysis``, ``:56-789``):

- per-exit MC-averaged predictions over a test set (``_get_output``,
  ``:236-270``: the mean softmax over ``mc_passes`` stochastic forwards);
- the cumulative exit-ensemble predictions (``:163-165``);
- the correct and wrong sets of each exit → cumulative-correct,
  unique-correct and destructive-overthinking counts (correct early, wrong
  at the final exit; ``all_experiments``, ``:288-337``);
- per-exit and ensemble acc / KDE-ECE / hist-ECE / NLL / MSE
  (``ece_eval_binary``, ``:497-505``);
- the 1..49 MC-pass sweep (``multipass_experiment``, ``:73-92``);
- the confidence-threshold early-exit table with FLOPs
  (``get_confidence_exiting_values``, ``:543-566``);
- the artifact files, name for name and record for record as the JAX
  package writes them (``saver``, ``:508-541``).

The model is a port model that holds its own weights, on ``device`` (the
card unless the caller asks for the CPU). The batch that starts at row
``i`` draws ``core.rng.sample_seeds(fold_seed(seed, i), S, num_sites)``,
where the JAX package folds ``i`` into its key (``analysis.py:111-119``),
so the two agree in distribution, not sample for sample. Each batch's
probabilities come to the host in one copy, and a report's metrics in one
more.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from bayestpu_torch.core.rng import fold_seed, sample_seeds
from bayestpu_torch.engine import sampler
from bayestpu_torch.engine.engine import resolve_device
from bayestpu_torch.engine.inference import (REFERENCE_THRESHOLDS,
                                             early_exit_select)
from bayestpu_torch.metrics.ece import eval_metrics
from bayestpu_torch.metrics.flops import (TABLES, flops_ensembled,
                                          flops_standard)
from bayestpu_torch.metrics.kde import ece_kde

# the eval_metrics keys a report keeps, in the order they are fetched
_REPORT_METRICS = ("acc", "ece_hist", "nll", "mse")


@dataclasses.dataclass
class ExitReport:
    """One exit's row (one line of the reference's CSV log)."""

    acc: float
    ece_kde: float
    ece_hist: float
    nll: float
    mse: float
    cur_correct: int
    cum_correct: int
    unique_correct: int
    destructive_overthinking: int


@dataclasses.dataclass
class AnalysisReport:
    exits: list[ExitReport]
    ensemble: list[ExitReport]
    preds: np.ndarray            # (E, N, C) per-exit MC-averaged probs
    ensemble_preds: np.ndarray   # (E, N, C) cumulative exit ensembles
    labels: np.ndarray           # (N,)
    mc_passes: int


def _ensembles(preds: np.ndarray) -> np.ndarray:
    """The cumulative mean over the exits of (E, N, C) probabilities."""
    return (np.cumsum(preds, axis=0)
            / np.arange(1, preds.shape[0] + 1)[:, None, None])


def _set_report(preds: np.ndarray, labels: np.ndarray, use_kde: bool,
                device: torch.device) -> list[ExitReport]:
    """The rows of (E, N, C) predictions: the set counts on the host, the
    metrics of every exit in f32 on ``device`` (as JAX's, which takes the
    f64 ensembles as f32), fetched in one copy."""
    n_exits = preds.shape[0]
    p = torch.as_tensor(preds, dtype=torch.float32, device=device)
    lab = torch.as_tensor(labels, dtype=torch.int64, device=device)
    mets = torch.stack([
        torch.stack([m[k].float() for k in _REPORT_METRICS])
        for m in (eval_metrics(p[e], lab) for e in range(n_exits))]
    ).cpu().numpy()
    correct_sets = [set(np.nonzero(preds[e].argmax(-1) == labels)[0].tolist())
                    for e in range(n_exits)]
    end_wrong = set(range(len(labels))) - correct_sets[-1]
    cum: set = set()
    rows = []
    for e in range(n_exits):
        cur = correct_sets[e]
        unique = cur - cum
        cum = cum | cur
        acc, ece_hist, nll, mse = (float(v) for v in mets[e])
        kde = ece_kde(preds[e], labels) if use_kde else float("nan")
        rows.append(ExitReport(
            acc=acc, ece_kde=kde, ece_hist=ece_hist, nll=nll, mse=mse,
            cur_correct=len(cur), cum_correct=len(cum),
            unique_correct=len(unique),
            destructive_overthinking=len(cur & end_wrong)))
    return rows


class FullAnalysis:
    """Collect per-exit MC predictions over a dataset and analyse them."""

    def __init__(self, model: torch.nn.Module, x_test, y_test,
                 mc_passes: int = 10, batch_size: int = 250, seed: int = 0,
                 use_kde: bool = True, model_type: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.x = np.asarray(x_test, np.float32)
        self.y = np.asarray(y_test)
        self.mc_passes = mc_passes
        self.batch_size = batch_size
        self.seed = seed
        self.use_kde = use_kde
        self.model_type = model_type
        self._sample_cache: tuple[int, np.ndarray] | None = None

    # ------------------------------------------------------------- capture

    def _batch_seeds(self, start: int, s: int) -> torch.Tensor:
        """(S, n_sites, 2) seeds of the batch that starts at row ``start``
        (JAX: ``fold_in(key, start)``, then one key a sample)."""
        return sample_seeds(fold_seed(self.seed, start), s,
                            self.model.num_sites)

    @torch.inference_mode()
    def _batched(self, fn, s: int, axis: int) -> np.ndarray:
        """``fn(x, seeds)`` over the batches (the last one short), each
        result copied to the host once, concatenated along ``axis``."""
        chunks = []
        for start in range(0, self.x.shape[0], self.batch_size):
            x = torch.as_tensor(self.x[start:start + self.batch_size],
                                device=self.device)
            seeds = self._batch_seeds(start, s).to(self.device)
            chunks.append(fn(x, seeds).cpu().numpy())
        return np.concatenate(chunks, axis=axis)

    def collect(self, mc_passes: int | None = None) -> np.ndarray:
        """(E, N, C) MC-averaged per-exit probabilities (``_get_output``:
        the mean of the softmax over the passes)."""
        return self._batched(
            lambda x, seeds: sampler.predictive(self.model, x, seeds).probs,
            mc_passes or self.mc_passes, axis=1)

    def collect_samples(self, mc_passes: int) -> np.ndarray:
        """(S, E, N, C) per-pass softmax probabilities, collected once and
        kept, so that the multipass sweep averages prefixes instead of
        recomputing (the reference also reuses stored predictions across
        pass counts, ``results_analyzer.py:73-92``)."""
        if (self._sample_cache is not None
                and self._sample_cache[0] >= mc_passes):
            return self._sample_cache[1][:mc_passes]
        out = self._batched(
            lambda x, seeds: torch.softmax(
                sampler.mc_logits(self.model, x, seeds), dim=-1),
            mc_passes, axis=2)
        self._sample_cache = (mc_passes, out)
        return out

    # ------------------------------------------------------------ analysis

    def run(self, mc_passes: int | None = None) -> AnalysisReport:
        preds = self.collect(mc_passes)
        # the reference ensembles the softmax outputs themselves
        # (base_classes.py:54-58)
        ens = _ensembles(preds)
        return AnalysisReport(
            exits=_set_report(preds, self.y, self.use_kde, self.device),
            ensemble=_set_report(ens, self.y, self.use_kde, self.device),
            preds=preds, ensemble_preds=ens, labels=self.y,
            mc_passes=mc_passes or self.mc_passes)

    def multipass_experiment(self, passes=range(1, 50)) -> dict:
        """Accuracy and ECE against the number of MC passes (``:73-92``).
        ``max(passes)`` per-pass probabilities are collected once and
        prefix-averaged: sample i's seeds depend on i alone
        (``core.rng.sample_seeds``), so the mean of the first p is what a
        fresh p-pass run computes."""
        passes = list(passes)
        samples = self.collect_samples(max(passes))       # (S, E, N, C)
        csum = np.cumsum(samples, axis=0)
        out = {"passes": [], "acc": [], "ens_acc": [], "ece": [],
               "ens_ece": []}
        for p in passes:
            preds = csum[p - 1] / p                       # (E, N, C)
            rows = _set_report(preds, self.y, False, self.device)
            ens_rows = _set_report(_ensembles(preds), self.y, False,
                                   self.device)
            out["passes"].append(p)
            out["acc"].append(float(np.mean([r.acc for r in rows])))
            out["ens_acc"].append(float(np.mean([r.acc for r in ens_rows])))
            out["ece"].append(float(np.mean([r.ece_hist for r in rows])))
            out["ens_ece"].append(float(np.mean(
                [r.ece_hist for r in ens_rows])))
        return out

    def confidence_exiting_table(self, thresholds=REFERENCE_THRESHOLDS,
                                 rule: str = "max", exit_only: bool = True
                                 ) -> list[dict]:
        """The early-exit sweep (``get_confidence_exiting_values``,
        ``:543-566``), with FLOPs when ``model_type`` names a table of
        ``metrics.flops.TABLES``. Each row's metrics and exit indices come
        to the host in one copy."""
        rep = self.run()
        table = TABLES.get(self.model_type) if self.model_type else None
        probs = torch.as_tensor(rep.preds, device=self.device)
        labels = torch.as_tensor(self.y, dtype=torch.int64,
                                 device=self.device)
        rows = []
        for t in thresholds:
            res = early_exit_select(probs, t, rule)
            mets = eval_metrics(res.probs, labels)
            packed = torch.cat([torch.stack([v.float() for v in
                                             mets.values()]),
                                res.exit_idx.float()]).cpu().numpy()
            e_idx = packed[len(mets):].astype(np.int64)
            row = {"threshold": t,
                   **{k: float(v) for k, v in zip(mets, packed)},
                   "mean_exit": float(np.mean(e_idx))}
            if table is not None:
                row["flops"] = flops_standard(e_idx, table, self.mc_passes,
                                              exit_only)
                row["flops_ensembled"] = flops_ensembled(
                    e_idx, table, self.mc_passes, exit_only)
                row["flops_vs_baseline"] = row["flops"] / (
                    table.baseline * len(self.y))
            rows.append(row)
        return rows

    # ------------------------------------------------------------- output

    def save_validation(self, outdir: str, x_val, y_val,
                        experiment_id: str = "0") -> str:
        """``validation_predictions_<id>.npy``, the reference's validation
        artifact (``results_analyzer.py:218-223``): three consecutive
        ``np.save`` records in one file — the per-exit MC predictions (E, N,
        C), the cumulative exit ensembles (E, N, C), one-hot labels (N, C)."""
        os.makedirs(outdir, exist_ok=True)
        sub = FullAnalysis(self.model, x_val, y_val,
                           mc_passes=self.mc_passes,
                           batch_size=self.batch_size, seed=self.seed,
                           use_kde=False, model_type=self.model_type,
                           device=self.device)
        preds = sub.collect()
        ens = _ensembles(preds)
        labels = np.asarray(y_val)
        onehot = np.zeros((labels.shape[0], preds.shape[-1]), np.float32)
        onehot[np.arange(labels.shape[0]), labels] = 1.0
        path = os.path.join(outdir,
                            f"validation_predictions_{experiment_id}.npy")
        with open(path, "wb") as f:
            np.save(f, preds)
            np.save(f, ens)
            np.save(f, onehot)
        return path

    def save(self, outdir: str, experiment_id: str = "0") -> dict:
        """The reference's artifact set (``saver``, ``:508-541``): the
        CSV-style evaluation log, the prediction dumps and a summary."""
        os.makedirs(outdir, exist_ok=True)
        rep = self.run()
        log_path = os.path.join(outdir,
                                f"test_evaluation_log_{experiment_id}.txt")
        with open(log_path, "w") as f:
            f.write("exit,acc,ece_kde,ece_hist,nll,mse,cur_correct,"
                    "cum_correct,unique_correct,overthinking\n")
            for tag, rows in (("exit", rep.exits), ("ensemble", rep.ensemble)):
                for e, r in enumerate(rows):
                    f.write(f"{tag}{e},{r.acc:.6f},{r.ece_kde:.6f},"
                            f"{r.ece_hist:.6f},{r.nll:.6f},{r.mse:.6f},"
                            f"{r.cur_correct},{r.cum_correct},"
                            f"{r.unique_correct},"
                            f"{r.destructive_overthinking}\n")
        np.save(os.path.join(outdir,
                             f"test_predictions_{experiment_id}.npy"),
                rep.preds)
        np.save(os.path.join(
            outdir, f"test_ensemble_predictions_{experiment_id}.npy"),
            rep.ensemble_preds)
        np.save(os.path.join(outdir, f"test_labels_{experiment_id}.npy"),
                rep.labels)
        summary = {"log": log_path, "mc_passes": rep.mc_passes,
                   "final_acc": rep.exits[-1].acc,
                   "final_ece_kde": rep.exits[-1].ece_kde}
        with open(os.path.join(outdir,
                               f"summary_{experiment_id}.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary
