"""Figure generation from sweep results (counterpart of
``bayestpu/cli/figures.py``; matplotlib is imported inside the functions).

≙ ``Hardware_Artifact/bayes_hw/scripts/fig_draw/vivado_perf_report_graph.py``
(parses Vivado XML latency/LUT estimates and plots them vs #Bayes layers,
``:60-116``). Input here is the JSON written by ``bayestpu_torch.cli.sweep``
(or the JAX package's); output: latency and cost curves per sweep axis.
The ``compile_s`` panel is the sweep's CUDA-graph capture time.

    python -m bayestpu_torch.cli.figures sweeps/dropouts.json --out figs/
"""

from __future__ import annotations

import argparse
import json
import os


def loss_curve(train_losses, val_metrics, path: str) -> str:
    """Loss-curve figure ≙ ``Software_Artifact/software/train/
    train_utils.py:87-92`` (``plot_loss``: scatter of train and val series
    saved as ``loss_curve_<id>.png``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter(range(len(train_losses)), train_losses, s=12, zorder=1,
               label="train loss")
    if val_metrics:
        ax2 = ax.twinx()
        ax2.scatter(range(len(val_metrics)), val_metrics, s=12, zorder=10,
                    color="tab:orange", label="val metric")
        ax2.set_ylabel("val metric")
    ax.set_xlabel("epoch")
    ax.set_ylabel("train loss")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sweep_json")
    p.add_argument("--out", default="figs")
    a = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(a.sweep_json) as f:
        data = json.load(f)
    rows = data["rows"]
    x_key = next(k for k in ("n_bayes_layers", "num_masks", "scale")
                 if k in rows[0])
    xs = [r[x_key] for r in rows]

    os.makedirs(a.out, exist_ok=True)
    written = []
    panels = [("latency_ms", "latency (ms)"),
              ("samples_per_s", "MC samples / s"),
              ("flops", "FLOPs"),
              ("compile_s", "compile time (s)")]
    fig, axes = plt.subplots(2, 2, figsize=(9, 7))
    for ax, (key, label) in zip(axes.flat, panels):
        ys = [r.get(key) for r in rows]
        if any(y is None for y in ys):
            ax.set_visible(False)
            continue
        ax.plot(xs, ys, marker="o")
        ax.set_xlabel(x_key)
        ax.set_ylabel(label)
        ax.grid(True, alpha=0.3)
    fig.suptitle(f"{data['sweep']} sweep — {data.get('device', '')}")
    fig.tight_layout()
    path = os.path.join(a.out, f"{data['sweep']}_sweep.png")
    fig.savefig(path, dpi=120)
    written.append(path)
    print(json.dumps({"figures": written}))
    return written


if __name__ == "__main__":
    main()
