"""MC-samples/s of the sharded predictive over 1, 2, … ranks (counterpart
of ``bench/scaling.py``).

Each size n starts n processes in a gloo world (``engine.distributed``,
a ``file://`` rendezvous in a temporary directory), puts the n ranks on
the sample axis (``engine.sharding.make_mesh(1, n)``) and times
``sharded_predictive`` of one seeded model over ``--iters`` calls on every
rank (a fixed count, so that every rank makes the same collectives),
fenced by a synchronise; efficiency is ``sps_n / (n · sps_1)``.

Rank r runs on ``cuda:(r mod cards)``. When ranks share a device (more
ranks than cards, or the CPU) they share its cores and its memory, so the
numbers show that the sharded path runs and what it costs, not how it
scales: the result then says ``"shared_device": true`` and carries the
label "ranks share one card: mechanics, not scaling", as the JAX bench
labels its virtual CPU mesh. The JAX bench's analytic model of the TPU's
inter-chip links has no counterpart here.

Usage: ``python -m bayestpu_torch.bench.scaling [--ranks 2] [--samples 32]
[--batch 64] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import tempfile

import torch

from bayestpu_torch.cli.common import add_device_arg

SHARED = "ranks share one card: mechanics, not scaling"
# seconds a world may take to start, time and report
TIMEOUT_S = 600


def _rank(n: int, rank: int, workdir: str, a: dict) -> None:
    """One rank of an n-rank world: times the sharded predictive and, on
    rank 0, writes samples/s to ``workdir/result``."""
    import numpy as np

    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.core.rng import sample_seeds
    from bayestpu_torch.engine import distributed, sharding
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.utils.timing import fenced_window_s

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    distributed.initialize(f"file://{workdir}/rendezvous", n, rank, "gloo")
    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if a["device"] == "cuda" else torch.device("cpu"))
    model = get_model(a["model"], bayes=BayesConfig(rate=0.25), fused=True,
                      dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(a["batch"],) + tuple(model.input_shape)).astype(
            np.float32)).to(dev)
    mesh = sharding.make_mesh(1, n)
    s = sharding.padded_samples(a["samples"], mesh)
    seeds = sample_seeds(0, s, model.num_sites).to(dev)

    def run():
        with torch.no_grad():
            sharding.sharded_predictive(model, x, seeds, mesh)

    run()
    per = [fenced_window_s(run, dev, a["iters"]) / a["iters"]
           for _ in range(3)]
    if rank == 0:
        with open(os.path.join(workdir, "result.tmp"), "w") as f:
            json.dump({"samples_per_s": a["batch"] * s
                       / statistics.median(per)}, f)
        os.replace(os.path.join(workdir, "result.tmp"),
                   os.path.join(workdir, "result"))
    torch.distributed.destroy_process_group()


def measure_at(n: int, a: dict) -> float:
    """Samples/s of an n-rank world; a rank that fails or outlasts
    TIMEOUT_S raises, and every rank is stopped."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_rank, args=(n, r, workdir, a))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(TIMEOUT_S)
            bad = [p.exitcode for p in procs if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"a rank of the {n}-rank world failed "
                                   f"or timed out: exit codes {bad}")
            with open(os.path.join(workdir, "result")) as f:
                return json.load(f)["samples_per_s"]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="vgg11_me")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--ranks", type=int, default=2,
                   help="the largest world; sizes 1, 2, 4, … up to it")
    p.add_argument("--iters", type=int, default=5,
                   help="calls per timing window on every rank")
    p.add_argument("--out", default=None,
                   help="also write the JSON result to this path")
    add_device_arg(p)
    a = p.parse_args(argv)
    cards = torch.cuda.device_count() if a.device == "cuda" else 0
    if a.device == "cuda" and not cards:
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= a.ranks]
    rows, sps1 = [], None
    for n in sizes:
        sps = measure_at(n, vars(a))
        sps1 = sps1 or sps
        rows.append({"devices": n, "samples_per_s": sps,
                     "efficiency": sps / (n * sps1)})
    shared = a.ranks > cards
    out = {"model": a.model, "batch": a.batch, "mc_samples": a.samples,
           "platform": "gpu" if cards else "cpu",
           "device": (torch.cuda.get_device_name(0) if cards else "cpu"),
           "shared_device": shared,
           "label": SHARED if shared else "real multi-device scaling",
           "scaling": rows}
    print(json.dumps(out, indent=2))
    if a.out:
        with open(a.out, "w") as fp:
            json.dump(out, fp, indent=2)
    return out


if __name__ == "__main__":
    main()
