"""The benchmark of ``bayestpu_torch`` on one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It makes the weights and inputs from ``--seed`` on the card,
sets the program up (the first run in a checkout builds its kernels under
``build/``), measures ``--seconds`` of the cell's traffic, judges what the
window produced against the plain reference, and prints one JSON line last
on standard output: the end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``), ``correct`` with each compared number
beside its limit under ``checks``. It exits nonzero, printing no result,
without the cards, outside a checkout, or when JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches at fixed paths inside the checkout, so that only a checkout's
# first run builds
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "bayestpu_torch").is_dir():
        print("no bayestpu_torch beside perfbench/: run from a checkout",
              file=sys.stderr)
        return 2

    import torch

    from perfbench import harness

    torch.set_num_threads(1)
    cell = harness.load_cell(ROOT, args.workload)
    chips = cell.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
