"""The readings that a cell's limits are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--controls control]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load, the program's compared numbers (the lower readings), then
each named control in the program's place on the same requests or steps:
``control``, the reference at the precision below the configuration's,
and for a training cell the faults its driver plants (``check``'s
``control`` argument). One JSON line a seed; the last line holds, for each
number, the largest program reading and the smallest reading of each
control. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, seeds, seconds: float, controls, device) -> dict:
    """{"runs": [...], "program_max": {...}, "<control>_min": {...}}."""
    driver = cell.driver
    runs = []
    for seed in seeds:
        st = driver.setup(cell, seed, device)
        rec = driver.window(st, seconds, False)
        driver.release(st)
        t = time.perf_counter()
        row = {"seed": seed, "attempted": rec.attempted,
               "program": driver.check(st, rec)}
        row["check_s"] = time.perf_counter() - t
        for c in controls:
            row[c] = driver.check(st, rec, control=c)
        runs.append(row)
        print(json.dumps(row), flush=True)
    out = {"runs": runs,
           "program_max": {k: max(r["program"][k] for r in runs)
                           for k in runs[0]["program"]}}
    for c in controls:
        out[c + "_min"] = {k: min(r[c][k] for r in runs)
                           for k in runs[0][c]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", default="control")
    args = ap.parse_args()

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    out = readings(cell, [int(s) for s in args.seeds.split(",")],
                   args.seconds, [c for c in args.controls.split(",") if c],
                   torch.device("cuda", 0))
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
