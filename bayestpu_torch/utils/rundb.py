"""Run database: per-run config + metrics + stdout capture.

≙ the reference's sacred ``FileStorageObserver`` → ``runs_db/`` (run config
+ captured stdout per numbered run, ``Software_Artifact/software/main.py:
10-13`` with ``CAPTURE_MODE='sys'``) and its flat-file metric logs
(``log_<id>.txt``, ``evaluate.py:24-31``). No sacred dependency: a run is a
numbered directory with ``config.json``, ``metrics.jsonl``, ``log.txt``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import io
import json
import os
import sys
import time
from typing import Any

DEFAULT_RUNS_DIR = os.environ.get("BAYESTPU_RUNS_DIR", "runs_db")


def _jsonable(obj: Any):
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if isinstance(obj, enum.Enum):
        return obj.value
    return str(obj)


class Run:
    """One experiment run directory."""

    def __init__(self, runs_dir: str = DEFAULT_RUNS_DIR,
                 config: Any = None, name: str = ""):
        os.makedirs(runs_dir, exist_ok=True)
        existing = [int(d) for d in os.listdir(runs_dir) if d.isdigit()]
        self.run_id = max(existing, default=0) + 1
        self.dir = os.path.join(runs_dir, str(self.run_id))
        os.makedirs(self.dir)
        self._metrics = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        meta = {"run_id": self.run_id, "name": name,
                "started": time.strftime("%Y-%m-%dT%H:%M:%S")}
        if config is not None:
            meta["config"] = json.loads(
                json.dumps(config, default=_jsonable))
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(meta, f, indent=2)

    def log_metrics(self, step: int, **metrics: float) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in metrics.items()}}
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()

    def log_text(self, text: str) -> None:
        with open(os.path.join(self.dir, "log.txt"), "a") as f:
            f.write(text.rstrip() + "\n")

    @contextlib.contextmanager
    def capture_stdout(self):
        """Tee stdout into the run log (sacred CAPTURE_MODE='sys')."""
        buf = io.StringIO()
        orig = sys.stdout

        class Tee(io.TextIOBase):
            def write(_, s):
                orig.write(s)
                buf.write(s)
                return len(s)

            def flush(_):
                orig.flush()

        sys.stdout = Tee()
        try:
            yield
        finally:
            sys.stdout = orig
            self.log_text(buf.getvalue())

    def close(self) -> None:
        self._metrics.close()
