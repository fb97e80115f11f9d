"""Scalar metrics of a training run, one JSON object per line.

The port's copy of ``dm_control_tpu/utils/metrics.py`` (the reference logs
the same train/eval/time scalar groups to TensorBoard,
``scripts/rl/ppo/ppo.py:119-160``).  Each ``write`` appends one row: the
step, the seconds since the writer opened, and the scalars, named
``<group>/<name>`` when a group is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    """Appends scalar rows to a .jsonl file (and optionally stdout)."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl",
                 echo: bool = False):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, filename)
        self._file = open(self._path, "a", buffering=1)
        self._echo = echo
        self._t0 = time.time()

    @property
    def path(self) -> str:
        return self._path

    def write(self, step: int, scalars: Dict[str, float],
              group: Optional[str] = None) -> None:
        row = {"step": int(step),
               "wall_s": round(time.time() - self._t0, 3)}
        prefix = f"{group}/" if group else ""
        for k, v in scalars.items():
            row[prefix + k] = float(v)
        self._file.write(json.dumps(row) + "\n")
        if self._echo:
            print(" ".join(f"{k}={v}" for k, v in row.items()))

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str):
    """Loads a metrics.jsonl file back as a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
