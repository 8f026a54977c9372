"""Experiment tracking: ``wandb_mode: disabled`` (every shipped config)
appends each metric dict to ``<save_dir>/metrics.jsonl``, one JSON object
a line. Keys follow the JAX package's (``batch_<mode>/...``,
``epoch/<mode>/...``). The wandb sink is not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

__all__ = ["JsonlTracker", "make_tracker"]


class JsonlTracker:
    def __init__(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self.t0 = time.time()

    def log(self, data: Dict[str, Any]) -> None:
        row = {"_t": round(time.time() - self.t0, 3)}
        for k, v in data.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")

    def finish(self) -> None:
        self._f.close()


def make_tracker(config: Dict[str, Any]) -> JsonlTracker:
    mode = config.get("wandb_mode", "disabled")
    if mode != "disabled":
        raise NotImplementedError(f"wandb_mode {mode!r}: the port logs to "
                                  f"metrics.jsonl only (wandb_mode: "
                                  f"disabled)")
    return JsonlTracker(config.get("save_dir", "."))
