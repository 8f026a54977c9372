"""Experiment tracking, with the JAX package's dispatch
(``protoasnet_tpu/tracking/trackers.py``):

* ``wandb_mode: disabled`` (every shipped config) appends each metric
  dict to ``<save_dir>/metrics.jsonl``, one JSON object a line;
* any other mode (``online``, ``offline``) logs to wandb when the
  ``wandb`` package is importable, and otherwise falls back to the JSONL
  file with a warning, so a run trained with ``--wandb_mode=offline``
  still rebuilds (export, explain, serving) where wandb is absent.

Keys follow the JAX package's (``batch_<mode>/...``, ``epoch/<mode>/...``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

from protoasnet_tpu_torch.parallel.mesh import is_main

__all__ = ["Tracker", "NullTracker", "JsonlTracker", "WandbTracker",
           "make_tracker"]

_MODES = ("train", "val", "val_push", "test")


class Tracker:
    def log(self, data: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def finish(self) -> None:
        pass


class NullTracker(Tracker):
    """Logs nothing: the tracker of a rank other than 0."""

    def log(self, data: Dict[str, Any]) -> None:
        pass


class JsonlTracker(Tracker):
    def __init__(self, save_dir: str, run_name: str = ""):
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


class WandbTracker(Tracker):
    """wandb's run, with the JAX package's per-mode step axes and min/max
    summaries. Raises ImportError where ``wandb`` is not installed."""

    def __init__(self, save_dir: str, run_name: str, mode: str,
                 config: Dict):
        import wandb

        self._wandb = wandb
        wandb.init(project="ProtoASNet-TPU", name=run_name, mode=mode,
                   dir=save_dir, config=config)
        for m in _MODES:
            wandb.define_metric(f"batch_{m}/step")
            wandb.define_metric(f"batch_{m}/*", step_metric=f"batch_{m}/step")
        wandb.define_metric("epoch")
        for m in _MODES:
            wandb.define_metric(f"epoch/{m}/f1_mean", step_metric="epoch",
                                summary="max")
            wandb.define_metric(f"epoch/{m}/AUC_mean", step_metric="epoch",
                                summary="max")
            wandb.define_metric(f"epoch/{m}/loss_all", step_metric="epoch",
                                summary="min")

    def log(self, data: Dict[str, Any]) -> None:
        self._wandb.log(data)

    def finish(self) -> None:
        self._wandb.finish()


def make_tracker(config: Dict[str, Any]) -> Tracker:
    """The config's tracker; a ``NullTracker`` on a rank other than 0 of a
    data-parallel run (``parallel/mesh.py``), so rank 0 alone writes."""
    if not is_main():
        return NullTracker()
    mode = config.get("wandb_mode", "disabled")
    save_dir = config.get("save_dir", ".")
    run_name = config.get("run_name", "run")
    if mode == "disabled":
        return JsonlTracker(save_dir, run_name)
    try:
        return WandbTracker(save_dir, run_name, mode, config)
    except ImportError:
        logging.warning("wandb not installed; falling back to JSONL tracker")
        return JsonlTracker(save_dir, run_name)
