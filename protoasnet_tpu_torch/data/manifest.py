"""CSV manifest of echo cine loops (the JAX package's ``data/manifest.py``,
read with the ``csv`` module instead of pandas).

Columns: ``path, view, split, as_label, frames, frame_time, heart_rate``.
``as_label`` is an integer class id into CLASS_LABELS (the model appends
the learned abstain class; it is not in the data).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from protoasnet_tpu_torch.data.intervals import (IntervalTable,
                                                 compute_intervals)

CLASS_LABELS = ["No AS", "Early AS", "Significant AS"]

__all__ = ["Manifest", "CLASS_LABELS"]

_REQUIRED = ["path", "view", "split", "as_label", "frames", "frame_time",
             "heart_rate"]
_INT = ("as_label", "frames")
_FLOAT = ("frame_time", "heart_rate")


def _read_columns(path: str) -> Dict[str, np.ndarray]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        fields = reader.fieldnames or []
        missing = [c for c in _REQUIRED if c not in fields]
        if missing:
            raise ValueError(f"Manifest {path} missing columns: {missing}")
        rows = list(reader)
    cols: Dict[str, np.ndarray] = {}
    for c in fields:
        vals = [r[c] for r in rows]
        if c in _INT:
            cols[c] = np.array([int(float(v)) for v in vals], np.int64)
        elif c in _FLOAT:
            cols[c] = np.array([float(v) for v in vals], np.float64)
        else:
            cols[c] = np.array(vals, dtype=object)
    return cols


@dataclass
class Manifest:
    """Filtered view of the dataset CSV (columns as numpy arrays) plus its
    interval metadata."""

    columns: Dict[str, np.ndarray]
    window_size: np.ndarray  # (V,) frames per window
    num_intervals: np.ndarray
    intervals: IntervalTable

    @classmethod
    def from_csv(cls, data_info_file: str, view: str = "plax",
                 split: str = "train", sample_size: Optional[int] = None,
                 interval_unit: str = "cycle", interval_quant: float = 1.0,
                 seed: int = 0) -> "Manifest":
        cols = _read_columns(data_info_file)
        keep = np.ones(len(cols["path"]), bool)
        if view in ("plax", "psax"):
            keep &= cols["view"] == view
        elif view != "all":
            raise ValueError(f"View should be plax/psax/all, got {view}")
        if split in ("train", "val", "test"):
            keep &= cols["split"] == split
        elif split != "all":
            raise ValueError(f"Split should be train/val/test/all, got "
                             f"{split}")
        idx = np.flatnonzero(keep)
        if sample_size is not None:
            # pandas' DataFrame.sample(n, random_state=seed)
            pick = np.random.RandomState(seed).choice(
                len(idx), size=int(sample_size), replace=False)
            idx = idx[pick]
        cols = {k: v[idx] for k, v in cols.items()}
        window, n_int, table = compute_intervals(
            cols["frames"], cols["frame_time"], cols["heart_rate"],
            interval_unit, interval_quant)
        return cls(cols, window, n_int, table)

    def __len__(self) -> int:
        return len(self.columns["path"])

    @property
    def labels(self) -> np.ndarray:
        return self.columns["as_label"].astype(np.int32)

    @property
    def paths(self) -> np.ndarray:
        return self.columns["path"]

    @property
    def filenames(self) -> np.ndarray:
        return np.array([os.path.basename(p) for p in self.columns["path"]])

    @property
    def frames(self) -> np.ndarray:
        return self.columns["frames"].astype(np.int64)

    def class_sample_weights(self) -> np.ndarray:
        """Inverse-frequency weight per row for AS-balanced sampling."""
        labels = self.labels
        counts = np.bincount(labels, minlength=int(labels.max()) + 1
                             ).astype(np.float64)
        weights = np.zeros_like(counts)
        nz = counts > 0
        weights[nz] = 1.0 / counts[nz]
        return weights[labels]
