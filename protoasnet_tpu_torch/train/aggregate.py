"""Per-video aggregation of the per-interval prediction log (the JAX
package's ``train/aggregate.py`` with the ``csv`` module and numpy
instead of pandas and scikit-learn).

Eval scores every interval of every video; the per-video prediction is the
mean softmax probability over a video's intervals (abstain logit
stripped), its argmax the video's class, and the video-level metrics follow
from those.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Tuple, Union

import numpy as np

from protoasnet_tpu_torch.train.metrics import (balanced_accuracy,
                                                f1_per_class, ovr_auroc)

__all__ = ["aggregate_predictions", "read_csv_columns", "write_csv"]

Columns = Dict[str, np.ndarray]


def read_csv_columns(path: str) -> Columns:
    """A CSV as {column: array}; numeric columns as float64."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols: Columns = {}
    for name in (rows[0].keys() if rows else ()):
        vals = [r[name] for r in rows]
        try:
            cols[name] = np.array([float(v) for v in vals])
        except ValueError:
            cols[name] = np.array(vals, dtype=object)
    return cols


def write_csv(path: str, columns: Columns, index: bool = False) -> None:
    """Write {column: array} as CSV (a leading unnamed 0..N-1 index column
    with ``index``, as pandas writes one)."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + names)
        for i in range(n):
            row = [_cell(columns[c][i]) for c in names]
            w.writerow(([i] if index else []) + row)


def _cell(v):
    if isinstance(v, (np.floating, float)):
        return float(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    return v


def aggregate_predictions(csv_or_columns: Union[str, Columns],
                          abstain_class: bool = False
                          ) -> Tuple[Columns, dict]:
    """(per-video columns sorted by filename, metrics dict). Expects the
    prediction-log columns filename, target_AS and logit_<name>..."""
    cols = (read_csv_columns(csv_or_columns)
            if isinstance(csv_or_columns, str) else csv_or_columns)
    logit_cols = [c for c in cols if c.startswith("logit_")]
    if abstain_class or (logit_cols and logit_cols[-1] == "logit_abstain"):
        class_cols = [c for c in logit_cols if c != "logit_abstain"]
    else:
        class_cols = logit_cols
    logits = np.stack([np.asarray(cols[c], np.float64) for c in class_cols],
                      axis=1)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    prob_cols: List[str] = [c.replace("logit_", "prob_") for c in class_cols]

    names = np.asarray(cols["filename"]).astype(str)
    videos = np.unique(names)  # sorted, as pandas' groupby
    target = np.asarray(cols["target_AS"])
    out: Columns = {"filename": videos,
                    "target_AS": np.array([target[names == v][0]
                                           for v in videos]),
                    "n_intervals": np.array([np.sum(names == v)
                                             for v in videos])}
    video_probs = np.array([probs[names == v].mean(axis=0) for v in videos]
                           ).reshape(len(videos), len(class_cols))
    for i, c in enumerate(prob_cols):
        out[c] = video_probs[:, i]
    out["pred_AS"] = video_probs.argmax(axis=1)

    y = out["target_AS"].astype(np.int64)
    pred = out["pred_AS"]
    labels = list(range(len(prob_cols)))
    metrics = {"n_videos": len(videos),
               "balanced_accuracy": balanced_accuracy(y, pred),
               "f1_mean": float(f1_per_class(y, pred, labels).mean())}
    try:
        auc = ovr_auroc(y, video_probs, labels)
        metrics["AUC"] = float(auc) if np.isfinite(auc) else 0.0
    except ValueError:
        metrics["AUC"] = 0.0
    return out, metrics
