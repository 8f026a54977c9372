"""Epoch metrics in numpy (the JAX package's ``train/metrics.py`` without
scikit-learn).

* balanced accuracy, per-class and mean F1 (zero where undefined),
  support-weighted one-vs-rest AUROC (0 where it is undefined), confusion
  matrix, a per-class text report;
* the abstain logit is stripped before the eval softmax;
* sparsity at a level: mean number of prototypes whose sorted, normalised
  similarity cumsum reaches the level (0.8);
* diversity: prototypes in the top-k similarity ranks of more than
  ``threshold`` of the samples (top-5 of the class prototypes, top-2 of the
  abstain prototypes).

Each function of the first item gives the numbers scikit-learn's
``balanced_accuracy_score``, ``f1_score``, ``roc_auc_score`` (weighted
OVR) and ``confusion_matrix`` give; the CPU tests hold them against it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["sparsity_count", "confusion", "balanced_accuracy",
           "f1_per_class", "binary_auroc", "ovr_auroc", "EpochMetrics"]


def sparsity_count(similarities: np.ndarray, level: float = 0.8
                   ) -> np.ndarray:
    """Per-sample count of top prototypes explaining ``level`` of the
    similarity mass."""
    sims = np.asarray(similarities, dtype=np.float64)
    norm = sims / np.maximum(sims.sum(axis=1, keepdims=True), 1e-12)
    srt = -np.sort(-norm, axis=1)
    return (np.cumsum(srt, axis=1) >= level).argmax(axis=1)


def confusion(y_true: np.ndarray, y_pred: np.ndarray,
              labels: Sequence[int]) -> np.ndarray:
    """(K, K) counts of (true, predicted) over ``labels``; pairs with a
    value outside ``labels`` are not counted."""
    k = len(labels)
    pos = {int(lab): i for i, lab in enumerate(labels)}
    cm = np.zeros((k, k), dtype=np.int64)
    for t, p in zip(np.asarray(y_true).tolist(),
                    np.asarray(y_pred).tolist()):
        if t in pos and p in pos:
            cm[pos[t], pos[p]] += 1
    return cm


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean recall over the classes present in ``y_true``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    classes = np.unique(y_true)
    return float(np.mean([np.mean(y_pred[y_true == c] == c)
                          for c in classes])) if len(classes) else 0.0


def f1_per_class(y_true: np.ndarray, y_pred: np.ndarray,
                 labels: Sequence[int]) -> np.ndarray:
    """F1 of each label, 0 where precision and recall are both undefined
    (scikit-learn's ``zero_division=0``)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    out = np.zeros(len(labels))
    for i, c in enumerate(labels):
        tp = np.sum((y_true == c) & (y_pred == c))
        denom = np.sum(y_true == c) + np.sum(y_pred == c)
        out[i] = 2.0 * tp / denom if denom else 0.0
    return out


def binary_auroc(positive: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of ``score`` for boolean ``positive`` (the
    Mann-Whitney statistic, ties counted half); nan when only one class is
    present."""
    positive = np.asarray(positive, bool)
    score = np.asarray(score, np.float64)
    n_pos, n_neg = int(positive.sum()), int((~positive).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score), np.float64)
    srt = score[order]
    i = 0
    while i < len(srt):  # average ranks over ties
        j = i
        while j + 1 < len(srt) and srt[j + 1] == srt[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def ovr_auroc(y_true: np.ndarray, y_prob: np.ndarray,
              labels: Sequence[int]) -> float:
    """Support-weighted one-vs-rest AUROC over ``labels``, as scikit-learn
    1.9's ``roc_auc_score(multi_class="ovr", average="weighted")``: a label
    without samples weighs 0; nan when a label holds every sample;
    ValueError for rows that do not sum to 1 or a target outside
    ``labels``."""
    y_true = np.asarray(y_true)
    y_prob = np.asarray(y_prob, np.float64)
    if y_prob.ndim != 2 or y_prob.shape[1] != len(labels):
        raise ValueError("y_prob columns do not match the labels")
    if not np.allclose(1.0, y_prob.sum(axis=1)):
        raise ValueError("scores are not probabilities")
    if np.setdiff1d(y_true, labels).size:
        raise ValueError("y_true has labels outside the given labels")
    weights = np.array([np.sum(y_true == c) for c in labels], np.float64)
    if np.isclose(weights.sum(), 0.0):
        return 0.0
    aucs = np.array([binary_auroc(y_true == c, y_prob[:, i])
                     if weights[i] else 0.0 for i, c in enumerate(labels)])
    return float(np.average(aucs, weights=weights))


def _report(y_true: np.ndarray, y_pred: np.ndarray, labels: Sequence[int],
            names: Sequence[str]) -> str:
    """Per-class precision, recall, F1 and support as text."""
    rows = [f"{'':>16} precision    recall  f1-score   support"]
    f1 = f1_per_class(y_true, y_pred, labels)
    for i, c in enumerate(labels):
        tp = np.sum((y_true == c) & (y_pred == c))
        npred, ntrue = np.sum(y_pred == c), np.sum(y_true == c)
        prec = tp / npred if npred else 0.0
        rec = tp / ntrue if ntrue else 0.0
        rows.append(f"{names[i]:>16} {prec:9.2f} {rec:9.2f} {f1[i]:9.2f} "
                    f"{ntrue:9d}")
    return "\n".join(rows)


class EpochMetrics:
    """Accumulates per-batch outputs; computes the epoch summary."""

    def __init__(self, num_classes: int, abstain_class: bool,
                 num_prototypes: int,
                 class_labels: Optional[List[str]] = None,
                 sparsity_level: float = 0.8, diversity_topk: int = 5,
                 diversity_topk_abstain: int = 2,
                 diversity_threshold: float = 0.05):
        self.num_classes = num_classes  # logits (with abstain, if any)
        self.abstain_class = abstain_class
        self.eval_classes = num_classes - 1 if abstain_class else num_classes
        self.class_labels = class_labels or [str(i) for i in
                                             range(self.eval_classes)]
        self.num_prototypes = num_prototypes
        self.n_class_protos = (num_prototypes // num_classes
                               * self.eval_classes if abstain_class
                               else num_prototypes)
        self.sparsity_level = sparsity_level
        self.div_topk = diversity_topk
        self.div_topk_ab = diversity_topk_abstain
        self.div_threshold = diversity_threshold
        self.reset()

    def reset(self):
        self.y_true: List[np.ndarray] = []
        self.y_prob: List[np.ndarray] = []
        self.loss_sums: Dict[str, float] = {}
        self.n_batches = 0
        self.sparsity_sum = 0.0
        self.sparsity_n = 0
        self.count_array = np.zeros(self.num_prototypes)
        self.simscore_cumsum = np.zeros(self.num_prototypes)

    @staticmethod
    def _softmax(x: np.ndarray) -> np.ndarray:
        e = np.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def update(self, logits, target, valid=None, similarities=None,
               loss_terms: Optional[Dict[str, float]] = None
               ) -> Dict[str, float]:
        """Accumulate one batch; returns per-batch stats for logging."""
        logits = np.asarray(logits).astype(np.float32)
        target = np.asarray(target)
        if similarities is not None:
            similarities = np.asarray(similarities).astype(np.float32)
        if valid is not None:
            v = np.asarray(valid).astype(bool)
            logits, target = logits[v], target[v]
            similarities = None if similarities is None else similarities[v]
        probs = self._softmax(logits[:, :self.eval_classes]
                              if self.abstain_class else logits)
        self.y_true.append(target)
        self.y_prob.append(probs)
        for k, val in (loss_terms or {}).items():
            self.loss_sums[k] = self.loss_sums.get(k, 0.0) + float(val)
        self.n_batches += 1

        stats: Dict[str, float] = {}
        if similarities is not None and len(similarities):
            counts = sparsity_count(similarities, self.sparsity_level)
            self.sparsity_sum += counts.sum()
            self.sparsity_n += len(counts)
            stats["sparsity"] = float(counts.mean())
            nc = self.n_class_protos
            order = np.argsort(-similarities[:, :nc], axis=1
                               )[:, :self.div_topk]
            np.add.at(self.count_array[:nc], order.reshape(-1), 1)
            if self.abstain_class and nc < self.num_prototypes:
                order_ab = np.argsort(-similarities[:, nc:], axis=1
                                      )[:, :self.div_topk_ab]
                np.add.at(self.count_array[nc:], order_ab.reshape(-1), 1)
            self.simscore_cumsum += similarities.sum(axis=0)
        if len(target):
            pred = probs.argmax(axis=1)
            stats["accuracy"] = balanced_accuracy(target, pred)
            stats["f1_mean"] = float(f1_per_class(
                target, pred, range(self.eval_classes)).mean())
        return stats

    def compute(self) -> Dict[str, object]:
        y_true = (np.concatenate(self.y_true) if self.y_true
                  else np.zeros(0, np.int32))
        y_prob = (np.concatenate(self.y_prob) if self.y_prob
                  else np.zeros((0, self.eval_classes)))
        y_pred = (y_prob.argmax(axis=1) if len(y_prob)
                  else np.zeros(0, np.int64))
        labels = list(range(self.eval_classes))
        accu = balanced_accuracy(y_true, y_pred) if len(y_true) else 0.0
        f1 = (f1_per_class(y_true, y_pred, labels) if len(y_true)
              else np.zeros(self.eval_classes))
        try:
            auc = ovr_auroc(y_true, y_prob, labels)
            if not np.isfinite(auc):
                auc = 0.0
        except ValueError:
            auc = 0.0
        n = max(len(y_true), 1)
        nc = self.n_class_protos
        out: Dict[str, object] = {
            "accuracy": float(accu),
            "f1": f1,
            "f1_mean": float(f1.mean()),
            "AUC": float(auc),
            "confusion_matrix": confusion(y_true, y_pred, labels),
            "sparsity": (self.sparsity_sum / self.sparsity_n
                         if self.sparsity_n else 0.0),
            "diversity": int(np.sum(self.count_array[:nc]
                                    > self.div_threshold * n)),
            "diversity_abstain": (
                int(np.sum(self.count_array[nc:] > self.div_threshold * n))
                if self.abstain_class else 0),
            "losses": {k: v / max(self.n_batches, 1)
                       for k, v in self.loss_sums.items()},
            "y_true": y_true,
            "y_prob": y_prob,
            "y_pred": y_pred,
        }
        if len(y_true):
            out["report"] = _report(y_true, y_pred, labels,
                                    self.class_labels)
        return out
