"""Accuracy of the w8a8 int8 model against the float one, on a trained run.

    python -m protoasnet_tpu_torch.experiments.int8_accuracy --run_dir <run>
        [--calib_batches 4] [--device cuda|cpu]

The port's counterpart of ``experiments/int8_accuracy.py``, the go/no-go
number of the int8 serving path. It rebuilds a trained run (the port's or
the JAX package's) with ``serve.load_trained_agent``, calibrates the
backbone convs on the first ``--calib_batches`` train batches
(``quant.calibrate_qstate_from_agent``, as ``serve export --int8`` does)
and runs the val split once through both models, batch by batch: the
model's own float forward (bf16 or fp32, as trained) and its
``quant.quantized_model``. It logs each model's weighted one-vs-rest
AUROC, balanced accuracy and macro F1, and prints the JAX script's line:

    AUROC fp A int8 B delta D | bal-acc delta D | F1 delta D | logit rel err E

``main(argv)`` returns those numbers as a dict. The metrics are the JAX
script's ``_metrics`` without scikit-learn (the port's
``train/metrics.py``): the abstain logit stripped and softmax taken again;
AUROC over the classes present, nan where scikit-learn raises (a class
absent, or only two classes present); macro F1 over the classes in the
targets or the predictions. The rows are the val loader's valid ones: the
padding of its last batch, which the JAX script counts, is left out.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from protoasnet_tpu_torch.train.metrics import (balanced_accuracy,
                                                f1_per_class, ovr_auroc)

__all__ = ["main", "metrics"]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _auroc(targets: np.ndarray, probs: np.ndarray) -> float:
    """scikit-learn's ``roc_auc_score(targets, probs[:, present],
    multi_class="ovr", average="weighted", labels=present)`` (all columns
    when every class is present), nan where it raises."""
    present = np.unique(targets)
    if len(present) < probs.shape[1]:
        if len(present) <= 2:  # scikit-learn's binary path takes 1-D scores
            return float("nan")
        probs, labels = probs[:, present], present
    else:
        if probs.shape[1] <= 2:
            return float("nan")
        labels = np.arange(probs.shape[1])
    try:
        return ovr_auroc(targets, probs, labels)
    except ValueError:  # rows of the present classes do not sum to 1
        return float("nan")


def metrics(name: str, logits: np.ndarray, targets: np.ndarray,
            abstain: bool) -> Tuple[float, float, float]:
    """(AUROC, balanced accuracy, macro F1) of ``logits`` against
    ``targets``: the JAX script's ``_metrics``."""
    logits = np.asarray(logits, np.float64)
    targets = np.asarray(targets)
    if abstain:  # the reference's semantics: strip abstain, softmax again
        logits = logits[:, :-1]
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    preds = probs.argmax(axis=1)
    auc = _auroc(targets, probs)
    bacc = balanced_accuracy(targets, preds)
    labels = np.unique(np.concatenate([targets, preds]))
    f1 = float(np.mean(f1_per_class(targets, preds, labels)))
    log(f"{name:>5}: AUROC {auc:.4f}  bal-acc {bacc:.4f}  macro-F1 {f1:.4f}")
    return auc, bacc, f1


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.experiments.int8_accuracy",
        description="float vs w8a8 int8 metrics of a trained run")
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--calib_batches", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    import torch

    from protoasnet_tpu_torch.quant import (calibrate_qstate_from_agent,
                                            quantized_model)
    from protoasnet_tpu_torch.serve import load_trained_agent

    args = _parse(argv)
    agent, _ = load_trained_agent(args.run_dir, args.device)
    log(f"loaded {args.run_dir} at epoch {agent.current_epoch}")
    model = agent.model.eval()
    qstate = calibrate_qstate_from_agent(agent, args.calib_batches)
    qmodel = quantized_model(model, qstate)
    log(f"calibrated {len(qstate)} convs on {args.calib_batches} train "
        f"batches")
    lf, lq, ys = [], [], []
    with torch.inference_mode():
        for batch in agent.data_loaders["val"]:
            valid = np.asarray(batch["valid"], bool)
            x = batch["cine"]
            lf.append(model(x)[0].float().cpu().numpy()[valid])
            lq.append(qmodel(x)[0].float().cpu().numpy()[valid])
            ys.append(np.asarray(batch["target_AS"])[valid])
    lf, lq, ys = np.concatenate(lf), np.concatenate(lq), np.concatenate(ys)
    log(f"val: {len(ys)} clips")
    abstain = agent.abstain_class
    a_fp, b_fp, f_fp = metrics("fp", lf, ys, abstain)
    a_q, b_q, f_q = metrics("int8", lq, ys, abstain)
    rel = float(np.abs(lf - lq).max() / (np.abs(lf).max() + 1e-9))
    print(f"AUROC fp {a_fp:.4f} int8 {a_q:.4f} delta {a_q - a_fp:+.4f} | "
          f"bal-acc delta {b_q - b_fp:+.4f} | F1 delta {f_q - f_fp:+.4f} | "
          f"logit rel err {rel:.4f}", flush=True)
    return {"clips": int(len(ys)), "auroc_fp": a_fp, "auroc_int8": a_q,
            "bal_acc_fp": b_fp, "bal_acc_int8": b_q, "f1_fp": f_fp,
            "f1_int8": f_q, "auroc_delta": a_q - a_fp,
            "bal_acc_delta": b_q - b_fp, "f1_delta": f_q - f_fp,
            "logit_rel_err": rel}


if __name__ == "__main__":
    main(sys.argv[1:])
