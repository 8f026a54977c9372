"""The port's epoch metrics and per-video aggregation (numpy, ``csv``)
against the JAX package's (scikit-learn, pandas) on the same outputs.

Tolerance: 1e-12 (float64 arithmetic in both; AUROC as the rank statistic
here and the trapezoid of the ROC curve there, equal up to rounding).
"""

import numpy as np
import pandas as pd
import pytest

from protoasnet_tpu.train.aggregate import aggregate_predictions as j_agg
from protoasnet_tpu.train.metrics import EpochMetrics as JMetrics
from protoasnet_tpu_torch.train.aggregate import (aggregate_predictions,
                                                  read_csv_columns,
                                                  write_csv)
from protoasnet_tpu_torch.train.metrics import EpochMetrics

P, K = 12, 4


def _batches(rng, n_batches, absent=None, ties=False):
    out = []
    for _ in range(n_batches):
        logits = rng.normal(size=(6, K)).astype(np.float32)
        if ties:
            logits = np.round(logits)
        target = rng.integers(0, K - 1, size=6)
        if absent is not None:
            target[target == absent] = (absent + 1) % (K - 1)
        valid = rng.uniform(size=6) > 0.2
        sims = rng.uniform(size=(6, P)).astype(np.float32)
        terms = {"loss_all": float(rng.uniform()),
                 "loss_CE": float(rng.uniform())}
        out.append((logits, target, valid, sims, terms))
    return out


@pytest.mark.parametrize("case", ["plain", "class_absent", "ties",
                                  "one_sample"])
def test_epoch_metrics_match_jax(case):
    rng = np.random.default_rng(["plain", "class_absent", "ties",
                                 "one_sample"].index(case))
    batches = _batches(rng, 1 if case == "one_sample" else 5,
                       absent=1 if case == "class_absent" else None,
                       ties=case == "ties")
    if case == "one_sample":
        batches[0][2][:] = False
        batches[0][2][0] = True
    kw = dict(num_classes=K, abstain_class=True, num_prototypes=P,
              class_labels=["a", "b", "c"])
    jm, tm = JMetrics(**kw), EpochMetrics(**kw)
    for logits, target, valid, sims, terms in batches:
        js = jm.update(logits, target, valid, similarities=sims,
                       loss_terms=terms)
        ts = tm.update(logits, target, valid, similarities=sims,
                       loss_terms=terms)
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], atol=1e-12, err_msg=k)
    j, t = jm.compute(), tm.compute()
    for k in ("accuracy", "f1_mean", "AUC", "sparsity", "diversity",
              "diversity_abstain"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-12, err_msg=k)
    np.testing.assert_allclose(t["f1"], j["f1"], atol=1e-12)
    np.testing.assert_array_equal(t["confusion_matrix"],
                                  j["confusion_matrix"])
    np.testing.assert_array_equal(t["y_pred"], j["y_pred"])
    assert t["losses"] == pytest.approx(j["losses"], abs=1e-12)
    if case == "class_absent":  # a class without samples weighs 0
        assert 0.0 < t["AUC"] < 1.0


def test_aggregate_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 23
    cols = {"filename": np.array([f"v{i % 7}.npy" for i in
                                  rng.permutation(n)], dtype=object),
            "target_AS": np.zeros(n, np.int64),
            "interval_idx": np.arange(n)}
    for i, f in enumerate(cols["filename"]):
        cols["target_AS"][i] = int(f[1]) % 3
    for name in ("No AS", "Early AS", "Significant AS", "abstain"):
        cols[f"logit_{name}"] = rng.normal(size=n).astype(np.float32)
    path = str(tmp_path / "pred.csv")
    write_csv(path, cols, index=True)
    jdf, jmet = j_agg(pd.read_csv(path), abstain_class=True)
    tcols, tmet = aggregate_predictions(read_csv_columns(path),
                                        abstain_class=True)
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert tmet[k] == pytest.approx(jmet[k], abs=1e-12), k
    for c in jdf.columns:
        if not pd.api.types.is_numeric_dtype(jdf[c]):
            assert list(tcols[c]) == list(jdf[c]), c
        else:
            np.testing.assert_allclose(np.asarray(tcols[c], np.float64),
                                       jdf[c].to_numpy(np.float64),
                                       atol=1e-12, err_msg=c)
    # the CSV the port writes reads back the same through pandas
    pdf = pd.read_csv(path, index_col=0)
    assert list(pdf.columns) == list(cols)
    np.testing.assert_allclose(pdf["logit_abstain"].to_numpy(),
                               cols["logit_abstain"], rtol=1e-7)
