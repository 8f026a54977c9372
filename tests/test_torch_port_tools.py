"""The port's measuring tools against the JAX package's, on the CPU
(``--device cpu``) at a small size (8 frames of 32x32; the trunk at full
width):

- ``experiments/serving_latency.py``: both dtypes at every requested
  batch, the int8 model calibrated once;
- ``experiments/daemon_load.py``: ``run_load`` with the no-op function
  for about 1 s under 2 clients, every response the right slice of its
  request (a wrong slice raises); its JSON keys those of the JAX
  ``experiments.daemon_load.run_load`` on the same no-op run; the
  flagship through the daemon on each wire (float32, uint8 gray, int8);
- ``experiments/int8_accuracy.py``: its metrics equal the JAX script's
  ``_metrics`` (scikit-learn) on seeded logits to 1e-9, with and without
  abstention, with a class absent among 3 and among 4 (the AUROC over
  the present classes); the whole tool on a small trained
  run.
"""

import importlib.util
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest

from protoasnet_tpu_torch import bench, quant
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.experiments import daemon_load, int8_accuracy
from protoasnet_tpu_torch.experiments import serving_latency
from protoasnet_tpu_torch.main import main as train_main
from torch_port_isolation import isolated

_isolated = isolated(2)

REPO = Path(__file__).resolve().parents[1]
SMALL_VIDEO = dict(bench.VIDEO, prototype_shape=(8, 64, 1, 1, 1),
                   img_size=32)
SMALL_CLIP = (8, 32, 32, 3)


def _jax_tool(name):
    """The JAX package's script ``experiments/<name>.py``, loaded by path
    (its imports of JAX and scikit-learn are inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def test_serving_latency_both_dtypes_one_calibration(monkeypatch, capsys):
    monkeypatch.setattr(bench, "VIDEO", SMALL_VIDEO)
    monkeypatch.setattr(bench, "CLIP", SMALL_CLIP)
    monkeypatch.setattr(serving_latency, "CALIB_CLIPS", 2)
    calls = []
    real = quant.calibrate_act_scales

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(quant, "calibrate_act_scales", counted)
    rows = serving_latency.main(["--device", "cpu", "--batches", "1", "3"])
    assert len(calls) == 1
    assert [r["batch"] for r in rows] == [1, 3]
    for r in rows:
        assert set(r) == {"batch", "bf16_ms", "int8_ms",
                          "bf16_clips_per_sec", "int8_clips_per_sec"}
        assert all(math.isfinite(v) and v > 0 for v in r.values())
        assert r["bf16_clips_per_sec"] == pytest.approx(
            r["batch"] / r["bf16_ms"] * 1e3)
    assert _json_lines(capsys.readouterr().out) == rows


def test_daemon_null_run_slices_and_keys_match_jax(capsys):
    rec = daemon_load.run_load(
        daemon_load.null_fn, daemon_load.NULL_SAMPLE, 3, clients=2,
        seconds=1.0, req_batch=4, max_batch=16, max_delay_ms=5.0,
        label="null", expect=daemon_load.null_fn)
    assert _json_lines(capsys.readouterr().out) == [rec]
    assert rec["requests"] > 0 and rec["samples_per_sec"] > 0
    assert rec["clients"] == 2 and rec["req_batch"] == 4
    jax_tool = _jax_tool("daemon_load")
    jax_tool.run_load(lambda x: x[:, 0, 0, :4], (8, 8, 3), 3, 2, 1.0, 4,
                      16, 5.0, "null")
    (jax_rec,) = _json_lines(capsys.readouterr().out)
    assert set(rec) == set(jax_rec)


def test_daemon_wrong_slice_raises():
    with pytest.raises(RuntimeError, match="failed requests"):
        daemon_load.run_load(
            daemon_load.null_fn, daemon_load.NULL_SAMPLE, 3, clients=2,
            seconds=0.5, req_batch=4, max_batch=16, max_delay_ms=5.0,
            label="null", expect=lambda x: daemon_load.null_fn(x)[::-1])


def test_daemon_null_cli():
    rec = daemon_load.main(["--null", "--seconds", "0.5", "--clients", "2"])
    assert rec["mode"] == "null-fn (daemon overhead only)"
    assert rec["requests"] > 0 and rec["max_batch"] == 16


@pytest.mark.parametrize("wire", [[], ["--uint8"], ["--int8"]])
def test_daemon_flagship_on_each_wire(wire):
    rec = daemon_load.main(["--device", "cpu", "--seconds", "1",
                            "--clients", "2", "--req_batch", "1",
                            "--max_batch", "2", "--img_size", "32",
                            "--frames", "8", *wire])
    assert rec["requests"] > 0
    assert rec["mode"].startswith("flagship video, ")
    assert ("uint8-gray" in rec["mode"]) == ("--uint8" in wire)
    assert ("int8 backbone" in rec["mode"]) == ("--int8" in wire)


def _seeded_logits(seed, k, classes):
    rng = np.random.default_rng(seed)
    n = 23
    return rng.normal(size=(n, k)) * 2.0, rng.choice(classes, size=n)


# (logit columns, abstain, classes in the targets, the absent classes'
# logit shift): 4 columns with abstain or 3 without; a class absent among
# 3 (AUROC nan on both sides: scikit-learn's binary path); a class absent
# among 4 (the subset branch, ``probs[:, present]``), whose rows sum to 1
# only when the absent class's probability is ~0 (-50), else nan on both
METRIC_CASES = {
    "all-abstain": (4, True, (0, 1, 2), 0.0),
    "all": (3, False, (0, 1, 2), 0.0),
    "one-absent-abstain": (4, True, (0, 2), 0.0),
    "one-absent": (3, False, (0, 2), 0.0),
    "subset-of-4": (4, False, (0, 1, 3), 0.0),
    "subset-of-4-absent-unlikely": (4, False, (0, 1, 3), -50.0),
}


@pytest.mark.parametrize("case", METRIC_CASES)
def test_int8_metrics_equal_the_jax_sklearn_metrics(case):
    k, abstain, classes, shift = METRIC_CASES[case]
    jax_metrics = _jax_tool("int8_accuracy")._metrics
    absent = [c for c in range(k - abstain) if c not in classes]
    for seed in range(5):
        logits, y = _seeded_logits(seed, k, classes)
        logits[:, absent] += shift
        got = int8_accuracy.metrics("port", logits, y, abstain)
        ref = jax_metrics("jax", logits, y, abstain)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0,
                                   equal_nan=True)
        # AUROC is defined with every class present, and on the subset of
        # 3 present classes when the rows still sum to 1
        defined = len(classes) == k - abstain or shift < 0
        assert np.isnan(got[0]) != defined
        assert not np.isnan(got[1:]).any()


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_run")
    csv = make_synthetic_dataset(str(root / "data"), num_videos=12, seed=3)
    cfg = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
    agent = train_main([
        f"--config_path={cfg}", f"--save_dir={root / 'run'}", "--device",
        "cpu", f"--data.data_info_file={csv}", "--data.img_size=32",
        "--data.frames=8", "--data.eval_batch_size=4",
        "--model.prototype_shape=(8, 64, 1, 1, 1)", "--model.dtype=float32",
        "--train.batch_size=2", "--data.num_workers=1",
        "--train.num_train_epochs=1", "--train.push_start=5"])
    yield agent.save_dir
    shutil.rmtree(root, ignore_errors=True)


def test_int8_accuracy_on_a_trained_run(trained_run, capsys):
    res = int8_accuracy.main(["--run_dir", trained_run, "--device", "cpu",
                              "--calib_batches", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("AUROC fp ") and "logit rel err" in line
    assert res["clips"] > 0
    # the int8 model stays close to the float one (tests/test_quant.py's
    # fidelity limit)
    assert 0 < res["logit_rel_err"] < 0.08
    for m in ("auroc", "bal_acc", "f1"):
        delta = res[f"{m}_int8"] - res[f"{m}_fp"]
        assert res[f"{m}_delta"] == pytest.approx(delta, nan_ok=True)
    assert 0.0 <= res["bal_acc_fp"] <= 1.0
