"""The port's experiment trackers against the JAX package's dispatch
(``protoasnet_tpu/tracking/trackers.py``):

- ``wandb_mode: disabled``: both write the same rows to
  ``metrics.jsonl``;
- ``offline`` where ``wandb`` cannot be imported: both fall back to the
  JSONL tracker with the same warning;
- ``offline`` with a stub ``wandb`` module: both make the same ``init``,
  ``define_metric``, ``log`` and ``finish`` calls;
- a JAX run trained with ``wandb_mode: offline`` (its ``config_agent.yml``
  says so) is exported by the port's ``serve export --run_dir`` with the
  JAX forward's logits.
"""

import json
import logging
import shutil
import sys
import types

import numpy as np
import pytest
import yaml

from protoasnet_tpu.tracking.trackers import make_tracker as jax_make_tracker
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.serve import load_serving_bundle
from protoasnet_tpu_torch.serve import main as serve_main
from protoasnet_tpu_torch.tracking.trackers import make_tracker
from tests.test_torch_port_checkpoint_jax import (_jax_logits, _mark_trained,
                                                  agent_config, sample_batch)

FACTORIES = {"jax": jax_make_tracker, "port": make_tracker}
ROW = {"batch_train/step": 3, "batch_train/loss_all": np.float32(0.25),
       "epoch/val/f1_mean": 0.5, "note": "text"}


def _config(tmp_path, who, mode):
    return {"wandb_mode": mode, "save_dir": str(tmp_path / who),
            "run_name": "r", "train": {"batch_size": 2}}


def _rows(path):
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for r in rows:
        assert r.pop("_t") >= 0
    return rows


def test_disabled_writes_the_same_jsonl(tmp_path):
    kinds = {}
    for who, factory in FACTORIES.items():
        tracker = factory(_config(tmp_path, who, "disabled"))
        kinds[who] = type(tracker).__name__
        tracker.log(ROW)
        tracker.log({"epoch": 1})
        tracker.finish()
    assert kinds == {"jax": "JsonlTracker", "port": "JsonlTracker"}
    jax_rows = _rows(tmp_path / "jax" / "metrics.jsonl")
    assert jax_rows == _rows(tmp_path / "port" / "metrics.jsonl")
    assert jax_rows[0]["note"] == "text" and jax_rows[1] == {"epoch": 1.0}


def test_offline_without_wandb_falls_back_with_the_same_warning(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    kinds, warnings = {}, {}
    for who, factory in FACTORIES.items():
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            tracker = factory(_config(tmp_path, who, "offline"))
        kinds[who] = type(tracker).__name__
        warnings[who] = [r.getMessage() for r in caplog.records
                         if r.levelno == logging.WARNING]
        tracker.log(ROW)
        tracker.finish()
    assert kinds == {"jax": "JsonlTracker", "port": "JsonlTracker"}
    assert warnings["jax"] == warnings["port"] == [
        "wandb not installed; falling back to JSONL tracker"]
    assert _rows(tmp_path / "jax" / "metrics.jsonl") == \
        _rows(tmp_path / "port" / "metrics.jsonl")


def _stub_wandb(calls):
    stub = types.ModuleType("wandb")
    for name in ("init", "define_metric", "log", "finish"):
        def record(*args, _name=name, **kwargs):
            calls.append((_name, args, kwargs))
        setattr(stub, name, record)
    return stub


@pytest.mark.parametrize("mode", ["offline", "online"])
def test_wandb_stub_gets_the_same_calls(tmp_path, monkeypatch, mode):
    calls, kinds = {}, {}
    for who, factory in FACTORIES.items():
        calls[who] = []
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls[who]))
        cfg = _config(tmp_path, "run", mode)  # the same dir for both
        tracker = factory(cfg)
        kinds[who] = type(tracker).__name__
        tracker.log(ROW)
        tracker.finish()
    assert kinds == {"jax": "WandbTracker", "port": "WandbTracker"}
    assert calls["jax"] == calls["port"]
    names = [c[0] for c in calls["port"]]
    assert names[0] == "init" and names[-2:] == ["log", "finish"]
    assert names.count("define_metric") == 21
    init_kwargs = calls["port"][0][2]
    assert init_kwargs["mode"] == mode and init_kwargs["name"] == "r"


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  num_videos=12, seed=3)


def test_offline_jax_run_exports_through_the_port(csv, tmp_path,
                                                  monkeypatch):
    from protoasnet_tpu.train.agents import build_agent as jax_build_agent

    monkeypatch.setitem(sys.modules, "wandb", None)
    name = "Video_XProtoNet_e2e"
    run = tmp_path / "jax_run"
    jax_agent = jax_build_agent(agent_config(name, csv, str(run),
                                             "--wandb_mode=offline"))
    _mark_trained(jax_agent, name)
    jax_agent.save_checkpoint()
    with open(run / "config_agent.yml") as f:
        assert yaml.safe_load(f)["wandb_mode"] == "offline"
    out = str(tmp_path / "b.zip")
    serve_main(["export", "--run_dir", str(run), "--out", out,
                "--device", "cpu"])
    x = sample_batch(name, 6, n=3)[0].astype(np.float32)
    got = load_serving_bundle(out, device="cpu")(x)
    ref = _jax_logits(jax_agent, x)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-6
    shutil.rmtree(tmp_path, ignore_errors=True)

