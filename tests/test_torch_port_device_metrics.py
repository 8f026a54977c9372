"""On-device epoch metrics and the epoch loop's instrumentation in the
port, against the JAX package.

- ``train/device_metrics.py::DeviceEpochBuffer`` fed the same per-step
  arrays as the JAX package's (seeded numpy; three steps of 4 samples,
  with and without a padded last batch whose extra rows are not valid)
  gives the same ``finalize`` loss terms and ``EpochMetrics.compute()``,
  to 1e-6.
- The agent's ``run_epoch`` (video XProtoNet at 8 frames of 32x32, P=8,
  D=64, fp32, on the synthetic fixture) gives the same epoch metrics with
  ``train.on_device_metrics`` true and false (``rtol=1e-5, atol=1e-6``, as
  ``tests/test_agents.py`` holds the JAX package), for a training and a
  validation epoch; the device path logs no per-batch tracker rows; test
  and val_push keep the host path and still write their CSVs.
- ``profile_dir`` (or ``PROTOASNET_PROFILE_DIR``) writes one loadable
  trace at ``profile_epoch`` of a training epoch and none otherwise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.train.device_metrics import \
    DeviceEpochBuffer as JaxBuffer
from protoasnet_tpu.train.metrics import EpochMetrics as JaxMetrics
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.train.agents import build_agent
from protoasnet_tpu_torch.train.device_metrics import DeviceEpochBuffer
from protoasnet_tpu_torch.train.metrics import EpochMetrics
from protoasnet_tpu_torch.utils.config import updated_config
from torch_port_isolation import isolated

K, P, B, STEPS = 4, 8, 4, 3
LOSSES = ("loss_all", "loss_ce", "loss_cluster")
SCALARS = ("accuracy", "f1_mean", "AUC", "sparsity", "diversity",
           "diversity_abstain")


_isolated = isolated(2)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "protoasnet_tpu", "configs",
    "ours_protoasnet_video.yml")


def _steps(padded: bool):
    rng = np.random.default_rng(5)
    out = []
    for i in range(STEPS):
        valid = np.ones(B, bool)
        if padded and i == STEPS - 1:
            valid[2:] = False
        out.append(dict(
            logits=rng.normal(size=(B, K)).astype(np.float32),
            similarities=rng.uniform(size=(B, P)).astype(np.float32),
            target=rng.integers(0, K - 1, size=B).astype(np.int32),
            valid=valid,
            **{k: np.float32(rng.uniform(0.1, 2.0)) for k in LOSSES}))
    return out


def _metrics(cls):
    return cls(num_classes=K, abstain_class=True, num_prototypes=P)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_buffer_matches_the_jax_buffer(padded):
    steps = _steps(padded)
    jbuf = JaxBuffer(STEPS, B, K, P, LOSSES)
    tbuf = DeviceEpochBuffer(STEPS, B, K, P, LOSSES, device="cpu")
    for s in steps:
        jbuf.update({k: jnp.asarray(v) for k, v in s.items()},
                    jnp.asarray(s["target"]), jnp.asarray(s["valid"]))
        tbuf.update({k: torch.as_tensor(v) for k, v in s.items()},
                    torch.from_numpy(s["target"]).long(),
                    torch.from_numpy(s["valid"]))
    jm, tm = _metrics(JaxMetrics), _metrics(EpochMetrics)
    jl, tl = jbuf.finalize(jm), tbuf.finalize(tm)
    assert set(jl) == set(tl) == set(LOSSES)
    for k in LOSSES:
        assert tl[k] == pytest.approx(jl[k], rel=1e-6, abs=1e-6), k
    js, ts = jm.compute(), tm.compute()
    for k in SCALARS:
        assert ts[k] == pytest.approx(js[k], rel=1e-6, abs=1e-6), k
    for k in LOSSES:
        assert ts["losses"][k] == pytest.approx(js["losses"][k], rel=1e-6)
    np.testing.assert_array_equal(ts["confusion_matrix"],
                                  js["confusion_matrix"])
    assert len(ts["y_true"]) == STEPS * B - (2 if padded else 0)


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_metrics")
    return make_synthetic_dataset(str(root / "data"), num_videos=12, seed=3)


def _agent(csv, save_dir, *extra):
    cfg = updated_config([
        f"--config_path={CONFIG}", f"--save_dir={save_dir}", "--device",
        "cpu", f"--data.data_info_file={csv}", "--data.img_size=32",
        "--data.frames=8", "--data.eval_batch_size=4",
        "--data.num_workers=1", "--model.prototype_shape=(8, 64, 1, 1, 1)",
        "--model.dtype=float32", "--train.batch_size=2",
        "--train.accumulation_steps=2", "--train.auto_resume=false",
        *extra])
    cfg["save_dir"] = str(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    return build_agent(cfg)


def _rows(agent):
    path = os.path.join(agent.save_dir, "metrics.jsonl")
    return [json.loads(line) for line in open(path).read().splitlines()]


@pytest.mark.parametrize("mode", ["train", "val"])
def test_epoch_metrics_agree_on_both_paths(csv, tmp_path, mode):
    res = {}
    for on_device in (False, True):
        agent = _agent(csv, tmp_path / str(on_device),
                       f"--train.on_device_metrics={str(on_device).lower()}")
        res[on_device] = agent.run_epoch(0, mode=mode)
        agent.finalize()
        per_batch = [r for r in _rows(agent)
                     if any(k.startswith(f"batch_{mode}/") for k in r)]
        epoch = [r for r in _rows(agent) if f"epoch/{mode}/loss_all" in r]
        assert len(epoch) == 1
        assert bool(per_batch) != on_device  # no per-batch rows on device
    np.testing.assert_allclose(res[False], res[True], rtol=1e-5, atol=1e-6)


def test_test_and_val_push_keep_the_host_path(csv, tmp_path):
    agent = _agent(csv, tmp_path, "--train.on_device_metrics=true")
    for mode in ("test", "val_push"):
        agent.run_epoch(0, mode=mode)
        out = os.path.join(agent.save_dir, f"csv_{mode}")
        assert any(f.endswith("_video_level.csv") for f in os.listdir(out))
        assert any(k.startswith(f"batch_{mode}/")
                   for r in _rows(agent) for k in r)
    agent.finalize()


def _traces(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pt.trace.json")) \
        if os.path.isdir(d) else []


def test_trace_only_at_the_profile_epoch_of_training(csv, tmp_path,
                                                     monkeypatch):
    prof = tmp_path / "prof"
    agent = _agent(csv, tmp_path / "run", f"--profile_dir={prof}",
                   "--profile_epoch=1")
    agent.run_epoch(0, mode="train")
    agent.run_epoch(1, mode="val")
    assert _traces(prof) == []
    agent.run_epoch(1, mode="train")
    (trace,) = _traces(prof)
    with open(prof / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::convolution")
               for e in events)
    agent.finalize()

    env_dir = tmp_path / "env_prof"
    monkeypatch.setenv("PROTOASNET_PROFILE_DIR", str(env_dir))
    agent = _agent(csv, tmp_path / "run2")  # profile_epoch: default 1
    agent.run_epoch(0, mode="train")
    assert _traces(env_dir) == []
    agent.run_epoch(1, mode="train")
    assert len(_traces(env_dir)) == 1
    agent.finalize()
