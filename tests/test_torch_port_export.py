"""``python -m protoasnet_tpu_torch.serve export``: a trained run to a port
bundle, on the CPU (``--device cpu``).

- a run trained by the port's ``main`` (video XProtoNet, 8 frames of
  32x32, P=8, D=64): the bundle's logits equal the rebuilt agent's eval
  forward (direct, and served over HTTP by ``server.serve_forever``);
  ``--uint8_input`` takes raw gray frames and gives the float bundle's
  logits on the normalised 3-channel frames;
- ``--int8`` (w8a8, ``quant.py``) of a port run and of a JAX run: the
  bundle holds ``qstate.npz``, loads as the quantised model, and its
  logits equal ``apply_quantized`` on the rebuilt agent calibrated on the
  same train batches; ``--int8 --uint8_input`` round-trips; an int8
  bundle is served by the daemon (bit-equal) and timed by ``serve tune``;
- runs written by the JAX package's agents (flax ``last.ckpt`` and its
  ``config_agent.yml``; the end-to-end video XProtoNet, the staged image
  XProtoNet and the end-to-end ProtoPNet): the bundle's logits equal the
  port agent's eval forward and the JAX model's at fp32 tolerance (1e-4 of
  max |logit|);
- a run whose config points at a reference checkpoint migrated by the JAX
  package (``.pickle``) exports its weights;
- after an explain of the run with another ``--model.checkpoint_path``,
  export still takes the training config and ``last.ckpt``;
- ``load_trained_agent`` refuses a directory without a config and a run
  without a trained checkpoint.
"""

import io
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.data.transforms import normalize
from protoasnet_tpu_torch.main import main as train_main
from protoasnet_tpu_torch.client import ServingClient
from protoasnet_tpu_torch.quant import (apply_quantized,
                                        calibrate_qstate_from_agent)
from protoasnet_tpu_torch.serve import (export_run, load_bundle_model,
                                        load_serving_bundle,
                                        load_serving_bundle_with_spec,
                                        load_trained_agent, tune_bundle)
from protoasnet_tpu_torch.serve import main as serve_main
from tests.test_torch_port_checkpoint_jax import (_jax_logits, _jax_run,
                                                  agent_config, sample_batch)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TRAIN = ("--data.img_size=32", "--data.frames=8", "--data.eval_batch_size=4",
         "--model.prototype_shape=(8, 64, 1, 1, 1)", "--model.dtype=float32",
         "--train.batch_size=2", "--data.num_workers=1")


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  num_videos=12, seed=3)


@pytest.fixture
def scratch(tmp_path):
    """A tmp_path removed after the test (runs and bundles are large)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def port_run(csv, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_run")
    cfg = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
    agent = train_main([f"--config_path={cfg}", f"--save_dir={root}",
                        "--device", "cpu", f"--data.data_info_file={csv}",
                        *TRAIN, "--train.num_train_epochs=1",
                        "--train.push_start=0", "--train.push_rate=1"])
    yield agent.save_dir
    shutil.rmtree(root, ignore_errors=True)


def _eval_logits(agent, x):
    """The agent's own eval step on ``x`` (all samples valid)."""
    n = len(x)
    m = agent.eval_step(torch.from_numpy(x), torch.zeros(n, dtype=torch.long),
                        torch.ones(n, dtype=torch.bool),
                        generator=torch.Generator().manual_seed(0))
    return m["logits"].float().numpy()


def _clips(n, seed, shape=(8, 32, 32, 3)):
    return np.random.default_rng(seed).normal(
        size=(n, *shape)).astype(np.float32)


def test_export_of_a_port_run_equals_the_agent_eval_forward(port_run,
                                                           scratch):
    out = str(scratch / "b.zip")
    agent, shape = export_run(port_run, out, device="cpu")
    assert shape == (8, 32, 32, 3) and agent.current_iteration > 0
    fn, spec, dtype = load_serving_bundle_with_spec(out, device="cpu")
    assert spec == (None, 8, 32, 32, 3) and dtype == np.float32
    x = _clips(3, 1)
    np.testing.assert_allclose(fn(x), _eval_logits(agent, x), rtol=1e-6,
                               atol=1e-6)


def test_export_takes_last_ckpt_after_an_explain_of_another_checkpoint(
        port_run, csv, scratch):
    """An explain command with its own ``--model.checkpoint_path`` dumps
    ``config_explain_test.yml``, which sorts before ``config_train.yml``;
    export still rebuilds from the training config and ``last.ckpt``."""
    from protoasnet_tpu_torch.explain.__main__ import main as explain_main
    from protoasnet_tpu_torch.utils.io import (load_checkpoint,
                                               save_checkpoint)

    run = scratch / "runs" / Path(port_run).name
    shutil.copytree(port_run, run)
    last = load_checkpoint(str(run / "last.ckpt"))
    other = dict(last, model=dict(last["model"]))
    key = "last_layer.Dense_0.weight"
    other["model"][key] = -2.0 * last["model"][key]
    save_checkpoint(other, str(scratch / "other.ckpt"))
    cfg = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
    out = explain_main([f"--config_path={cfg}",
                        f"--save_dir={scratch / 'runs'}", "--device", "cpu",
                        f"--data.data_info_file={csv}", *TRAIN,
                        f"--model.checkpoint_path={scratch / 'other.ckpt'}",
                        "--explain_locally=true", "--eval_data_type=test"])
    assert Path(out["agent"].save_dir) == run
    assert torch.equal(out["agent"].model.state_dict()[key],
                       other["model"][key])
    dumps = sorted(p.name for p in run.glob("config_*.yml"))
    assert dumps[0] == "config_explain_test.yml", dumps
    bundle = str(scratch / "b.zip")
    agent, _ = export_run(str(run), bundle, device="cpu")
    for k, v in agent.model.state_dict().items():
        assert torch.equal(v, last["model"][k]), k
    x = _clips(2, 5)
    fn = load_serving_bundle(bundle, device="cpu")
    np.testing.assert_allclose(fn(x), _eval_logits(agent, x), rtol=1e-6,
                               atol=1e-6)


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/v1/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def test_export_cli_bundle_served_over_http(port_run, scratch):
    out = str(scratch / "cli.zip")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "protoasnet_tpu_torch.serve", "export",
         "--run_dir", port_run, "--out", out, "--device", "cpu"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"wrote {out}" in proc.stdout and "MB" in proc.stdout
    agent, _ = load_trained_agent(port_run, device="cpu")
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(
        target=server.serve_forever, args=(out,),
        kwargs=dict(host="127.0.0.1", port=0, max_batch=4, max_delay_ms=5.0,
                    warmup=False, ready_event=ready, stop_event=stop,
                    device="cpu"), daemon=True)
    t.start()
    try:
        assert ready.wait(60), "server did not bind"
        x = _clips(4, 2)  # one full bucket: the batch the agent sees
        served = _post(f"http://127.0.0.1:{ready.port}", x)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    np.testing.assert_allclose(served, _eval_logits(agent, x), rtol=1e-6,
                               atol=1e-6)


def test_uint8_input_round_trips(port_run, scratch):
    f32, u8 = str(scratch / "f32.zip"), str(scratch / "u8.zip")
    serve_main(["export", "--run_dir", port_run, "--out", f32,
                "--device", "cpu"])
    serve_main(["export", "--run_dir", port_run, "--out", u8,
                "--uint8_input", "--device", "cpu"])
    fn8, spec, dtype = load_serving_bundle_with_spec(u8, device="cpu")
    assert spec == (None, 8, 32, 32) and dtype == np.uint8
    gray = np.random.default_rng(3).integers(0, 256, size=(2, 8, 32, 32),
                                             dtype=np.uint8)
    x = normalize(torch.from_numpy(gray).float() / 255.0)
    x = x[..., None].expand(*x.shape, 3).contiguous().numpy()
    np.testing.assert_allclose(fn8(gray), load_serving_bundle(
        f32, device="cpu")(x), rtol=1e-5, atol=1e-5)


def _int8_logits(run, x, calib_batches=4):
    """``apply_quantized`` on the run's rebuilt agent, calibrated as the
    export calibrates (its train loader's first batches)."""
    agent, _ = load_trained_agent(run, device="cpu")
    qstate = calibrate_qstate_from_agent(agent, calib_batches)
    assert len(qstate) > 20 and not any("stem_spatial" in k for k in qstate)
    return apply_quantized(agent.model, qstate, torch.from_numpy(x))[0] \
        .float().numpy()


def test_int8_export_of_a_port_run(port_run, scratch):
    out = str(scratch / "q.zip")
    serve_main(["export", "--run_dir", port_run, "--out", out, "--int8",
                "--calib_batches", "2", "--device", "cpu"])
    with zipfile.ZipFile(out) as z:
        assert {"config.json", "weights.npz", "qstate.npz"} <= set(
            z.namelist())
    model, spec, dtype, _ = load_bundle_model(out, device="cpu")
    assert spec == (None, 8, 32, 32, 3) and dtype == np.float32
    assert type(model.cnn_backbone.layer1_0.conv1.spatial).__name__ == \
        "QuantConv"
    x = _clips(3, 4)
    got = load_serving_bundle(out, device="cpu")(x)
    np.testing.assert_array_equal(got, _int8_logits(port_run, x, 2))
    # a float bundle of the same run: close, not equal
    f32 = str(scratch / "f.zip")
    export_run(port_run, f32, device="cpu")
    fp = load_serving_bundle(f32, device="cpu")(x)
    assert 0 < np.abs(got - fp).max() < 0.08 * np.abs(fp).max()


def test_int8_uint8_input_round_trips(port_run, scratch):
    q, q8 = str(scratch / "q.zip"), str(scratch / "q8.zip")
    export_run(port_run, q, device="cpu", int8=True)
    export_run(port_run, q8, uint8_input=True, device="cpu", int8=True)
    fn8, spec, dtype = load_serving_bundle_with_spec(q8, device="cpu")
    assert spec == (None, 8, 32, 32) and dtype == np.uint8
    gray = np.random.default_rng(5).integers(0, 256, size=(2, 8, 32, 32),
                                             dtype=np.uint8)
    x = normalize(torch.from_numpy(gray).float() / 255.0)
    x = x[..., None].expand(*x.shape, 3).contiguous().numpy()
    np.testing.assert_allclose(fn8(gray), load_serving_bundle(
        q, device="cpu")(x), rtol=1e-5, atol=1e-5)


def test_int8_bundle_served_by_the_daemon_and_tuned(port_run, scratch):
    out = str(scratch / "q.zip")
    export_run(port_run, out, device="cpu", int8=True)
    x = _clips(3, 6)
    want = load_serving_bundle(out, device="cpu")(x)
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=server.serve_forever, args=(out,),
                         kwargs=dict(host="127.0.0.1", port=0, max_batch=4,
                                     warmup=False, ready_event=ready,
                                     stop_event=stop, device="cpu"),
                         daemon=True)
    t.start()
    try:
        assert ready.wait(120)
        got = ServingClient(f"http://127.0.0.1:{ready.port}",
                            timeout_s=120, retries=0).predict(x)
    finally:
        stop.set()
        t.join(60)
    np.testing.assert_array_equal(got, want)
    res = tune_bundle(out, [1, 2], points=(1, 2), device="cpu")
    assert set(res["results"]) == {1, 2}
    assert all("samples_per_sec" in r or "error" in r
               for r in res["results"].values())


def test_int8_export_of_a_jax_run(csv, scratch):
    run = scratch / "jax_run"
    _jax_run("Video_XProtoNet_e2e", csv, run)
    out = str(scratch / "q.zip")
    serve_main(["export", "--run_dir", str(run), "--out", out, "--int8",
                "--device", "cpu"])
    x = sample_batch("Video_XProtoNet_e2e", 6, n=3)[0].astype(np.float32)
    np.testing.assert_array_equal(load_serving_bundle(out, device="cpu")(x),
                                  _int8_logits(str(run), x))


@pytest.mark.parametrize("name", ["Video_XProtoNet_e2e", "XProtoNet_Base",
                                  "ProtoPNet_e2e"])
def test_export_of_a_jax_run(csv, scratch, name):
    run = scratch / "jax_run"
    jax_agent = _jax_run(name, csv, run)
    assert (run / "config_agent.yml").exists()
    out = str(scratch / "b.zip")
    serve_main(["export", "--run_dir", str(run), "--out", out,
                "--device", "cpu"])
    agent, _ = load_trained_agent(str(run), device="cpu")
    assert agent.current_iteration == 7
    fn = load_serving_bundle(out, device="cpu")
    x = sample_batch(name, 6, n=3)[0].astype(np.float32)
    got = fn(x)
    agent.model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            got, agent.model(torch.from_numpy(x))[0].numpy(), rtol=1e-6,
            atol=1e-6)
    ref = _jax_logits(jax_agent, x)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-6


def test_export_of_a_migrated_reference_run(csv, scratch):
    from protoasnet_tpu.models.migrate import main as migrate_main
    from tests.test_migrate import RefVideoXProtoNet

    ref = RefVideoXProtoNet().eval()
    pth = str(scratch / "ref.pth")
    torch.save({"epoch": 4, "iteration": 50,
                "state_dict": ref.state_dict()}, pth)
    run = scratch / "run"
    run.mkdir()
    cfg = agent_config("Video_XProtoNet_e2e", csv, str(run))
    with open(run / "config_train.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    pkl = str(scratch / "migrated.pickle")
    migrate_main([pth, pkl, f"--config_path={run / 'config_train.yml'}"])
    cfg["model"]["checkpoint_path"] = pkl
    with open(run / "config_train.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    out = str(scratch / "b.zip")
    serve_main(["export", "--run_dir", str(run), "--out", out,
                "--device", "cpu"])
    x = _clips(2, 7)
    with torch.no_grad():
        want = ref(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))[0]
    np.testing.assert_allclose(load_serving_bundle(out, device="cpu")(x),
                               want.numpy(), rtol=1e-3, atol=1e-4)


def test_load_trained_agent_refuses(csv, scratch):
    with pytest.raises(FileNotFoundError, match="config_"):
        load_trained_agent(str(scratch), device="cpu")
    cfg = agent_config("Video_XProtoNet_e2e", csv, str(scratch))
    with open(scratch / "config_train.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(RuntimeError, match="no trained checkpoint"):
        load_trained_agent(str(scratch), device="cpu")
