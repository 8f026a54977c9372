"""``server.serve_live`` of the port on the CPU: a trained run directory
served live, against the JAX package.

- runs written by the JAX package's agents (the fp32 ``Video_XProtoNet_e2e``
  at 8 frames of 32x32, and ``ProtoPNet_e2e`` at 64x64): the served
  logits against the JAX agent's forward on the same inputs at
  ``rtol=1e-3, atol=1e-4``, and bit-equal to the same run exported by
  ``serve export`` and served by ``serve_forever``;
- ``uint8_input``: raw gray frames give the logits of the eval transform
  written out (/255, normalise, gray -> 3 channels);
- ``int8``: the JAX video run served live as the w8a8 model: its qstate
  is the JAX package's on the same train batches (scales within rtol
  1e-5, bit-equal int8 weights), its logits bit-equal to the port's
  ``apply_quantized`` and within 1e-2 of max |logit| of the JAX
  package's (fp32 code flips; see the test);
- the ``--run_dir`` CLI answers and drains on SIGTERM with exit code 0;
- a live reload between two JAX runs serves the second run's logits, a
  reload with ``int8: true`` the run's w8a8 logits; a run of another
  input shape ends in ``error``.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu import quant as jq
from protoasnet_tpu.train.agents import build_agent as jax_build_agent
from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.client import ServingClient, ServingError
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.data.transforms import normalize
from protoasnet_tpu_torch.quant import (apply_quantized,
                                        calibrate_qstate_from_agent)
from protoasnet_tpu_torch.serve import load_trained_agent
from protoasnet_tpu_torch.serve import main as serve_main
from tests.test_torch_port_checkpoint_jax import (_jax_logits, _mark_trained,
                                                  agent_config, sample_batch)

REPO = Path(__file__).resolve().parents[1]
VIDEO, PPNET = "Video_XProtoNet_e2e", "ProtoPNet_e2e"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("live")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def csv(root):
    return make_synthetic_dataset(str(root / "data"), num_videos=12, seed=3)


def _jax_run(name, csv, run, seed):
    """The JAX agent ``name`` at fp32 initialised from ``seed``, marked
    trained, its checkpoint and ``config_agent.yml`` in ``run``."""
    agent = jax_build_agent(agent_config(name, csv, str(run),
                                         f"--train.seed={seed}"))
    _mark_trained(agent, name)
    agent.save_checkpoint()
    return agent


@pytest.fixture(scope="module")
def runs(csv, root):
    """{name: (run dir, JAX agent)}: the video run twice (seeds 1 and 2)
    and ProtoPNet once."""
    return {key: (str(root / key), _jax_run(name, csv, root / key, seed))
            for key, name, seed in (("video", VIDEO, 1), ("video_b", VIDEO, 2),
                                    ("ppnet", PPNET, 1))}


def _start(target, *args, **kwargs):
    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            target(*args, ready_event=ready, stop_event=stop, **kwargs)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            ready.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(120) and not errors, errors
    return f"http://127.0.0.1:{ready.port}", stop, t


def _stop(stop, t):
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive(), "server did not stop"


def _live(run, **kw):
    return _start(server.serve_live, run, host="127.0.0.1", port=0,
                  max_batch=4, max_delay_ms=2.0, warmup=False, device="cpu",
                  **kw)


@pytest.mark.parametrize("key, name", [("video", VIDEO), ("ppnet", PPNET)])
def test_live_logits_match_jax_and_the_exported_bundle(runs, root, key,
                                                       name):
    run, jax_agent = runs[key]
    x = sample_batch(name, 6, n=3)[0].astype(np.float32)
    url, stop, t = _live(run)
    try:
        c = ServingClient(url, timeout_s=120, retries=0)
        spec = c.spec()
        assert spec["buckets"] == [1, 2, 4]
        assert spec["sample_shape"] == list(x.shape[1:])
        live = c.predict(x)
    finally:
        _stop(stop, t)
    np.testing.assert_allclose(live, _jax_logits(jax_agent, x), rtol=1e-3,
                               atol=1e-4)
    bundle = str(root / f"{key}.zip")
    serve_main(["export", "--run_dir", run, "--out", bundle,
                "--device", "cpu"])
    url, stop, t = _start(server.serve_forever, bundle, host="127.0.0.1",
                          port=0, max_batch=4, max_delay_ms=2.0,
                          warmup=False, device="cpu")
    try:
        served = ServingClient(url, timeout_s=120, retries=0).predict(x)
    finally:
        _stop(stop, t)
    np.testing.assert_array_equal(live, served)


def test_live_uint8_input_is_the_eval_transform(runs):
    run, _ = runs["video"]
    gray = np.random.default_rng(7).integers(0, 256, size=(2, 8, 32, 32),
                                             dtype=np.uint8)
    xf = normalize(torch.from_numpy(gray).float() / 255.0)
    xf = xf[..., None].expand(*xf.shape, 3).contiguous()
    agent, _ = load_trained_agent(run, device="cpu")
    agent.model.eval()
    with torch.no_grad():
        want = agent.model(xf)[0].numpy()
    url, stop, t = _live(run, uint8_input=True)
    try:
        c = ServingClient(url, timeout_s=120, retries=0)
        assert c.spec()["dtype"] == "uint8"
        assert c.spec()["sample_shape"] == [8, 32, 32]
        got = c.predict(gray)
    finally:
        _stop(stop, t)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _calib_batches(run, n):
    """The first ``n`` train batches the port calibrates on for ``run``."""
    agent, _ = load_trained_agent(run, device="cpu")
    out = []
    for batch in agent.data_loaders["train"]:
        out.append(batch["cine"].numpy())
        if len(out) == n:
            return out


def _jax_int8(jax_agent, batches, x):
    """The JAX package's scales, qstate and ``apply_quantized`` logits,
    calibrated on ``batches``."""
    variables = {"params": jax_agent.params,
                 "batch_stats": jax_agent.batch_stats}
    scales = jq.calibrate_act_scales(jax_agent.model, variables,
                                     [jnp.asarray(b) for b in batches])
    qstate = jq.build_qstate(variables, scales)
    logits = jq.apply_quantized(jax_agent.model, variables, qstate,
                                jnp.asarray(x, jnp.float32))[0]
    return (jax.tree_util.tree_map(np.asarray, qstate), np.asarray(logits))


def _port_int8_logits(run, x, calib_batches=4):
    agent, _ = load_trained_agent(run, device="cpu")
    qstate = calibrate_qstate_from_agent(agent, calib_batches)
    return apply_quantized(agent.model, qstate, torch.from_numpy(x))[0] \
        .numpy()


def test_live_int8_matches_the_jax_packages_apply_quantized(runs):
    """``serve_live --int8`` on a JAX run, against the JAX package's w8a8
    model calibrated on the same train batches: the same convs, scales
    within rtol 1e-5 and bit-equal int8 weights, and the live logits
    bit-equal to the port's ``apply_quantized`` at its calibration. The
    logits of the two packages agree within 1e-2 of max |logit|, not
    tighter: their fp32 forwards differ by ~1e-7, enough to move some
    activations across a rounding boundary of the int8 codes (on this
    run 9.6e-4 of 0.82 at one and the same qstate, against 1.2e-7 for the
    float forwards); in float64 the two agree to 1e-5 of max |logit|
    (``tests/test_torch_port_quant.py``)."""
    run, jax_agent = runs["video"]
    x = sample_batch(VIDEO, 6, n=3)[0].astype(np.float32)
    url, stop, t = _live(run, int8=True, calib_batches=2)
    try:
        live = ServingClient(url, timeout_s=120, retries=0).predict(x)
    finally:
        _stop(stop, t)
    agent, _ = load_trained_agent(run, device="cpu")
    qstate = calibrate_qstate_from_agent(agent, 2)
    np.testing.assert_array_equal(
        live, apply_quantized(agent.model, qstate, torch.from_numpy(x))[0]
        .numpy())
    jqstate, want = _jax_int8(jax_agent, _calib_batches(run, 2), x)
    assert set(qstate) == set(jqstate) and len(qstate) > 20
    for key, entry in jqstate.items():
        np.testing.assert_allclose(float(qstate[key]["a_scale"]),
                                   float(entry["a_scale"]), rtol=1e-5)
        np.testing.assert_array_equal(qstate[key]["w_q"].numpy(),
                                      entry["w_q"])
        np.testing.assert_array_equal(qstate[key]["w_scale"].numpy(),
                                      entry["w_scale"])
    assert np.abs(live - want).max() <= 1e-2 * np.abs(want).max()
    assert np.abs(live - _jax_logits(jax_agent, x)).max() > 0  # quantised


def test_live_reload_between_two_jax_runs(runs, root):
    """Reload to another JAX run of the same shape: the new run's logits.
    A reload with ``int8: true`` serves the new run's w8a8 logits; one to
    a run of another input shape ends in ``error`` and the current weights
    keep serving."""
    (run_a, jax_a), (run_b, jax_b) = runs["video"], runs["video_b"]
    x = sample_batch(VIDEO, 8, n=2)[0].astype(np.float32)
    url, stop, t = _live(run_a, allow_reload=True, reload_root=str(root))
    try:
        c = ServingClient(url, timeout_s=120, retries=0)
        before = c.predict(x)
        np.testing.assert_allclose(before, _jax_logits(jax_a, x), rtol=1e-3,
                                   atol=1e-4)
        st = c.reload(run_b, poll_s=0.05)
        assert st["generation"] == 1 and st["root"] == str(root)
        after = c.predict(x)
        np.testing.assert_allclose(after, _jax_logits(jax_b, x), rtol=1e-3,
                                   atol=1e-4)
        assert np.abs(after - before).max() > 1e-3
        st = c.reload(run_a, int8=True, poll_s=0.05)
        assert st["generation"] == 2
        quant = c.predict(x)
        np.testing.assert_array_equal(quant, _port_int8_logits(run_a, x))
        assert np.abs(quant - before).max() > 0
        with pytest.raises(ServingError, match="serving contract"):
            c.reload(runs["ppnet"][0], poll_s=0.05)
        assert c.reload_status()["generation"] == 2
        np.testing.assert_array_equal(c.predict(x), quant)
        assert c.stats()["errors"] == 0
    finally:
        _stop(stop, t)


def test_run_dir_cli_drains_on_sigterm(runs):
    run, jax_agent = runs["ppnet"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "protoasnet_tpu_torch.server", "--run_dir",
         run, "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--max_batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO))
    try:
        port, lines = None, []
        for line in iter(proc.stdout.readline, ""):
            lines.append(line)
            if line.startswith("serving "):
                port = int(line.split(" on ")[1].split(":")[1].split()[0])
                break
        assert port is not None, "".join(lines)
        assert any(line.startswith("warmed 2 buckets (1, 2)")
                   for line in lines), "".join(lines)
        x = sample_batch(PPNET, 9, n=2)[0].astype(np.float32)
        got = ServingClient(f"http://127.0.0.1:{port}", timeout_s=120,
                            retries=0).predict(x)
        np.testing.assert_allclose(got, _jax_logits(jax_agent, x),
                                   rtol=1e-3, atol=1e-4)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
