"""Port's serving path on the CPU: bundle -> DynamicBatcher -> model ->
logits over HTTP, against a direct forward of the same model.

Small model (8 frames at 32x32, P=8, D=64, K=4); every entry point is
called with ``device="cpu"`` / ``--device cpu``.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                        load_serving_bundle_with_spec,
                                        save_serving_bundle)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32, "head_impl": "xla"}
SAMPLE = (8, 32, 32, 3)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(bundle path, the model it holds)."""
    model = build_model(CFG, device="cpu", seed=3)
    # non-trivial BN running stats, so the bundle must carry buffers too
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    path = tmp_path_factory.mktemp("bundle") / "b.zip"
    save_serving_bundle(str(path), model, CFG, SAMPLE)
    return str(path), model


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))[0].numpy()


def _clips(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, *SAMPLE)).astype(np.float32)


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/v1/predict", data=buf.getvalue(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, np.load(io.BytesIO(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def live_server(bundle):
    path, model = bundle
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(
        target=server.serve_forever, args=(path,),
        kwargs=dict(host="127.0.0.1", port=0, max_batch=8, max_delay_ms=20.0,
                    warmup=False, ready_event=ready, stop_event=stop,
                    device="cpu"),
        daemon=True)
    t.start()
    assert ready.wait(60), "server did not bind"
    yield f"http://127.0.0.1:{ready.port}", model
    stop.set()
    t.join(30)
    assert not t.is_alive(), "server did not stop"


def test_bundle_roundtrip(bundle):
    path, model = bundle
    fn, shape, dtype = load_serving_bundle_with_spec(path, device="cpu")
    assert shape == (None, *SAMPLE) and dtype == np.float32
    x = _clips(2, 0)
    np.testing.assert_array_equal(fn(x), _forward(model, x))


def test_uint8_gray_bundle_applies_eval_transform(bundle, tmp_path):
    _, model = bundle
    path = str(tmp_path / "u8.zip")
    save_serving_bundle(path, model, CFG, SAMPLE, uint8_gray=True)
    fn, shape, dtype = load_serving_bundle_with_spec(path, device="cpu")
    assert shape == (None, *SAMPLE[:-1]) and dtype == np.uint8
    raw = np.random.default_rng(1).integers(0, 256, size=(2, *SAMPLE[:-1]),
                                            dtype=np.uint8)
    # the JAX package's eval transform, written out: /255, normalise, gray->3
    xf = (raw.astype(np.float32) / 255.0 - 0.099) / 0.171
    xf = np.repeat(xf[..., None], 3, axis=-1)
    np.testing.assert_allclose(fn(raw), _forward(model, xf), rtol=1e-5,
                               atol=1e-5)


def test_posts_equal_direct_forward(live_server):
    url, model = live_server
    for n, seed in ((1, 10), (3, 11), (8, 12)):
        x = _clips(n, seed)
        code, out = _post(url, x)
        assert code == 200, out
        np.testing.assert_allclose(out, _forward(model, x), rtol=1e-5,
                                   atol=1e-5)
    # one unbatched clip: rank sample_ndim is accepted and batched
    x = _clips(1, 13)
    code, out = _post(url, x[0])
    assert code == 200
    np.testing.assert_allclose(out, _forward(model, x), rtol=1e-5, atol=1e-5)


def test_concurrent_posts_coalesce(live_server):
    url, model = live_server
    xs = [_clips(1, 20 + i) for i in range(4)]
    outs = [None] * 4

    def worker(i):
        outs[i] = _post(url, xs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for x, (code, out) in zip(xs, outs):
        assert code == 200, out
        np.testing.assert_allclose(out, _forward(model, x), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "rank", "dtype", "payload"])
def test_bad_requests_get_400(live_server, bad):
    url, _ = live_server
    if bad == "shape":
        code, msg = _post(url, np.zeros((1, 8, 16, 16, 3), np.float32))
    elif bad == "rank":
        code, msg = _post(url, np.zeros((4, 4), np.float32))
    elif bad == "dtype":
        code, msg = _post(url, np.zeros((1, *SAMPLE), np.complex64))
    else:
        req = urllib.request.Request(url + "/v1/predict", data=b"not npy",
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=30)
            code, msg = 200, ""
        except urllib.error.HTTPError as e:
            code, msg = e.code, e.read().decode()
    assert code == 400, msg


def test_health_spec_stats_metrics(live_server):
    url, _ = live_server
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        assert r.status == 200 and r.read() == b"ok"
    with urllib.request.urlopen(url + "/v1/spec", timeout=10) as r:
        spec = json.loads(r.read())
    assert spec["sample_shape"] == list(SAMPLE)
    assert spec["dtype"] == "float32" and spec["max_batch"] == 8
    _post(url, _clips(2, 30))
    with urllib.request.urlopen(url + "/v1/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["samples"] >= 2
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        assert b"protoasnet_requests_total" in r.read()
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=10)
    assert e.value.code == 404


def test_batcher_pads_to_bucket_and_maps_rows_back():
    calls = []

    def fn(x):
        calls.append(len(x))
        return x.reshape(len(x), -1).sum(axis=1, keepdims=True)

    assert server._bucket_ladder(12) == (1, 2, 4, 8, 12)
    b = server.DynamicBatcher(fn, max_batch=8, max_delay_ms=1.0,
                              sample_shape=(2,))
    try:
        x = np.arange(10, dtype=np.float32).reshape(5, 2)
        np.testing.assert_allclose(b.submit(x), x.sum(axis=1, keepdims=True))
        assert calls == [8]  # 5 samples padded to the 8 bucket
        out = b.submit_many(np.ones((11, 2), np.float32))
        assert out.shape == (11, 1)
        with pytest.raises(ValueError, match="sample shape"):
            b.submit(np.ones((1, 3), np.float32))
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.ones((1, 2), np.float32))


def test_cli_sigterm_drains_and_exits_zero(bundle):
    path, _ = bundle
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "protoasnet_tpu_torch.server", "--bundle",
         path, "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--max_batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO))
    try:
        deadline = time.monotonic() + 120
        port = None
        lines = []
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving "):
                port = int(line.split(" on ")[1].split(":")[1].split()[0])
                break
        assert port is not None, "".join(lines)
        assert any(line.startswith("warmed 2 buckets") for line in lines)
        code, out = _post(f"http://127.0.0.1:{port}", _clips(1, 40))
        assert code == 200 and out.shape == (1, 4)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_predict_cli(bundle, tmp_path):
    path, model = bundle
    x = _clips(3, 50)
    np.save(tmp_path / "x.npy", x)
    from protoasnet_tpu_torch.serve import main

    main(["predict", "--bundle", path, "--input", str(tmp_path / "x.npy"),
          "--out", str(tmp_path / "y.npy"), "--batch", "2", "--device",
          "cpu"])
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), _forward(model, x),
                               rtol=1e-5, atol=1e-5)
    assert load_serving_bundle(path, device="cpu")(x[:1]).shape == (1, 4)


# image bundles: ProtoPNet (fused L2 + min head) and image XProtoNet
# (ROI-cosine head), 64x64 RGB images, ResNet-18 trunk
IMAGE_CFGS = {
    "ProtoPNet": {"name": "ProtoPNet", "base_architecture": "resnet18",
                  "prototype_shape": (6, 64, 1, 1), "num_classes": 3,
                  "img_size": 64, "add_on_layers_type": "regular"},
    "XProtoNet": {"name": "XProtoNet", "base_architecture": "resnet18",
                  "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
                  "img_size": 64},
}
IMAGE = (64, 64, 3)


@pytest.mark.parametrize("name", sorted(IMAGE_CFGS))
def test_image_bundle_served_over_http(tmp_path, name):
    cfg = IMAGE_CFGS[name]
    model = build_model(cfg, device="cpu", seed=5)
    path = str(tmp_path / "image.zip")
    save_serving_bundle(path, model, cfg, IMAGE)
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(
        target=server.serve_forever, args=(path,),
        kwargs=dict(host="127.0.0.1", port=0, max_batch=4, max_delay_ms=5.0,
                    warmup=True, ready_event=ready, stop_event=stop,
                    device="cpu"),
        daemon=True)
    t.start()
    try:
        assert ready.wait(120), "server did not bind"
        url = f"http://127.0.0.1:{ready.port}"
        with urllib.request.urlopen(url + "/v1/spec", timeout=10) as r:
            assert json.loads(r.read())["sample_shape"] == list(IMAGE)
        rng = np.random.default_rng(60)
        for n in (1, 3):
            x = rng.normal(size=(n, *IMAGE)).astype(np.float32)
            code, out = _post(url, x)
            assert code == 200, out
            assert out.shape == (n, cfg["num_classes"])
            np.testing.assert_allclose(out, _forward(model, x), rtol=1e-5,
                                       atol=1e-5)
        # one unbatched image (rank 3) is batched; a clip is refused
        code, out = _post(url, x[0])
        assert code == 200
        np.testing.assert_allclose(out, _forward(model, x[:1]), rtol=1e-5,
                                   atol=1e-5)
        code, msg = _post(url, np.zeros((1, 8, *IMAGE), np.float32))
        assert code == 400, msg
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive(), "server did not stop"


def test_uint8_gray_image_bundle(tmp_path):
    cfg = IMAGE_CFGS["ProtoPNet"]
    model = build_model(cfg, device="cpu", seed=6)
    path = str(tmp_path / "u8.zip")
    save_serving_bundle(path, model, cfg, IMAGE, uint8_gray=True)
    fn, shape, dtype = load_serving_bundle_with_spec(path, device="cpu")
    assert shape == (None, 64, 64) and dtype == np.uint8
    raw = np.random.default_rng(2).integers(0, 256, size=(2, 64, 64),
                                            dtype=np.uint8)
    xf = (raw.astype(np.float32) / 255.0 - 0.099) / 0.171
    xf = np.repeat(xf[..., None], 3, axis=-1)
    np.testing.assert_allclose(fn(raw), _forward(model, xf), rtol=1e-5,
                               atol=1e-5)


def test_bundle_refuses_a_sample_shape_of_the_wrong_rank(tmp_path):
    cfg = IMAGE_CFGS["XProtoNet"]
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="rank 3"):
        save_serving_bundle(str(tmp_path / "a.zip"), model, cfg,
                            (8, *IMAGE))
    with pytest.raises(ValueError, match="rank 4"):
        save_serving_bundle(str(tmp_path / "b.zip"), model, CFG, IMAGE)
