"""The port's typed client (``protoasnet_tpu_torch/client.py``) on the CPU:

- against the port's daemon (``server._serve_loop``, a per-sample sum):
  spec discovery, chunking to the request ceiling, unbatched samples, 400
  as BadRequestError, the uint8 contract (uint8 shipped as is, float
  frames refused, never cast), the spec cache (one probe for a definitive
  miss, a re-probe after a transient one) and no widening cast — the
  cases of ``tests/test_server.py`` for the JAX package's client;
- retries with backoff then raises; BadRequestError is never retried;
  connection refused is retryable;
- wire compatibility both ways, on a port bundle's model: the JAX
  package's client against the port's daemon, and the port's client
  against the JAX package's ``_serve_loop``, give the port daemon's
  logits;
- the CLI.
"""

import io
import threading

import numpy as np
import pytest

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.client import (BadRequestError, RetryableError,
                                         ServingClient)
from protoasnet_tpu_torch.client import main as client_main


def _sum(x):
    return x.astype(np.float32).sum(axis=(1, 2))


def _start(loop, fn, sample_shape, dtype, max_batch=4):
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=loop,
                         args=(fn, sample_shape, dtype, "127.0.0.1", 0,
                               max_batch, 2.0, False, ready),
                         kwargs=dict(stop_event=stop), daemon=True)
    t.start()
    assert ready.wait(60), "server did not bind"
    return f"http://127.0.0.1:{ready.port}", stop, t


def _stop(stop, t):
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive(), "server did not stop"


@pytest.fixture()
def live_loop():
    url, stop, t = _start(server._serve_loop, _sum, (4, 4), np.float32)
    yield url
    _stop(stop, t)


def test_client_spec_health_and_chunked_predict(live_loop):
    c = ServingClient(live_loop, timeout_s=60)
    assert c.healthy()
    spec = c.spec()
    assert spec["sample_shape"] == [4, 4] and spec["dtype"] == "float32"
    assert spec["max_batch"] == 4 and spec["buckets"] == [1, 2, 4]
    assert spec["max_body_bytes"] > 0
    # 100 samples > 16 * max_batch = 64: two HTTP requests; float64 is
    # downcast to the wire dtype by the client
    x = np.random.default_rng(0).normal(size=(100, 4, 4))
    real, posts = c._request, []

    def counted(path, body=None):
        if body is not None:
            posts.append(len(np.load(io.BytesIO(body))))
        return real(path, body)

    c._request = counted
    out = c.predict(x)
    np.testing.assert_allclose(out, x.astype(np.float32).sum(axis=(1, 2)),
                               rtol=1e-6)
    assert posts == [64, 36]
    # the daemon queues each request in chunks of max_batch: 16 + 9
    assert c.stats()["requests"] == 25


def test_client_unbatched_sample_and_bad_request(live_loop):
    c = ServingClient(live_loop, timeout_s=60)
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    out = c.predict(x)  # rank == sample rank: unbatched in, unbatched out
    assert np.ndim(out) == 0
    np.testing.assert_allclose(out, x.sum(), rtol=1e-6)
    with pytest.raises(BadRequestError) as ei:  # wrong sample shape
        c.predict(np.zeros((2, 5, 5), np.float32))
    assert ei.value.status == 400
    with pytest.raises(BadRequestError):  # the client's empty-input guard
        c.predict(np.zeros((0, 4, 4), np.float32))


def test_client_retry_then_raise():
    c = ServingClient("http://127.0.0.1:1", retries=2, backoff_s=0.0)
    calls = []

    def flaky(path, body=None):
        calls.append(path)
        if len(calls) < 3:
            raise RetryableError(503, "boom")
        return b"ok"

    c._request = flaky
    assert c._request_retry("/x") == b"ok"
    assert len(calls) == 3
    calls.clear()

    def dead(path, body=None):
        calls.append(path)
        raise RetryableError(504, "still down")

    c._request = dead
    with pytest.raises(RetryableError):
        c._request_retry("/x")
    assert len(calls) == 3  # the first try and 2 retries
    calls.clear()

    def bad(path, body=None):
        calls.append(path)
        raise BadRequestError(400, "your fault")

    c._request = bad
    with pytest.raises(BadRequestError):
        c._request_retry("/x")
    assert len(calls) == 1  # never retried


def test_client_connection_refused_is_retryable():
    c = ServingClient("http://127.0.0.1:1", timeout_s=2, retries=0)
    assert not c.healthy()
    with pytest.raises(RetryableError) as ei:
        c.stats()
    assert ei.value.status == 0


def test_client_uint8_daemon_contract():
    """uint8 ships untouched; float frames are never cast to uint8 (lossy):
    the daemon's 400 surfaces as BadRequestError."""
    url, stop, t = _start(server._serve_loop, _sum, (4, 4), np.uint8)
    try:
        c = ServingClient(url, timeout_s=60)
        assert c.spec()["dtype"] == "uint8"
        x = np.arange(32, dtype=np.uint8).reshape(2, 4, 4)
        assert c._coerce(x, c.spec()) is x
        np.testing.assert_allclose(c.predict(x), _sum(x))
        with pytest.raises(BadRequestError):
            c.predict(np.zeros((2, 4, 4), np.float32))
    finally:
        _stop(stop, t)


def test_client_spec_cache_semantics_and_no_upcast(live_loop):
    x = np.ones((3, 4, 4), np.float32)
    # a definitive miss (a daemon without /v1/spec: 404) is cached
    c = ServingClient(live_loop, timeout_s=60, retries=0)
    real, probes = c._request, []

    def gone(path, body=None):
        if path == "/v1/spec":
            probes.append(path)
            raise BadRequestError(404, "not found")
        return real(path, body)

    c._request = gone
    np.testing.assert_allclose(c.predict(x), _sum(x))
    np.testing.assert_allclose(c.predict(x), _sum(x))
    assert len(probes) == 1
    # a proxy answering 200 with JSON that is not a dict: a miss too
    c1 = ServingClient(live_loop, timeout_s=60, retries=0)
    real1, probes1 = c1._request, []

    def junk(path, body=None):
        if path == "/v1/spec":
            probes1.append(path)
            return b"null"
        return real1(path, body)

    c1._request = junk
    np.testing.assert_allclose(c1.predict(x), _sum(x))
    np.testing.assert_allclose(c1.predict(x), _sum(x))
    assert len(probes1) == 1
    # a transient failure is probed again on the next call
    c2 = ServingClient(live_loop, timeout_s=60, retries=0)
    real2, probes2, down = c2._request, [], {"on": True}

    def flaky(path, body=None):
        if path == "/v1/spec":
            probes2.append(path)
            if down["on"]:
                raise RetryableError(0, "blip")
        return real2(path, body)

    c2._request = flaky
    np.testing.assert_allclose(c2.predict(x), _sum(x))
    assert len(probes2) == 1
    down["on"] = False
    np.testing.assert_allclose(c2.predict(x), _sum(x))
    assert len(probes2) == 2 and isinstance(c2._spec, dict)
    # never widen: float16 ships as float16; float64 is narrowed
    c3 = ServingClient(live_loop, timeout_s=60)
    spec = c3.spec()
    assert spec["max_request_samples"] == 16 * spec["max_batch"]
    xh = np.ones((2, 4, 4), np.float16)
    assert c3._coerce(xh, spec).dtype == np.float16
    np.testing.assert_allclose(c3.predict(xh), [16.0, 16.0])
    assert c3._coerce(np.ones((2, 4, 4)), spec).dtype == np.float32


def test_client_cli(live_loop, tmp_path, capsys):
    x = np.random.default_rng(1).normal(size=(5, 4, 4)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    client_main(["--url", live_loop, "--input", str(tmp_path / "x.npy"),
                 "--out", str(tmp_path / "y.npy")])
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), _sum(x),
                               rtol=1e-6)
    out = capsys.readouterr().out
    assert "predictions in" in out and "y.npy (5,) float32" in out
    with pytest.raises(SystemExit):
        client_main(["--url", live_loop])  # neither --input nor --reload


CFG = {"name": "ProtoPNet", "base_architecture": "resnet18",
       "prototype_shape": (6, 64, 1, 1), "num_classes": 3, "img_size": 64,
       "add_on_layers_type": "regular"}
IMAGE = (64, 64, 3)


def test_wire_compatible_with_the_jax_package_both_ways(tmp_path):
    """A port bundle's model behind each package's daemon, reached by each
    package's client: the same logits four ways."""
    from protoasnet_tpu import client as jax_client
    from protoasnet_tpu import server as jax_server
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                            save_serving_bundle)

    path = str(tmp_path / "b.zip")
    save_serving_bundle(path, build_model(CFG, device="cpu", seed=4), CFG,
                        IMAGE)
    fn = load_serving_bundle(path, device="cpu")
    x = np.random.default_rng(5).normal(size=(3, *IMAGE)).astype(np.float32)
    want = fn(np.concatenate([x, np.zeros((1, *IMAGE), np.float32)]))[:3]
    got = {}
    for daemon, loop in (("port", server._serve_loop),
                         ("jax", jax_server._serve_loop)):
        url, stop, t = _start(loop, fn, IMAGE, np.float32)
        try:
            for who, cls, bad in (
                    ("port", ServingClient, BadRequestError),
                    ("jax", jax_client.ServingClient,
                     jax_client.BadRequestError)):
                c = cls(url, timeout_s=120, retries=0)
                assert c.spec()["sample_shape"] == list(IMAGE)
                got[daemon, who] = c.predict(x)
                with pytest.raises(bad):
                    c.predict(np.zeros((1, 32, 32, 3), np.float32))
            with pytest.raises(BadRequestError) as ei:  # no reload here
                ServingClient(url, retries=0).reload_status()
            assert ei.value.status == 403
        finally:
            _stop(stop, t)
    assert len(got) == 4
    for key, logits in got.items():
        np.testing.assert_array_equal(logits, want, err_msg=str(key))
