"""The port daemon's weight hot swap (``server.Reloader``, ``POST`` and
``GET /v1/reload``), on the CPU, with the JAX package's contract
(``tests/test_server.py``'s reload cases, run against the port's
``_serve_loop``):

- a daemon without reload answers 403 to both verbs;
- a hot swap changes the weights (202 with the state before the swap,
  then ``serving`` at generation 1; the ``int8`` flag reaches the build;
  ``/v1/stats`` carries the reload state);
- targets outside the root or missing, and malformed bodies, get 400 and
  start nothing;
- a failed load or a model whose input contract differs ends in
  ``error`` and the old weights keep serving;
- a second reload while one runs gets 409;
- requests racing a swap are each served by one weight set;
- a reload root of ``/`` admits targets under it;
- ``ServingClient.reload`` of the port drives all of it;
- between two real port bundles (``serve_forever(allow_reload=True)``),
  the served logits equal each bundle's own forward;
- the daemon's listen backlog holds many connections not yet accepted,
  and its connections end in TIME_WAIT on the client's side.

The build function reads a text file holding a scale: the served fn is
the per-sample sum times that scale, so a swap visibly changes outputs;
a negative scale gives a model of another input shape; ``hold`` blocks
the build until the test lets it go.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.client import (BadRequestError, RetryableError,
                                         ServingClient, ServingError)
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                        save_serving_bundle)


def _sum(x):
    return x.sum(axis=(1, 2))


def _post_npy(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def _post_json(url, obj, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body)
        except ValueError:
            return e.code, {"raw": body.decode("utf-8", "replace")}


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_state(url, states, timeout=60):
    deadline = time.time() + timeout
    st = None
    while time.time() < deadline:
        st = _get_json(url + "/v1/reload")
        if st["state"] in states:
            return st
        time.sleep(0.02)
    raise AssertionError(f"reload never reached {states}: {st}")


def _start(target, *args, **kwargs):
    """``target`` (a serve function) on port 0 in a thread; returns
    (url, stop, thread)."""
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=target, args=args, daemon=True,
                         kwargs=dict(kwargs, ready_event=ready,
                                     stop_event=stop))
    t.start()
    assert ready.wait(60), "server did not bind"
    return f"http://127.0.0.1:{ready.port}", stop, t


def _stop(stop, t):
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive(), "server did not stop"


@pytest.fixture()
def live_loop():
    """``_serve_loop`` without reload, sum per sample, max_batch 4."""
    url, stop, t = _start(server._serve_loop, _sum, (4, 4), np.float32,
                          "127.0.0.1", 0, 4, 2.0, False)
    yield url
    _stop(stop, t)


@pytest.fixture()
def reload_loop(tmp_path):
    """``_serve_loop`` with /v1/reload rooted at tmp_path; yields
    (url, tmp_path, a file outside the root, the build calls, the event
    that releases a ``hold`` build)."""
    (tmp_path / "w1.txt").write_text("1.0")
    (tmp_path / "w3.txt").write_text("3.0")
    (tmp_path / "w_badshape.txt").write_text("-1.0")
    (tmp_path / "hold.txt").write_text("hold")
    outside = tmp_path.parent / f"outside_{tmp_path.name}.txt"
    outside.write_text("9.0")
    calls, release = [], threading.Event()

    def build(target, int8):
        calls.append((target, int8))
        text = open(target).read()
        if text == "hold":
            release.wait(30)
            text = "2.0"
        scale = float(text)
        shape = (5, 5) if scale < 0 else (4, 4)

        def fn(x):
            return (torch.from_numpy(x).sum(dim=(1, 2)) * scale).numpy()

        return fn, shape, np.float32

    fn, shape, dtype = build(str(tmp_path / "w1.txt"), False)
    calls.clear()
    url, stop, t = _start(server._serve_loop, fn, shape, dtype, "127.0.0.1",
                          0, 4, 2.0, False, reload_build=build,
                          reload_root=str(tmp_path), device="cpu")
    yield url, tmp_path, outside, calls, release
    release.set()
    _stop(stop, t)
    outside.unlink()


def test_reload_disabled_is_403(live_loop):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(live_loop + "/v1/reload", timeout=10)
    assert ei.value.code == 403
    code, _ = _post_json(live_loop + "/v1/reload", {"target": "x"})
    assert code == 403
    assert "reload" not in _get_json(live_loop + "/v1/stats")


def test_reload_hot_swap_changes_weights(reload_loop):
    url, root, _, calls, _ = reload_loop
    x = np.random.default_rng(0).normal(size=(3, 4, 4)).astype(np.float32)
    ref = x.sum(axis=(1, 2))
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x), ref,
                               rtol=1e-5)
    st = _get_json(url + "/v1/reload")
    assert st == {"generation": 0, "state": "idle", "target": None,
                  "error": None, "root": str(root)}
    code, body = _post_json(url + "/v1/reload",
                            {"target": str(root / "w3.txt"), "int8": True})
    assert code == 202, body
    assert body["state"] == "loading" and body["generation"] == 0
    st = _wait_state(url, ("serving", "error"))
    assert st["state"] == "serving" and st["generation"] == 1, st
    assert st["error"] is None
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x), 3 * ref,
                               rtol=1e-5)
    assert calls == [(str(root / "w3.txt"), True)]
    assert _get_json(url + "/v1/stats")["reload"]["generation"] == 1


def test_reload_rejects_bad_targets(reload_loop):
    url, root, outside, calls, _ = reload_loop
    code, body = _post_json(url + "/v1/reload", {"target": str(outside)})
    assert code == 400 and "outside" in body["error"]
    code, body = _post_json(
        url + "/v1/reload", {"target": str(root / ".." / outside.name)})
    assert code == 400 and "outside" in body["error"]
    code, body = _post_json(url + "/v1/reload",
                            {"target": str(root / "nope.txt")})
    assert code == 400 and "does not exist" in body["error"]
    code, _ = _post_json(url + "/v1/reload", {"not_target": 1})
    assert code == 400
    assert calls == []
    x = np.ones((2, 4, 4), np.float32)
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x),
                               x.sum(axis=(1, 2)), rtol=1e-6)


@pytest.mark.parametrize("target, want", [
    ("corrupt.txt", "ValueError"),
    ("w_badshape.txt", "serving contract")])
def test_reload_failure_keeps_old_weights(reload_loop, target, want):
    """A load that fails, or a model whose input contract differs, ends
    in ``error`` at generation 0; the old weights keep serving and a later
    good reload succeeds."""
    url, root, _, _, _ = reload_loop
    (root / "corrupt.txt").write_text("not-a-float")
    code, _ = _post_json(url + "/v1/reload", {"target": str(root / target)})
    assert code == 202
    st = _wait_state(url, ("error", "serving"))
    assert st["state"] == "error" and want in st["error"], st
    assert st["generation"] == 0
    x = np.ones((2, 4, 4), np.float32)
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x),
                               x.sum(axis=(1, 2)), rtol=1e-6)
    code, _ = _post_json(url + "/v1/reload", {"target": str(root / "w3.txt")})
    assert code == 202
    assert _wait_state(url, ("serving",))["generation"] == 1
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x),
                               3 * x.sum(axis=(1, 2)), rtol=1e-6)


def test_second_reload_while_one_runs_is_409(reload_loop):
    url, root, _, _, release = reload_loop
    code, _ = _post_json(url + "/v1/reload", {"target": str(root / "hold.txt")})
    assert code == 202
    code, body = _post_json(url + "/v1/reload",
                            {"target": str(root / "w3.txt")})
    assert code == 409 and "in progress" in body["error"]
    assert body["state"] == "loading"
    x = np.ones((1, 4, 4), np.float32)  # old weights serve meanwhile
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x), [16.0])
    release.set()
    assert _wait_state(url, ("serving",))["generation"] == 1
    np.testing.assert_allclose(_post_npy(url + "/v1/predict", x), [32.0])


def test_reload_in_flight_requests_served_by_one_weight_set():
    """Requests racing a reload are each served entirely by the old or the
    new weights: the dispatch thread reads ``batcher.fn`` once per group
    and the swap is one attribute store. Also the 409 while busy."""
    b = server.DynamicBatcher(_sum, max_batch=4, max_delay_ms=0.5,
                              dtype=np.float32, sample_shape=(4, 4))
    hold = threading.Event()

    def build(target, int8):
        hold.wait(30)  # stretch the load across live traffic
        return (lambda x: (torch.from_numpy(x).sum(dim=(1, 2)) * 3.0)
                .numpy()), (4, 4), np.float32

    r = server.Reloader(b, build, root="/", device="cpu")
    results, res_lock = [], threading.Lock()
    stop_traffic = threading.Event()

    def client(i):
        rng = np.random.default_rng(i)
        while not stop_traffic.is_set():
            x = rng.uniform(0.5, 1.5, size=(2, 4, 4)).astype(np.float32)
            ratio = b.submit(x, timeout=30) / x.sum(axis=(1, 2))
            with res_lock:
                results.append(ratio)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        code, _ = r.request("/", None)
        assert code == 202
        code2, body2 = r.request("/", None)
        assert code2 == 409 and "in progress" in body2["error"]
        time.sleep(0.3)  # traffic against the old weights while loading
        assert r.status()["state"] in ("loading", "compiling")
        hold.set()
        deadline = time.time() + 60
        while r.status()["generation"] < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert r.status()["generation"] == 1
        time.sleep(0.3)  # traffic against the new weights
    finally:
        hold.set()
        stop_traffic.set()
        for t in threads:
            t.join(timeout=30)
        b.close()
    assert not any(t.is_alive() for t in threads)
    flat = np.concatenate(results)
    old = np.isclose(flat, 1.0, rtol=1e-4)
    new = np.isclose(flat, 3.0, rtol=1e-4)
    assert np.all(old | new), "a request saw a mixed weight set"
    assert old.any() and new.any(), "the swap window was not exercised"


def test_reload_root_slash_accepts_targets_under_it(tmp_path):
    """A root of ``/`` admits an absolute target under it (the prefix is
    ``/``, not ``//``); the 202 body is the state before the worker
    starts."""
    b = server.DynamicBatcher(_sum, max_batch=4, max_delay_ms=0.5,
                              dtype=np.float32, sample_shape=(4, 4))

    def build(target, int8):
        return _sum, (4, 4), np.float32

    r = server.Reloader(b, build, root="/")
    try:
        w = tmp_path / "w.txt"
        w.write_text("1.0")
        code, body = r.request(str(w), None)
        assert code == 202, body
        assert body["state"] == "loading" and body["generation"] == 0
        assert body["root"] == "/"
        deadline = time.time() + 60
        while (r.status()["state"] not in ("serving", "error")
               and time.time() < deadline):
            time.sleep(0.02)
        st = r.status()
        assert st["state"] == "serving" and st["generation"] == 1, st
    finally:
        b.close()


def test_reload_warms_every_bucket_before_the_swap():
    """The new fn runs each bucket once on the reloader thread before it
    is swapped in; the dispatch thread never calls it cold."""
    b = server.DynamicBatcher(_sum, max_batch=6, max_delay_ms=0.5,
                              dtype=np.float32, sample_shape=(4, 4))
    seen = []

    def new_fn(x):
        seen.append((len(x), threading.current_thread().name,
                     b.fn is new_fn))
        return 2 * _sum(x)

    r = server.Reloader(b, lambda target, int8: (new_fn, (4, 4), np.float32),
                        root="/", device="cpu")
    try:
        assert r.request("/", None)[0] == 202
        deadline = time.time() + 60
        while r.status()["generation"] < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert seen == [(n, "reloader", False) for n in (1, 2, 4, 6)]
        np.testing.assert_allclose(b.submit(np.ones((1, 4, 4), np.float32)),
                                   [32.0])
        assert seen[-1] == (1, "batcher-dispatch", True)
    finally:
        b.close()


def test_client_reload_helper(reload_loop, live_loop):
    """The port's ``ServingClient.reload``: POST and poll to the new
    generation; a failure on the daemon raises ServingError and the old
    weights keep serving; a bad target and a daemon without reload raise
    BadRequestError; a reload in flight is a RetryableError (409); the
    ``--reload`` CLI."""
    from protoasnet_tpu_torch import client as client_mod

    url, root, _, _, release = reload_loop
    c = ServingClient(url, timeout_s=60, retries=0)
    st = c.reload_status()
    assert st["state"] == "idle" and st["generation"] == 0
    x = np.random.default_rng(0).normal(size=(2, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(c.predict(x), x.sum(axis=(1, 2)), rtol=1e-5)
    st = c.reload(str(root / "w3.txt"), poll_s=0.05)
    assert st["state"] == "serving" and st["generation"] == 1
    np.testing.assert_allclose(c.predict(x), 3 * x.sum(axis=(1, 2)),
                               rtol=1e-5)
    (root / "corrupt.txt").write_text("not-a-float")
    with pytest.raises(ServingError, match="failed server-side"):
        c.reload(str(root / "corrupt.txt"), poll_s=0.05)
    np.testing.assert_allclose(c.predict(x), 3 * x.sum(axis=(1, 2)),
                               rtol=1e-5)
    with pytest.raises(BadRequestError):
        c.reload(str(root / "nope.txt"))
    accepted = c.reload(str(root / "hold.txt"), wait=False)
    assert accepted["state"] == "loading" and accepted["generation"] == 1
    with pytest.raises(RetryableError) as ei:
        c.reload(str(root / "w1.txt"))
    assert ei.value.status == 409
    release.set()
    _wait_state(url, ("serving",))
    with pytest.raises(BadRequestError) as ei:
        ServingClient(live_loop, retries=0).reload_status()
    assert ei.value.status == 403
    client_mod.main(["--url", url, "--reload", str(root / "w1.txt")])
    assert c.reload_status()["generation"] == 3
    np.testing.assert_allclose(c.predict(x), x.sum(axis=(1, 2)), rtol=1e-5)


CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32, "head_impl": "xla"}
SAMPLE = (8, 32, 32, 3)


def test_bundle_reload_between_two_port_bundles(tmp_path):
    """``serve_forever(allow_reload=True)`` on one port bundle, reloaded
    to another: before and after, the served logits equal the serving
    bundle's own forward on the same batch."""
    paths = []
    for seed in (1, 2):
        path = str(tmp_path / f"b{seed}.zip")
        save_serving_bundle(path, build_model(CFG, device="cpu", seed=seed),
                            CFG, SAMPLE)
        paths.append(path)
    x = np.random.default_rng(3).normal(size=(2, *SAMPLE)).astype(np.float32)
    want = [load_serving_bundle(p, device="cpu")(x) for p in paths]
    assert np.abs(want[0] - want[1]).max() > 1e-3
    url, stop, t = _start(server.serve_forever, paths[0], host="127.0.0.1",
                          port=0, max_batch=2, max_delay_ms=2.0,
                          warmup=False, device="cpu", allow_reload=True)
    try:
        c = ServingClient(url, timeout_s=120, retries=0)
        np.testing.assert_array_equal(c.predict(x), want[0])
        st = c.reload(paths[1], poll_s=0.05)
        assert st["generation"] == 1 and st["root"] == str(tmp_path)
        np.testing.assert_array_equal(c.predict(x), want[1])
        assert c.stats()["errors"] == 0
    finally:
        _stop(stop, t)


def test_listen_backlog_holds_many_waiting_connections():
    """The daemon's socket takes 32 connections that nobody has accepted
    yet (ThreadingHTTPServer's default backlog of 5 drops the 7th
    handshake, which costs its client a TCP retransmission of 1 s or more;
    the reload under traffic on the card waited 63 s on one)."""
    import socket

    b = server.DynamicBatcher(_sum, max_batch=1)
    httpd = server._HTTPServer(("127.0.0.1", 0),
                               server.make_handler(b, sample_ndim=2))
    conns = []
    try:
        for _ in range(32):  # the server never accepts: all wait queued
            conns.append(socket.create_connection(httpd.server_address,
                                                  timeout=0.5))
    finally:
        for c in conns:
            c.close()
        httpd.server_close()
        b.close()
    assert len(conns) == 32


def _time_wait_ports():
    """(local, remote) ports of the IPv4 sockets in TIME_WAIT."""
    with open("/proc/net/tcp") as f:
        rows = [line.split() for line in f.readlines()[1:]]
    return [(int(r[1].split(":")[1], 16), int(r[2].split(":")[1], 16))
            for r in rows if r[3] == "06"]


def test_connections_end_in_time_wait_on_the_client(live_loop):
    """The daemon closes a connection after its client has, so the
    minute of TIME_WAIT stays with the client's port, which its allocator
    skips; when the daemon closed first, a client reusing that port
    stalled 63 s in the handshake on the card's machine."""
    port = int(live_loop.rsplit(":", 1)[1])
    # a server bound earlier to the same port number may have left some
    before = {p for p in _time_wait_ports() if p[0] == port}
    x = np.ones((2, 4, 4), np.float32)
    for _ in range(20):  # one connection each (urllib sends close)
        np.testing.assert_allclose(_post_npy(live_loop + "/v1/predict", x),
                                   [16.0, 16.0])
        _get_json(live_loop + "/v1/stats")
    time.sleep(0.2)  # the last closes
    tw = _time_wait_ports()
    assert sum(remote == port for _, remote in tw) >= 30  # the clients'
    assert {p for p in tw if p[0] == port} <= before  # none new here
