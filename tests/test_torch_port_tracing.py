"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- Off (no profiler open): a served request, through the HTTP front end,
  and a train micro-step record nothing and open no profiler range.
- On (a CPU ``torch.profiler.profile`` open): one ``batcher.queue`` per
  chunk, each under a ``batcher.batch`` the dispatch thread recorded, with
  three client threads; a lone request waits at least ``max_delay_ms``;
  one ``http.decode`` per HTTP request, its id carried by the request's
  queue spans; ``serve.h2d`` under its batch; one ``train.step`` per
  micro-step with no ``syncs`` on the CPU.
- The clock: a span and its range's profiler event agree within 1 ms; the
  range is a host event only (no user annotation to mirror on a device).
- The switch: ``torch.autograd.profiler._is_profiler_enabled`` exists and
  follows an open profiler (the recorder reads it).
- The recorder: its cap, ``count`` on the innermost span, the sync
  counter's call sites; ``server.py`` still loads no torch at import.
"""

import io
import os
import subprocess
import sys
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.serve import make_serving_fn
from protoasnet_tpu_torch.utils import profiling
from torch_port_isolation import isolated

_isolated = isolated(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


class _Tiny(torch.nn.Module):
    """A serving model of one parameter: logits = the first 4 values of
    each sample."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        return (x.flatten(1)[:, :4] * self.w,)


def _by_name(name):
    return [s for s in profiling.spans() if s["name"] == name]


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return np.load(io.BytesIO(r.read()))


def _served(batcher, fn):
    """``fn(url)`` against ``batcher`` behind the HTTP front end."""
    httpd = server._HTTPServer(("127.0.0.1", 0),
                               server.make_handler(batcher, sample_ndim=2))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        fn(f"http://127.0.0.1:{httpd.server_address[1]}/v1/predict")
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def _train_step():
    """A tiny float32 video XProtoNet's train step on the CPU and its
    arguments."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    cfg = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4, "img_size": 32, "dtype": "float32"}
    model = build_model(cfg, device="cpu", seed=0)
    opt = GroupAdam(model, {g: 1e-3 for g in GROUPS})
    step, _, _ = make_xprotonet_steps(
        model, LossBundle({"CeLossAbstain": {"loss_weight": 1,
                                             "ab_weight": 0.3},
                           "trans_occurrence": {"loss_weight": 0.1}},
                          num_classes=4, abstain_class=True),
        opt, GradAccumulator(opt.params, 2))
    x = torch.randn((2, 8, 32, 32, 3),
                    generator=torch.Generator().manual_seed(1))
    args = (x, torch.tensor([0, 2]), torch.tensor([True, True]),
            {g: 1e-3 for g in GROUPS})
    return lambda: step(*args, affine=(7.0, 1.2))


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(*a, **kw):
        raise AssertionError("a profiler range was opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    assert not profiling.tracing()
    b = server.DynamicBatcher(make_serving_fn(_Tiny()), max_batch=4,
                              max_delay_ms=1, sample_shape=(2, 3))
    try:
        x = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
        _served(b, lambda url: np.testing.assert_allclose(
            _post(url, x), x.reshape(1, -1)[:, :4]))
    finally:
        b.close()
    out = _train_step()()
    assert torch.isfinite(out["loss_all"])
    with profiling.span("a.span", k=1) as s:
        profiling.count("n")
    assert s is None
    profiling.interval("a.wait", 0, 1)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_three_client_threads_give_one_queue_span_per_chunk():
    sizes = {0: 3, 1: 5, 2: 1}  # chunks of at most 2: 2 + 3 + 1
    b = server.DynamicBatcher(make_serving_fn(_Tiny()), max_batch=2,
                              max_delay_ms=2, sample_shape=(4,))
    errors = []

    def client(i):
        try:
            x = np.full((sizes[i], 4), float(i), np.float32)
            np.testing.assert_allclose(b.submit_many(x, request=100 + i), x)
        except BaseException as e:  # noqa: BLE001 — read in the test
            errors.append(e)

    with _profiled():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in sizes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    b.close()
    assert not errors and not any(t.is_alive() for t in threads)
    batches = {s["id"]: s for s in _by_name("batcher.batch")}
    queue = _by_name("batcher.queue")
    assert len(queue) == 6
    assert sorted(s["ids"]["request"] for s in queue) == \
        [100, 100, 101, 101, 101, 102]
    assert all(s["parent"] in batches for s in queue)
    assert {s["thread"] for s in batches.values()} == {"batcher-dispatch"}
    assert sum(s["ids"]["samples"] for s in batches.values()) == 9
    assemble = _by_name("batcher.assemble")
    assert sorted(s["parent"] for s in assemble) == sorted(batches)
    for s in queue:  # the wait ends where its batch's serving call starts
        a = next(x for x in assemble if x["parent"] == s["parent"])
        assert s["start_ns"] <= s["end_ns"] and a["end_ns"] <= s["end_ns"]
        assert s["end_ns"] <= batches[s["parent"]]["end_ns"]


def test_a_lone_request_waits_at_least_the_delay():
    b = server.DynamicBatcher(make_serving_fn(_Tiny()), max_batch=8,
                              max_delay_ms=40, sample_shape=(4,))
    with _profiled():
        b.submit(np.ones((1, 4), np.float32))
    b.close()
    (q,) = _by_name("batcher.queue")
    assert q["end_ns"] - q["start_ns"] >= 40e6
    assert q["ids"]["request"] is None


def test_http_front_end_gives_one_decode_span_per_request():
    b = server.DynamicBatcher(make_serving_fn(_Tiny()), max_batch=4,
                              max_delay_ms=1, sample_shape=(2, 3))
    xs = [np.full((n, 2, 3), n, np.float32) for n in (1, 2, 6)]

    def post_all(url):
        for x in xs:
            _post(url, x)
        _post(url, xs[0][0])  # one sample without its batch axis

    try:
        with _profiled():
            _served(b, post_all)
    finally:
        b.close()
    decode = _by_name("http.decode")
    assert len(decode) == 4 and len({s["id"] for s in decode}) == 4
    assert all(s["thread"] != "batcher-dispatch" for s in decode)
    # the 6-sample request is two chunks; each chunk carries its request
    requests = sorted(s["ids"]["request"] for s in _by_name("batcher.queue"))
    ids = sorted(s["id"] for s in decode)
    assert requests == sorted(ids + [ids[2]])


def test_serving_fn_records_its_h2d_copy_under_the_batch():
    b = server.DynamicBatcher(make_serving_fn(_Tiny()), max_batch=4,
                              max_delay_ms=1, sample_shape=(4,))
    with _profiled():
        b.submit(np.ones((3, 4), np.float32))
    b.close()
    (batch,) = _by_name("batcher.batch")
    (h2d,) = _by_name("serve.h2d")
    assert batch["ids"] == {"samples": 3, "bucket": 4}
    assert h2d["parent"] == batch["id"]
    assert batch["start_ns"] <= h2d["start_ns"] <= h2d["end_ns"] \
        <= batch["end_ns"]


def test_train_step_gives_one_span_per_micro_step():
    step = _train_step()
    step()  # unprofiled: not recorded
    with _profiled():
        for _ in range(2):
            step()
    spans = _by_name("train.step")
    assert [s["ids"]["step"] for s in spans] == [1, 2]
    assert all(s["counts"].get("syncs", 0) == 0 and s["sites"] == []
               for s in spans)
    assert all(s["parent"] is None for s in spans)


def test_span_and_its_profiler_range_share_the_clock():
    with _profiled() as prof:
        with profiling.span("clock.outer") as outer:
            with profiling.span("clock.probe", k=3) as probe:
                time.sleep(0.01)
    assert probe.parent == outer.id
    (rec,) = [s for s in profiling.spans() if s["name"] == "clock.probe"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "clock.probe"]
    assert not ev.is_user_annotation()
    end = ev.start_ns() + ev.duration_ns()
    assert abs(rec["start_ns"] - ev.start_ns()) < 1e6
    assert abs(rec["end_ns"] - end) < 1e6
    assert rec["end_ns"] - rec["start_ns"] >= 10e6


def test_the_switch_is_the_profiler_module_flag():
    """The recorder's switch; if torch drops or renames this flag, every
    span goes silent."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    assert not profiling.tracing()
    seen = {}
    with _profiled():
        assert autograd_profiler._is_profiler_enabled is True
        t = threading.Thread(
            target=lambda: seen.setdefault("other", profiling.tracing()))
        t.start()
        t.join(timeout=10)
        assert profiling.tracing()
    assert seen == {"other": True} and not profiling.tracing()


def test_count_adds_to_the_innermost_span_and_the_cap_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    profiling.count("lost")  # no span open: nothing
    with _profiled():
        with profiling.span("outer"):
            profiling.count("n", 2)
            with profiling.span("inner"):
                profiling.count("n", site="here:1")
                profiling.count("n")
        for i in range(2):
            profiling.interval("extra", i, i + 1, parent=7, k=i)
    got = {s["name"]: s for s in profiling.spans()}
    assert set(got) == {"outer", "inner", "extra"}
    assert got["outer"]["counts"] == {"n": 2}
    assert got["inner"]["counts"] == {"n": 2}
    assert got["inner"]["sites"] == ["here:1"]
    assert got["extra"]["parent"] == 7 and got["extra"]["ids"] == {"k": 0}
    assert profiling.dropped() == 1


def test_sync_warnings_count_with_their_call_site(monkeypatch):
    """The counter's mechanics without a card: the sync debug mode is set
    and restored, each sync warning adds 1 to ``syncs`` with the caller's
    line, other warnings pass on."""
    modes, shown = [], []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **kw: shown.append(str(message)))

    def synchronising_op():
        warnings.warn(profiling._SYNC_WARNING)

    with _profiled():
        with profiling.span("step"):
            with profiling.counting_syncs(torch.device("cuda")):
                synchronising_op()
                synchronising_op()
                warnings.warn("other", RuntimeWarning)
    assert modes == ["warn", 0] and shown == ["other"]
    (s,) = profiling.spans()
    assert s["counts"] == {"syncs": 2}
    assert len(s["sites"]) == 2 and all(
        "test_torch_port_tracing.py" in x and "synchronising_op" in x
        for x in s["sites"])
    assert profiling.counting_syncs(torch.device("cpu")) is profiling._OFF


def test_server_import_loads_no_torch():
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, protoasnet_tpu_torch.server; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] == "
         "'torch'))"], cwd=str(REPO), capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
