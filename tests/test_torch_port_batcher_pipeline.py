"""The port's two-thread batcher (``server.DynamicBatcher``) on the CPU.

The assembly thread copies each request's rows into one of two resident
buffers as the request joins its group; the dispatch thread serves the
sealed group from that buffer while the next one fills.

- Under concurrent traffic of mixed sizes over many batches every request
  gets its own rows back, from at most two buffers allocated once at
  construction (through ``fn.host_buffer`` where ``fn`` offers it), or
  from a fresh array per group without a ``sample_shape``; ``fn`` runs
  only on ``batcher-dispatch``.
- ``fn`` sees zeroed padding rows, whatever a buffer held before.
- With ``fn`` blocked, the next full group is sealed into the hand-off and
  its batch counts ``batcher.assembled_ahead`` (the first one
  ``batcher.assembled_inline``); its ``batcher.assemble`` span ends before
  the batch ahead of it does.
- A failing ``fn`` call fails its own group's waiters only; a dispatch
  thread that dies fails every waiter (the group served, the sealed group,
  the queue); ``close()`` serves what it accepted, and fails whoever still
  waits after its 10 s join.
- A group whose waiters all gave up never reaches ``fn``; one whose waiters
  partly gave up reaches it with the live rows packed again.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.serve import make_serving_fn
from protoasnet_tpu_torch.utils import profiling

SAMPLE = (3,)


def _echo(x):
    """The serving function of these tests: each row back, as float32."""
    return x.astype(np.float32)


def _rows(tag, n):
    """n rows no other request has: (tag, row, 0.5)."""
    return np.stack([np.full(n, float(tag)), np.arange(n, dtype=np.float64),
                     np.full(n, 0.5)], axis=1).astype(np.float32)


def _wait_for(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


class _Gate:
    """A serving function that records each call's thread and rows and
    blocks its first call until ``release``."""

    def __init__(self, fail_on=None):
        self.calls = []
        self.entered = threading.Event()
        self.gate = threading.Event()
        self.fail_on = fail_on

    def __call__(self, x):
        self.calls.append((threading.current_thread().name, x.copy()))
        self.entered.set()
        self.gate.wait(30)
        if self.fail_on is not None and (x == self.fail_on).any():
            raise ValueError("a bad batch")
        return _echo(x)

    def release(self):
        self.gate.set()


def _submit_in_thread(b, x, out, key, timeout=None):
    def run():
        try:
            out[key] = b.submit(x, timeout=timeout)
        except BaseException as e:  # noqa: BLE001 — read by the test
            out[key] = e

    t = threading.Thread(target=run)
    t.start()
    return t


class _Tiny(torch.nn.Module):
    """logits = each sample's values."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        return (x.flatten(1) * self.w,)


def _plain():
    return _echo


def _offering():
    def fn(x):
        return _echo(x)

    fn.made = []

    def host_buffer(shape, dtype):
        fn.made.append((tuple(shape), np.dtype(dtype)))
        return np.empty(shape, dtype)

    fn.host_buffer = host_buffer
    return fn


def _serving_fn():
    fn = make_serving_fn(_Tiny())
    made, offered = [], fn.host_buffer

    def host_buffer(shape, dtype):
        buf = offered(shape, dtype)
        assert buf.shape == tuple(shape) and buf.dtype == np.dtype(dtype)
        assert buf.flags.writeable and buf.flags.c_contiguous
        made.append((tuple(shape), np.dtype(dtype)))
        return buf

    fn.host_buffer, fn.made = host_buffer, made
    return fn


@pytest.mark.parametrize("make_fn, sample_shape", [
    (_plain, SAMPLE), (_offering, SAMPLE), (_offering, None),
    (_serving_fn, SAMPLE)],
    ids=["plain", "host_buffer", "host_buffer-no-sample-shape",
         "make_serving_fn"])
def test_every_request_gets_its_own_rows_from_two_reused_buffers(
        make_fn, sample_shape):
    inner = make_fn()
    seen = []

    def fn(x):
        seen.append((threading.current_thread().name,
                     x.__array_interface__["data"][0]))
        return inner(x)

    if hasattr(inner, "host_buffer"):
        fn.host_buffer = inner.host_buffer
    b = server.DynamicBatcher(fn, max_batch=8, max_delay_ms=1.0,
                              sample_shape=sample_shape)
    errors, switch = [], sys.getswitchinterval()

    def client(c):
        rng = np.random.default_rng(c)
        try:
            for i in range(25):
                n = int(rng.integers(1, 13))  # > 8: submit_many splits it
                x = _rows(1000 * c + i, n)
                np.testing.assert_array_equal(b.submit_many(x, timeout=30),
                                              _echo(x))
        except BaseException as e:  # noqa: BLE001 — read in the test
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(12)]
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(seen) == b.stats.snapshot()["batches"] > 20
    assert {name for name, _ in seen} == {"batcher-dispatch"}
    if sample_shape is not None:
        assert len({ptr for _, ptr in seen}) <= 2
    if hasattr(inner, "made"):
        # no resident buffers without a sample_shape: nothing is asked for
        assert inner.made == ([((8, *SAMPLE), np.dtype(np.float32))] * 2
                              if sample_shape is not None else [])


def test_a_buffer_is_allocated_at_construction_when_the_shape_is_known():
    fn = _offering()
    b = server.DynamicBatcher(fn, max_batch=6, buckets=(2, 8),
                              dtype=np.uint8, sample_shape=(2, 2))
    try:
        assert fn.made == [((8, 2, 2), np.dtype(np.uint8))] * 2
    finally:
        b.close()


@pytest.mark.parametrize("n, bucket", [(3, 4), (5, 8), (1, 1)])
def test_fn_sees_zeroed_padding_rows_in_a_used_buffer(n, bucket):
    calls = []

    def fn(x):
        calls.append(x.copy())
        return _echo(x)

    b = server.DynamicBatcher(fn, max_batch=8, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    try:
        for i in range(4):  # both buffers full of rows first
            b.submit(_rows(i + 1, 8))
        x = _rows(9, n)
        np.testing.assert_array_equal(b.submit(x), _echo(x))
    finally:
        b.close()
    last = calls[-1]
    assert len(last) == bucket
    np.testing.assert_array_equal(last[:n], x)
    assert not last[n:].any()


def test_the_next_group_is_sealed_while_fn_runs():
    fn = _Gate()
    b = server.DynamicBatcher(fn, max_batch=2, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    out = {}
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            first = _submit_in_thread(b, _rows(1, 2), out, "a")
            assert fn.entered.wait(10)
            second = _submit_in_thread(b, _rows(2, 2), out, "b")
            _wait_for(lambda: b._sealed is not None, "the sealed group")
            fn.release()
            for t in (first, second):
                t.join(timeout=30)
        spans = profiling.spans()
    finally:
        fn.release()
        b.close()
        profiling.reset()
    np.testing.assert_array_equal(out["a"], _rows(1, 2))
    np.testing.assert_array_equal(out["b"], _rows(2, 2))
    batches = sorted((s for s in spans if s["name"] == "batcher.batch"),
                     key=lambda s: s["start_ns"])
    assert [s["counts"] for s in batches] == [
        {"batcher.assembled_inline": 1}, {"batcher.assembled_ahead": 1}]
    assemble = {s["parent"]: s for s in spans
                if s["name"] == "batcher.assemble"}
    assert sorted(assemble) == sorted(s["id"] for s in batches)
    assert all(s["thread"] == "batcher-dispatch" for s in batches)
    later = assemble[batches[1]["id"]]
    assert 0 <= later["end_ns"] - later["start_ns"] < 1e9
    assert later["end_ns"] < batches[0]["end_ns"]


def test_a_failing_call_fails_only_its_own_group():
    fn = _Gate(fail_on=-1.0)
    fn.release()
    b = server.DynamicBatcher(fn, max_batch=2, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    out, bad = {}, _rows(-1, 2)
    try:
        threads = [_submit_in_thread(b, x, out, k) for k, x in
                   (("good0", _rows(1, 2)), ("bad", bad),
                    ("good1", _rows(2, 2)))]
        for t in threads:
            t.join(timeout=30)
        assert b.healthy
        np.testing.assert_array_equal(b.submit(_rows(3, 1)), _rows(3, 1))
    finally:
        b.close()
    assert isinstance(out["bad"], ValueError)
    np.testing.assert_array_equal(out["good0"], _rows(1, 2))
    np.testing.assert_array_equal(out["good1"], _rows(2, 2))
    assert b.stats.snapshot()["errors"] == 1


def _three_places(b, fn):
    """A served group (in fn), a sealed one (in the hand-off) and a queued
    one: each a request of max_batch rows in a thread of its own."""
    out = {}
    threads = [_submit_in_thread(b, _rows(1, 2), out, "served")]
    assert fn.entered.wait(10)
    threads.append(_submit_in_thread(b, _rows(2, 2), out, "sealed"))
    _wait_for(lambda: b._sealed is not None, "the sealed group")
    threads.append(_submit_in_thread(b, _rows(3, 2), out, "queued"))
    _wait_for(lambda: len(b._queue) == 1, "the queued request")
    return out, threads


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dead_dispatch_thread_fails_every_waiter():
    fn = _Gate()
    b = server.DynamicBatcher(fn, max_batch=2, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    try:
        out, threads = _three_places(b, fn)

        def boom(g):
            # die once the next group is sealed and another queued
            _wait_for(lambda: b._sealed is not None and b._queue,
                      "the hand-off and the queue")
            raise RuntimeError("boom")

        b._serve = boom
        threads.append(_submit_in_thread(b, _rows(4, 2), out, "late"))
        _wait_for(lambda: len(b._queue) == 2, "the late request")
        fn.release()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_array_equal(out["served"], _rows(1, 2))
        for k in ("sealed", "queued", "late"):
            assert isinstance(out[k], RuntimeError), out[k]
            assert "dispatch thread died" in str(out[k])
        assert not b.healthy
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(_rows(5, 1), timeout=1)
        for t in b._threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in b._threads)
    finally:
        fn.release()
        b.close()


def test_close_fails_whoever_still_waits_after_its_join():
    fn = _Gate()
    b = server.DynamicBatcher(fn, max_batch=2, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    try:
        out, threads = _three_places(b, fn)
        t0 = time.monotonic()
        b.close()  # fn stays blocked past the 10 s join
        assert 9.5 < time.monotonic() - t0 < 20
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        for k in ("served", "sealed", "queued"):
            assert isinstance(out[k], RuntimeError), out[k]
            assert "batcher closed" in str(out[k])
        fn.release()  # the stuck call returns; nothing else reaches fn
        for t in b._threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in b._threads)
        assert len(fn.calls) == 1
    finally:
        fn.release()
        b.close()


def test_close_serves_every_request_it_accepted():
    def slow(x):
        time.sleep(0.01)
        return _echo(x)

    b = server.DynamicBatcher(slow, max_batch=2, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    out = {}
    threads = [_submit_in_thread(b, _rows(i, 2), out, i) for i in range(6)]
    _wait_for(lambda: b.stats.snapshot()["requests"] == 6, "the requests")
    b.close()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    for i in range(6):
        np.testing.assert_array_equal(out[i], _rows(i, 2))
    assert not any(t.is_alive() for t in b._threads)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_rows(9, 1))


@pytest.mark.parametrize("live", [0, 1], ids=["all-gave-up", "one-live"])
def test_rows_of_waiters_that_gave_up_never_reach_fn(live):
    fn = _Gate()
    b = server.DynamicBatcher(fn, max_batch=4, max_delay_ms=1.0,
                              sample_shape=SAMPLE)
    out = {}
    try:
        threads = [_submit_in_thread(b, _rows(1, 4), out, "busy")]
        assert fn.entered.wait(10)
        gave_up = _submit_in_thread(b, _rows(2, 1), out, "gave_up",
                                    timeout=0.1)
        _wait_for(lambda: b._filling is not None
                  and len(b._filling.pendings) == 1, "the first to join")
        if live:
            threads.append(_submit_in_thread(b, _rows(3, 1), out, "live"))
            _wait_for(lambda: len(b._filling.pendings) == 2,
                      "the second to join")
        gave_up.join(timeout=10)
        assert isinstance(out["gave_up"], TimeoutError)
        fn.release()
        for t in threads:
            t.join(timeout=30)
        np.testing.assert_array_equal(b.submit(_rows(4, 1)), _rows(4, 1))
    finally:
        fn.release()
        b.close()
    rows = [x for _, x in fn.calls]
    assert len(rows) == 2 + live
    np.testing.assert_array_equal(rows[0], _rows(1, 4))
    if live:
        np.testing.assert_array_equal(out["live"], _rows(3, 1))
        np.testing.assert_array_equal(rows[1], _rows(3, 1))  # bucket 1
    np.testing.assert_array_equal(rows[-1], _rows(4, 1))
    assert b.stats.snapshot()["abandoned"] == 1
