"""The five readers of the program's spans (``perfbench/spans.py``), each
fed a recorder filled by hand: each returns its definition's value over
the spans that ended inside the window, and None when no span of its kind
was recorded or the program has no recorder (a parent commit's)."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from perfbench import run as harness
from protoasnet_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[2]


T0 = 1_000_000_000


def _span(name, ms, sid, parent=None, at_ms=0.0, **counts):
    start = T0 + int(at_ms * 1e6)
    return {"name": name, "id": sid, "parent": parent, "thread": "t",
            "start_ns": start, "end_ns": start + int(ms * 1e6), "ids": {},
            "counts": counts, "sites": []}


# the bulk cell's window in small: 2 batches, 3 requests
BULK = [_span("batcher.batch", 60.0, 1), _span("batcher.batch", 50.0, 2),
        _span("batcher.assemble", 12.0, 3, 1),
        _span("batcher.assemble", 18.0, 4, 2),
        _span("serve.h2d", 7.0, 5, 1), _span("serve.h2d", 9.0, 6, 2),
        _span("http.decode", 20.0, 7), _span("http.decode", 30.0, 8),
        _span("http.decode", 40.0, 9)]
# twenty queue waits of 1..20 ms: the nearest-rank p95 is the 19th
QUEUE = [_span("batcher.queue", float(i), 100 + i, 1)
         for i in range(20, 0, -1)]
TRAIN = [_span("train.step", 100.0, 1, syncs=4),
         _span("train.step", 100.0, 2, syncs=3), _span("train.step", 90.0, 3)]

CASES = [("decode_ms.throughput", BULK, 30.0),
         ("assemble_ms.throughput", BULK, 15.0),
         ("h2d_ms.throughput", BULK, 8.0),
         ("queue_wait_ms.latency", QUEUE, 19.0),
         ("syncs_per_step.train", TRAIN, 7 / 3)]


@pytest.mark.parametrize("metric, recorded, want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_returns_its_definition(monkeypatch, metric, recorded, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    got = harness.reader(REPO, metric).read({})
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_reader_gives_none_without_its_spans(monkeypatch, metric):
    mod = harness.reader(REPO, metric)
    others = [s for s in BULK + QUEUE + TRAIN
              if s["name"] not in ("http.decode", "batcher.assemble",
                                   "serve.h2d", "batcher.queue",
                                   "train.step")]
    monkeypatch.setattr(profiling, "spans", lambda: list(others))
    assert mod.read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert mod.read({}) is None


def test_per_batch_readers_need_the_batches(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in BULK if s["name"] != "batcher.batch"])
    for metric in ("assemble_ms.throughput", "h2d_ms.throughput"):
        assert harness.reader(REPO, metric).read({}) is None


# a 1-s window (from the first span): the batch in flight at its close, its
# parts, a late request and a late micro-step fall outside
LATE = [_span("batcher.batch", 600.0, 50, at_ms=700.0),
        _span("batcher.assemble", 5.0, 51, 50, at_ms=700.0),
        _span("serve.h2d", 900.0, 52, 50, at_ms=705.0),
        _span("http.decode", 400.0, 53, at_ms=900.0),
        _span("batcher.queue", 99.0, 54, 50, at_ms=950.0),
        _span("train.step", 100.0, 55, at_ms=950.0, syncs=40)]


@pytest.mark.parametrize("metric, recorded, want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_keeps_the_spans_that_ended_in_the_window(
        monkeypatch, metric, recorded, want):
    monkeypatch.setattr(profiling, "spans", lambda: recorded + LATE)
    got = harness.reader(REPO, metric).read({"window_s": 1.0})
    assert got == pytest.approx(want, rel=1e-9)


def test_readers_read_the_recorder_a_profiler_filled():
    """End to end through the recorder: an HTTP decode span recorded under
    a CPU profiler reads back as its own duration."""
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.interval("http.decode", 0, 25_000_000)
        got = harness.reader(REPO, "decode_ms.throughput").read({})
    finally:
        profiling.reset()
    assert got == pytest.approx(25.0)
