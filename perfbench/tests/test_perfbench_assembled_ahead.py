"""The reader of ``assembled_ahead_pct.throughput``, fed a recorder filled
by hand: of the window's ``batcher.batch`` spans, the share that count
``batcher.assembled_ahead`` among those that count it or
``batcher.assembled_inline``; None when no batch counted either (a parent
commit's batcher) or the program has no recorder."""

from __future__ import annotations

import pytest

from perfbench import run as harness
from perfbench.tests.test_perfbench_spans import BULK, LATE, REPO
from protoasnet_tpu_torch.utils import profiling

METRIC = "assembled_ahead_pct.throughput"

AHEAD = {"batcher.assembled_ahead": 1}
INLINE = {"batcher.assembled_inline": 1}


def _counted(*counts):
    """BULK's two batches with ``counts`` on them, in order."""
    it = iter(counts)
    return [dict(s, counts=next(it)) if s["name"] == "batcher.batch" else s
            for s in BULK]


SHARES = [("ahead", _counted(AHEAD, AHEAD), 100.0),
          ("inline", _counted(INLINE, INLINE), 0.0),
          ("mixed", _counted(INLINE, AHEAD), 50.0),
          ("one-uncounted", _counted({}, AHEAD), 100.0),
          ("parent", _counted({}, {}), None),
          ("late-batch-left-out", _counted(INLINE, AHEAD)
           + [dict(s, counts=INLINE) if s["name"] == "batcher.batch" else s
              for s in LATE], 50.0)]


@pytest.mark.parametrize("recorded, want", [c[1:] for c in SHARES],
                         ids=[c[0] for c in SHARES])
def test_assembled_ahead_share(monkeypatch, recorded, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    got = harness.reader(REPO, METRIC).read({"window_s": 1.0})
    assert got == (None if want is None else pytest.approx(want, rel=1e-9))


def test_assembled_ahead_share_needs_the_batches(monkeypatch):
    mod = harness.reader(REPO, METRIC)
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in _counted(AHEAD, AHEAD) if s["name"] != "batcher.batch"])
    assert mod.read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert mod.read({}) is None
