"""The reader of ``aligned_trunk_pct.throughput``, fed a recorder filled by
hand: the share of the window's ``batcher.batch`` spans whose counts hold
``serve.aligned_trunk``, and None when no batch was recorded or the program
has no recorder (a parent commit's)."""

from __future__ import annotations

import pytest

from perfbench import run as harness
from perfbench.tests.test_perfbench_spans import BULK, REPO
from protoasnet_tpu_torch.utils import profiling

METRIC = "aligned_trunk_pct.throughput"

# the bulk cell's batches served through the channel-aligned trunk: the
# serving function counts ``serve.aligned_trunk`` on each batch's span
ALIGNED = [dict(s, counts={"serve.aligned_trunk": 1})
           if s["name"] == "batcher.batch" else s for s in BULK]
SHARES = [("counted", ALIGNED, 100.0), ("not_counted", BULK, 0.0),
          ("half", ALIGNED[:1] + BULK[1:], 50.0)]


@pytest.mark.parametrize("recorded, want", [c[1:] for c in SHARES],
                         ids=[c[0] for c in SHARES])
def test_aligned_trunk_share(monkeypatch, recorded, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    got = harness.reader(REPO, METRIC).read({"window_s": 1.0})
    assert got == pytest.approx(want, rel=1e-9)


def test_aligned_trunk_share_needs_the_batches(monkeypatch):
    mod = harness.reader(REPO, METRIC)
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in ALIGNED if s["name"] != "batcher.batch"])
    assert mod.read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert mod.read({}) is None
