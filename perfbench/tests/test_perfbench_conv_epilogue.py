"""The reader of ``conv_epilogue_pct.throughput``, fed a recorder filled by
hand: of the window's ``batcher.batch`` spans' counts ``serve.conv_epilogue``
(through the kernel) and ``serve.conv_epilogue.plain`` (through the plain
route), the first's share; None when no batch counted either or the
program has no recorder (a parent commit's)."""

from __future__ import annotations

import pytest

from perfbench import run as harness
from perfbench.tests.test_perfbench_spans import BULK, REPO
from protoasnet_tpu_torch.utils import profiling

METRIC = "conv_epilogue_pct.throughput"


def _counted(*counts):
    """BULK's two batches with ``counts`` on them, in order."""
    it = iter(counts)
    return [dict(s, counts=next(it)) if s["name"] == "batcher.batch" else s
            for s in BULK]


KERNEL = {"serve.aligned_trunk": 1, "serve.conv_epilogue": 26}
PLAIN = {"serve.aligned_trunk": 1, "serve.conv_epilogue.plain": 26}
MIXED = {"serve.conv_epilogue": 20, "serve.conv_epilogue.plain": 6}
SHARES = [("kernel", _counted(KERNEL, KERNEL), 100.0),
          ("plain", _counted(PLAIN, PLAIN), 0.0),
          ("mixed", _counted(KERNEL, MIXED), 100.0 * 46 / 52),
          ("parent", _counted({"serve.aligned_trunk": 1},
                              {"serve.aligned_trunk": 1}), None)]


@pytest.mark.parametrize("recorded, want", [c[1:] for c in SHARES],
                         ids=[c[0] for c in SHARES])
def test_conv_epilogue_share(monkeypatch, recorded, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    got = harness.reader(REPO, METRIC).read({"window_s": 1.0})
    assert got == (None if want is None else pytest.approx(want, rel=1e-9))


def test_conv_epilogue_share_needs_the_batches(monkeypatch):
    mod = harness.reader(REPO, METRIC)
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in _counted(KERNEL, KERNEL) if s["name"] != "batcher.batch"])
    assert mod.read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert mod.read({}) is None
