"""The benchmark's additions for the Video Swin configuration: its kept FLOP
count against its own reference (found by the configuration's
``reference`` key), the window attention's bytes and FLOP by hand, the two
new readers on synthetic records, and the new cell's files run through
``perfbench.run.run_cell`` on the CPU at a tiny clip in a temporary copy of
the tree (the published widths, 8 frames of 32x32)."""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import run as harness
from perfbench.kernels import window_attn

REPO = Path(__file__).resolve().parents[2]
CELL = "swin.serve.bulk"
CONFIG = "protoasnet_video_swin3d_b"


def _entry():
    m = harness.manifest(REPO)
    return {c["name"]: c for c in m["configs"]}[CONFIG]


def _config():
    return json.loads((REPO / _entry()["file"]).read_text())


def test_kept_count_is_the_references():
    cfg = _config()
    ref = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    kept = json.loads((REPO / f"perfbench/reference/flops/{CONFIG}.json"
                       ).read_text())
    assert kept["serve_per_sample"] == ref.serve_flops(cfg, 2)
    assert ref.head_shape(cfg) == (16 * 7 * 7, 40, 256)


def test_window_attention_work_by_hand():
    cfg = _config()
    calls = window_attn.calls(cfg)
    # stage 1: 16x28x28 tokens in 2x4x4 windows of 392, 4 heads of 32;
    # stage 2: 16x14x14, 2x2x2 windows, 8 heads; stage 3: 16x7x7, the
    # window cut to 8x7x7 as it is, 2 windows, 16 heads
    assert calls == [(32, 392, 4, 32, 2535)] * 2 \
        + [(8, 392, 8, 32, 2535)] * 2 + [(2, 392, 16, 32, 2535)] * 18
    # one call of stage 1 at one clip: 128 (window, head) pairs
    assert window_attn.flops(128, 392, 32) == 128 * 4 * 392 * 392 * 32
    assert window_attn.bytes_moved(128, 392, 32, 2, 2535, 4) \
        == 128 * 4 * 392 * 32 * 2 + 2535 * 4 * 4
    peak = {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989.4e12}
    assert sum(w * h for w, _, h, _, _ in calls) == 960  # a clip's pairs
    # every call moves more bytes than the card's ridge (N/2 = 196 FLOP a
    # byte in bf16 against ~295): its bound is its bytes
    by_bytes = sum(window_attn.bytes_moved(w * h, n, d, 2, r, h)
                   for w, n, h, d, r in calls) / 3.35e12
    assert window_attn.bound_s(1, cfg, 2, peak) == pytest.approx(by_bytes)
    assert 960 * 4 * 392 * 392 * 32 / 989.4e12 < by_bytes


def _rec(kernels=None):
    rec = {"peaks": json.loads((REPO / "perfbench/peaks.json").read_text()),
           "device_name": "NVIDIA H100 80GB HBM3", "config": _config(),
           "buckets": {128: 3}, "kernels": kernels or {}, "window_s": 1.0}
    return rec


def test_roofline_reader():
    mod = harness.reader(REPO, "window_attn_roofline")
    assert mod.read(_rec()) is None  # no kernel in the trace
    assert mod.read(dict(_rec({"x": 1.0}), device_name="cpu")) is None
    bound = 3 * window_attn.bound_s(128, _config(), 2, _rec()["peaks"][
        "NVIDIA H100 80GB HBM3"])
    got = mod.read(_rec({"window_attn_kernel": bound * 4,
                         "other_kernel": 5.0}))
    assert got == pytest.approx(25.0)


def test_fused_share_reader(monkeypatch):
    from protoasnet_tpu_torch.utils import profiling

    mod = harness.reader(REPO, "window_attn_fused_pct.throughput")

    def batch(i, counts):
        return {"name": "batcher.batch", "id": i, "parent": None,
                "start_ns": i, "end_ns": i + 1, "counts": counts}

    fused = {"swin.window_attn": 22}
    cases = [([batch(1, fused), batch(2, fused)], 100.0),
             ([batch(1, fused), batch(2, {"swin.window_attn.plain": 22})],
              50.0),
             ([batch(1, {"serve.aligned_trunk": 1})], None), ([], None)]
    for spans, want in cases:
        monkeypatch.setattr(profiling, "spans", lambda s=spans: list(s))
        got = mod.read({"window_s": 1.0})
        assert got == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert mod.read({"window_s": 1.0}) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark whose Swin configuration serves 8 frames of
    32x32 (tokens 4x8x8: a shifted, padded stage 1) to 2 clients."""
    root = tmp_path_factory.mktemp("swin")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = dict(_config(), img_size=32, frames=8, dtype="float32")
    (root / _entry()["file"]).write_text(json.dumps(cfg))
    traffic = json.loads((REPO / f"perfbench/traffic/{CELL}.json"
                          ).read_text())
    traffic.update(clients=2, request_samples=[2, 2], pool=4, max_batch=4,
                   checks={"logit_gap": 1e-4})
    (root / f"perfbench/traffic/{CELL}.json").write_text(json.dumps(traffic))
    return root


def test_the_cell_runs_from_its_files(tiny_root):
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_root, CELL, 2 ** 31 + 11, 2.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_samples_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["logit_gap"]["value"] < 1e-4
