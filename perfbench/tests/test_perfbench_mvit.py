"""The benchmark's additions for the MViTv2 configuration: its keys against
the published schedule, its kept FLOP count against its own reference
(found by the configuration's ``reference`` key), the pooling attention's
bytes and FLOP by hand, the traffic against ``video.serve.bulk``'s, the two
new readers on fixed records, the reference's imports and TF32 setting,
and the new cell's files run through ``perfbench.run.run_cell`` on the CPU
at a tiny MViT in a temporary copy of the tree. On the card (``cuda``):
the control, the plain reference with fp8 (e4m3) operands in the
program's place, reads above the cell's ``logit_gap`` limit."""

from __future__ import annotations

import ast
import importlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import run as harness
from perfbench.kernels import pool_attn

REPO = Path(__file__).resolve().parents[2]
CELL = "mvit.serve.bulk"
CONFIG = "protoasnet_video_mvitv2_b"
PEAK = {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989.4e12}


def _entry():
    m = harness.manifest(REPO)
    return {c["name"]: c for c in m["configs"]}[CONFIG]


def _config():
    return json.loads((REPO / _entry()["file"]).read_text())


def _ref():
    return importlib.import_module(
        f"perfbench.reference.{_config()['reference']}")


def test_the_configuration_is_the_published_schedule():
    """MViTv2-B (MVITv2_B_32x3.yaml): width 96 and one head doubling at
    blocks 2, 5 and 21 with q strided (1, 2, 2) there, k and v at (1, 8, 8)
    divided by each q stride, patch 3x7x7 at (2, 4, 4), 24 blocks; every
    head 96 wide; cut after stage 3 (21 blocks)."""
    cfg = _config()
    assert (cfg["embed_dim"], cfg["depths"], cfg["num_heads"]) == (
        96, [2, 3, 16, 3], 1)
    assert (cfg["patch_kernel"], cfg["patch_stride"], cfg["patch_padding"]
            ) == ([3, 7, 7], [2, 4, 4], [1, 3, 3])
    assert (cfg["pool_kernel"], cfg["kv_stride"], cfg["q_stride"]) == (
        [3, 3, 3], [1, 8, 8], [1, 2, 2])
    assert (cfg["mlp_ratio"], cfg["layer_norm_eps"], cfg["qkv_bias"],
            cfg["stochastic_depth_prob"]) == (4.0, 1e-6, True, 0.3)
    whole = dict(cfg, backbone_last_layer_num=-2)
    sched = _ref().schedule(whole)
    assert len(sched) == 24
    assert [i for i, s in enumerate(sched) if s["dim_in"] != s["dim_out"]
            ] == [2, 5, 21]
    assert [s["heads"] for s in sched] == [1] * 2 + [2] * 3 + [4] * 16 \
        + [8] * 3
    assert {s["head_dim"] for s in sched} == {96}
    assert [tuple(s["stride_kv"]) for s in sched] == [(1, 8, 8)] * 2 + [
        (1, 4, 4)] * 3 + [(1, 2, 2)] * 16 + [(1, 1, 1)] * 3
    assert [i for i, s in enumerate(sched) if s["stride_q"] != [1, 1, 1]
            ] == [2, 5, 21]
    assert len(_ref().schedule(cfg)) == 21
    assert _entry()["reduced"] == ["pretrained", "stage4"]


def test_kept_count_is_the_references():
    cfg = _config()
    kept = json.loads((REPO / f"perfbench/reference/flops/{CONFIG}.json"
                       ).read_text())
    assert kept["serve_per_sample"] == _ref().serve_flops(cfg, 2)
    assert _ref().head_shape(cfg) == (16 * 7 * 7, 40, 256)


def test_pooling_attention_work_by_hand():
    cfg = _config()
    calls = pool_attn.calls(cfg)
    # (Lq, Lk, heads, d, k_t + k_h + k_w, table rows, index entries)
    assert calls == [(12545, 257, 1, 96, 24, 31 + 55 + 55, 256 + 112 + 112)
                     ] * 2 + [(3137, 785, 2, 96, 30, 31 + 27 + 27,
                               256 + 98 + 98)] \
        + [(3137, 257, 2, 96, 24, 31 + 27 + 27, 256 + 56 + 56)] * 2 \
        + [(785, 785, 4, 96, 30, 31 + 13 + 13, 256 + 49 + 49)] \
        + [(785, 257, 4, 96, 24, 31 + 13 + 13, 256 + 28 + 28)] * 15
    first = calls[0]
    # one clip of stage 1: q and v... read once in fp32, o written in bf16
    assert pool_attn.bytes_moved(1, first, 4, 2) == (
        (12545 + 2 * 257) * 96 * 4 + 12545 * 96 * 2 + 141 * 96 * 2 + 480 * 4)
    assert pool_attn.flops(1, first) == 4 * 12545 * 257 * 96 \
        + 2 * 12544 * 24 * 96
    # stage 1 lies under the ridge (bytes bound), block 2's 785 keys over it
    one = pool_attn.call_bound_s(128, first, 4, 2, PEAK)
    assert one == pytest.approx(pool_attn.bytes_moved(128, first, 4, 2)
                                / PEAK["hbm_bytes_per_s"])
    assert pool_attn.call_bound_s(128, calls[2], 4, 2, PEAK) == \
        pytest.approx(pool_attn.flops(256, calls[2])
                      / PEAK["bf16_flops_per_s"])
    assert pool_attn.bound_s(128, cfg, PEAK) == pytest.approx(sum(
        pool_attn.call_bound_s(128, c, 4, 2, PEAK) for c in calls))


def test_the_traffic_is_video_serve_bulks():
    mine = json.loads((REPO / f"perfbench/traffic/{CELL}.json").read_text())
    bulk = json.loads((REPO / "perfbench/traffic/video.serve.bulk.json"
                       ).read_text())
    assert set(mine["checks"]) == {"logit_gap"}
    mine.pop("checks"), bulk.pop("checks")
    assert mine == bulk


def _rec(kernels=None):
    return {"peaks": json.loads((REPO / "perfbench/peaks.json").read_text()),
            "device_name": "NVIDIA H100 80GB HBM3", "config": _config(),
            "buckets": {128: 3}, "kernels": kernels or {}, "window_s": 1.0}


def test_roofline_reader():
    mod = harness.reader(REPO, "pool_attn_roofline")
    assert mod.read(_rec()) is None  # no kernel in the trace
    assert mod.read(dict(_rec({"x": 1.0}), device_name="cpu")) is None
    bound = 3 * pool_attn.bound_s(128, _config(), _rec()["peaks"][
        "NVIDIA H100 80GB HBM3"])
    name = ("void (anonymous namespace)::pool_attn_kernel<float, "
            "__nv_bfloat16>(Params<float, __nv_bfloat16>)")
    got = mod.read(_rec({name: bound * 4, "window_attn_kernel": 5.0}))
    assert got == pytest.approx(25.0)


def test_fused_share_reader(monkeypatch):
    from protoasnet_tpu_torch.utils import profiling

    mod = harness.reader(REPO, "pool_attn_fused_pct.throughput")

    def batch(i, counts):
        return {"name": "batcher.batch", "id": i, "parent": None,
                "start_ns": i, "end_ns": i + 1, "counts": counts}

    fused = {"mvit.pool_attn": 21}
    cases = [([batch(1, fused), batch(2, fused)], 100.0),
             ([batch(1, fused), batch(2, {"mvit.pool_attn.plain": 21})],
              50.0),
             ([batch(1, {"swin.window_attn": 22})], None), ([], None)]
    for spans, want in cases:
        monkeypatch.setattr(profiling, "spans", lambda s=spans: list(s))
        got = mod.read({"window_s": 1.0})
        assert got == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert mod.read({"window_s": 1.0}) is None


def test_the_reference_imports_none_of_the_program_and_sets_tf32_off():
    path = REPO / "perfbench/reference/mvit_xprotonet.py"
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    for name in names:
        assert name.split(".")[0] not in ("protoasnet_tpu_torch",
                                          "protoasnet_tpu", "jax", "flax"), \
            name
    ref = _ref()
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    with ref._fp32():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32  # put back
    torch.backends.cuda.matmul.allow_tf32 = False


TINY = {"embed_dim": 8, "depths": [1, 2, 2, 1], "kv_stride": [1, 4, 4],
        "stochastic_depth_prob": 0.0, "img_size": 56, "frames": 8,
        "dtype": "float32"}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark whose MViT configuration serves a tiny MViT
    (width 8, 8x56x56 clips) to 2 clients."""
    root = tmp_path_factory.mktemp("mvit")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / _entry()["file"]).write_text(json.dumps(dict(_config(), **TINY)))
    traffic = json.loads((REPO / f"perfbench/traffic/{CELL}.json"
                          ).read_text())
    traffic.update(clients=2, request_samples=[2, 2], pool=4, max_batch=4,
                   checks={"logit_gap": 1e-4})
    (root / f"perfbench/traffic/{CELL}.json").write_text(json.dumps(traffic))
    return root


def test_the_cell_runs_from_its_files(tiny_root, monkeypatch):
    from protoasnet_tpu_torch.models.backbones import mvit

    spec = dict(mvit.MVIT_SPECS["mvit_v2_b"], input_size=(8, 56, 56),
                **{k: TINY[k] for k in ("embed_dim", "depths", "kv_stride",
                                        "stochastic_depth_prob")})
    monkeypatch.setitem(mvit.MVIT_SPECS, "mvit_v2_b", spec)
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_root, CELL, 2 ** 31 + 13, 2.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_samples_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["logit_gap"]["value"] < 1e-4


@pytest.mark.cuda
def test_the_control_reads_above_the_limit():
    """The plain reference with fp8 (e4m3) operands in the program's place,
    at the cell's own size, on one seed: its ``logit_gap`` above the
    cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    harness._caches(harness.ROOT)
    out = harness.run_cell(harness.ROOT, CELL, 3201, 10.0, False, "cuda:0",
                           {"precision": "fp8"})
    gap = out["checks"]["logit_gap"]
    print(json.dumps({"cell": CELL, "run": "fp8", "checks": out["checks"]}))
    assert gap["value"] > gap["limit"]
