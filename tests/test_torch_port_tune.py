"""``python -m protoasnet_tpu_torch.serve tune`` and the batcher's bucket
ladder, on the CPU.

- the CLI on a tiny bundle (float and uint8 input): every candidate
  reports a rate, under the JAX package's JSON keys, and the
  recommendation is one of them;
- on the same scripted clock readings, the port's sweep prints the same
  JSON as the JAX package's ``_tune_cmd`` (rates, a degenerate fit, the
  recommended batch: the smallest within 5% of the best rate);
- ``--points`` is validated as the JAX package validates it;
- a ``DynamicBatcher`` given ``buckets=`` pads only to those buckets, and
  ``warmup(buckets=...)`` calls the model once per bucket.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch import serve, server
from protoasnet_tpu_torch.models.builder import build_model

CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32, "head_impl": "xla"}
SAMPLE = (8, 32, 32, 3)
KEYS = {"ms_per_batch", "samples_per_sec", "compile_s"}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("tune")
    model = build_model(CFG, device="cpu", seed=3)
    out = {}
    for kind, gray in (("float32", False), ("uint8", True)):
        out[kind] = str(root / f"{kind}.zip")
        serve.save_serving_bundle(out[kind], model, CFG, SAMPLE,
                                  uint8_gray=gray)
    return out


@pytest.mark.parametrize("kind", ["float32", "uint8"])
def test_tune_cli_reports_every_candidate(bundles, capsys, kind):
    serve.main(["tune", "--bundle", bundles[kind], "--batches", "1,2",
                "--points", "2", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    report = json.loads(out.strip().splitlines()[-1])
    assert set(report) == {"results", "recommended_max_batch"}
    assert set(report["results"]) == {"1", "2"}
    for r in report["results"].values():
        assert set(r) == KEYS and r["samples_per_sec"] > 0, r
    assert report["recommended_max_batch"] in (1, 2)
    assert "recommended: --max_batch" in out


class _Clock:
    """Scripted readings: per candidate, start/end of the first call, of
    the N1 run and of the N2 run."""

    def __init__(self, timings):
        self.values = [v for first, ta, tb in timings
                       for v in (10.0, 10.0 + first, 20.0, 20.0 + ta,
                                 30.0, 30.0 + tb)]

    def __call__(self):
        return self.values.pop(0)


# (batch, (first call s, N1 run s, N2 run s)): 16 is within 5% of the
# best rate (32), 128's fit is degenerate
TIMINGS = {8: (1.5, 0.010, 0.026), 16: (1.25, 0.012, 0.04160),
           32: (2.0, 0.020, 0.0776), 64: (3.0, 0.050, 0.1790),
           128: (4.0, 0.300, 0.250)}


class _SumModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        return (x.sum(dim=(1, 2))[:, None] * self.w,)


def test_same_json_as_the_jax_package_on_the_same_clock(monkeypatch,
                                                        capsys):
    import time

    import jax.numpy as jnp

    import protoasnet_tpu.serve as jax_serve

    batches = ",".join(map(str, TIMINGS))
    # the JAX package's sweep, its clock scripted where _tune_cmd reads it
    clock, real = _Clock(TIMINGS.values()), time.time

    def jax_time():
        caller = sys._getframe(1).f_code.co_filename
        return clock() if caller == jax_serve.__file__ else real()

    monkeypatch.setattr(time, "time", jax_time)
    monkeypatch.setattr(
        jax_serve, "load_serving_bundle_with_spec",
        lambda path: (lambda x: jnp.sum(x, axis=(1, 2))[:, None],
                      (None, 4, 4), np.float32))
    jax_serve.main(["tune", "--bundle", "unused", "--batches", batches,
                    "--points", "4", "20"])
    jax_out = capsys.readouterr().out
    monkeypatch.setattr(time, "time", real)
    assert not clock.values
    # the port's, on the same readings
    clock = _Clock(TIMINGS.values())
    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        perf_counter=clock))
    monkeypatch.setattr(
        serve, "load_bundle_model",
        lambda path, device=None: (_SumModel(), (None, 4, 4),
                                   np.dtype(np.float32), False))
    serve.main(["tune", "--bundle", "unused", "--batches", batches,
                "--points", "4", "20", "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert not clock.values
    jax_report = json.loads(jax_out.strip().splitlines()[-1])
    port_report = json.loads(port_out.strip().splitlines()[-1])
    assert port_report == jax_report
    assert port_report["recommended_max_batch"] == 16
    assert "degenerate fit" in port_report["results"]["128"]["error"]
    assert port_out.splitlines()[-2] == jax_out.splitlines()[-2] == \
        "recommended: --max_batch 16 (peak rate at 32, within 5%)"
    assert serve.recommend({int(b): r for b, r in
                            port_report["results"].items()}) == (16, 32)
    assert serve.recommend({8: {"error": "OutOfMemoryError"}}) == \
        (None, None)


@pytest.mark.parametrize("points", [("5", "5"), ("0", "3"), ("10", "4")])
def test_points_are_validated_like_the_jax_package(bundles, points):
    import protoasnet_tpu.serve as jax_serve

    for main in (serve.main, jax_serve.main):
        with pytest.raises(SystemExit, match="--points must be two "
                                             "increasing call counts"):
            main(["tune", "--bundle", bundles["float32"], "--points",
                  *points])


def test_batcher_pads_only_to_the_given_buckets():
    calls = []

    def fn(x):
        calls.append(len(x))
        return x.reshape(len(x), -1).sum(axis=1)

    b = server.DynamicBatcher(fn, max_batch=8, max_delay_ms=1.0,
                              buckets=(8, 3), sample_shape=(2,))
    try:
        assert b.buckets == (3, 8)
        for n in (1, 2, 3, 4, 8):
            x = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
            np.testing.assert_allclose(b.submit(x), x.sum(axis=1))
        assert calls == [3, 3, 3, 8, 8]
        calls.clear()
        b.warmup(buckets=(2, 5))
        assert calls == [2, 5]
        calls.clear()
        b.warmup()
        assert calls == [3, 8]
    finally:
        b.close()
    with pytest.raises(ValueError, match="largest bucket 4 < max_batch 8"):
        server.DynamicBatcher(fn, max_batch=8, buckets=(2, 4))
    b = server.DynamicBatcher(fn, max_batch=2)
    try:
        with pytest.raises(ValueError, match="sample_shape"):
            b.warmup()
        calls.clear()
        b.warmup(sample_shape=(3,))
        assert calls == [1, 2]
    finally:
        b.close()
