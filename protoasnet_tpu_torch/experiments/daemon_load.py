"""Load test of the serving daemon: its own cost, and end-to-end rate and
latency on the card.

    python -m protoasnet_tpu_torch.experiments.daemon_load --null \
        [--clients 4] [--seconds 20] [--req_batch 4] [--max_batch 16]
    python -m protoasnet_tpu_torch.experiments.daemon_load [--uint8]
        [--int8] [--clients 4] [--seconds 20] [--req_batch 4]
        [--max_batch 16] [--max_delay_ms 5] [--img_size 112] [--frames 32]
        [--device cuda|cpu]

The port's counterpart of ``experiments/daemon_load.py``. ``run_load``
puts the port's ``server.DynamicBatcher`` (warmed at every bucket) and
``server.make_handler`` behind a threading HTTP server on 127.0.0.1
(``server._HTTPServer``, the daemon's own, which closes a connection after
its client) and starts ``--clients`` threads, each POSTing its own seeded
``(req_batch, *sample)`` array as an ``.npy`` body to /v1/predict again and
again for ``--seconds``. Every response must have one row per request row,
finite, and, where an ``expect`` function is given, equal to it on that
request: a failed or wrong response raises once the run ends. It prints
one JSON line with the keys of the JAX script's (``mode``,
``samples_per_sec``, ``requests``, ``mean_batch``, ``padding_frac``,
``latency_ms_p50``, ``latency_ms_p95``, ``overhead_us_per_sample``,
``warmup_s``, ``clients``, ``req_batch``, ``max_batch``); ``main(argv)``
returns it.

- ``--null`` serves a no-op function (each sample's first pixel's 3
  channels and a zero: ``x[:, 0, 0, :4]`` of ``(8, 8, 3)`` samples): the
  daemon's own cost per sample (HTTP, queue, coalescing, padding,
  slicing), with no device by design. The client threads share the
  daemon's process and its GIL, so the samples are small.
- The default serves the full-width bf16 video flagship (``bench.VIDEO``,
  seeded random weights) on the card through ``serve.make_serving_fn``:
  float32 clips on the wire, or raw gray uint8 frames with ``--uint8``
  (the bundles' ``uint8_gray`` input: /255, normalisation and gray -> 3
  channels on the device); ``--int8`` serves its w8a8 model
  (``bench.quantize``, calibrated once on 4 seeded clips). The latency
  percentiles are the batcher's (enqueue to result), as ``/v1/stats``
  reports them.

The card's name and power limit go to stderr.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["main", "run_load", "null_fn", "NULL_SAMPLE"]

NULL_SAMPLE = (8, 8, 3)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def null_fn(x: np.ndarray) -> np.ndarray:
    """The no-op model of ``--null``: per sample, its first pixel."""
    return x[:, 0, 0, :4]


def _post(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/v1/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def run_load(fn: Callable[[np.ndarray], np.ndarray],
             sample_shape: Sequence[int], sample_ndim: int, clients: int,
             seconds: float, req_batch: int, max_batch: int,
             max_delay_ms: float, label: str, dtype=np.float32,
             expect: Optional[Callable[[np.ndarray], np.ndarray]] = None
             ) -> Dict[str, Any]:
    """Serve ``fn`` through the batcher and the handler over HTTP under
    ``clients`` posting threads for ``seconds``; prints and returns the
    JSON record. Raises if any request failed or came back wrong."""
    from protoasnet_tpu_torch.server import (DynamicBatcher, _HTTPServer,
                                             make_handler)

    batcher = DynamicBatcher(fn, max_batch=max_batch,
                             max_delay_ms=max_delay_ms, dtype=dtype,
                             sample_shape=sample_shape)
    t0 = time.monotonic()
    batcher.warmup(sample_shape)
    warm_s = time.monotonic() - t0
    httpd = _HTTPServer(("127.0.0.1", 0), make_handler(batcher, sample_ndim))
    serve = threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="daemon-load-http")
    serve.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    stop = threading.Event()
    counts = [0] * clients
    failures: List[str] = []
    xs = []
    for i in range(clients):  # each client its own request
        rng = np.random.default_rng(i)
        if np.dtype(dtype) == np.uint8:
            xs.append(rng.integers(0, 256, size=(req_batch, *sample_shape),
                                   dtype=np.uint8))
        else:
            xs.append(rng.normal(size=(req_batch, *sample_shape))
                      .astype(np.float32))
    wants = [None if expect is None else np.asarray(expect(x)) for x in xs]

    def client(i: int) -> None:
        while not stop.is_set():
            try:
                out = _post(url, xs[i])
            except Exception as e:  # noqa: BLE001 — counted, raised below
                failures.append(f"client {i}: {e!r}")
                return
            if (out.shape[0] != req_batch or not np.isfinite(out).all()
                    or (wants[i] is not None
                        and not np.array_equal(out, wants[i]))):
                failures.append(f"client {i}: wrong response {out.shape}")
                return
            counts[i] += req_batch

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    elapsed = time.monotonic() - t0
    snap = batcher.stats.snapshot()
    httpd.shutdown()
    httpd.server_close()
    serve.join(timeout=60)
    batcher.close()
    if failures or any(t.is_alive() for t in threads):
        raise RuntimeError(f"daemon load ({label}): {len(failures)} "
                           f"failed requests: {failures[:4]}")
    total = sum(counts)
    record = {
        "mode": label,
        "samples_per_sec": round(total / elapsed, 2),
        "requests": snap["requests"],
        "mean_batch": round(snap["mean_batch"] or 0, 2),
        "padding_frac": round(snap["padding_frac"], 4),
        "latency_ms_p50": round(snap["latency_ms_p50"] or 0, 2),
        "latency_ms_p95": round(snap["latency_ms_p95"] or 0, 2),
        "overhead_us_per_sample": round(
            1e6 * elapsed * clients / max(1, total), 1),
        "warmup_s": round(warm_s, 1),
        "clients": clients, "req_batch": req_batch, "max_batch": max_batch,
    }
    print(json.dumps(record), flush=True)
    return record


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.experiments.daemon_load",
        description="the serving daemon under load")
    ap.add_argument("--null", action="store_true",
                    help="a no-op function: the daemon's own cost only")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--req_batch", type=int, default=4)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_delay_ms", type=float, default=5.0)
    ap.add_argument("--uint8", action="store_true",
                    help="uint8 gray frames on the wire (--uint8_input)")
    ap.add_argument("--int8", action="store_true",
                    help="the w8a8 model (quant.py; serve --int8)")
    ap.add_argument("--img_size", type=int, default=112)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; --null uses none")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    a = _parse(argv)
    if a.null:
        return run_load(null_fn, NULL_SAMPLE, len(NULL_SAMPLE), a.clients,
                        a.seconds, a.req_batch, a.max_batch, a.max_delay_ms,
                        "null-fn (daemon overhead only)", expect=null_fn)

    import torch

    from protoasnet_tpu_torch import bench
    from protoasnet_tpu_torch.experiments.common import card_line
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import make_serving_fn
    from protoasnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(a.device)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)}; card "
            f"{card_line()}")
    model = build_model(dict(bench.VIDEO, img_size=a.img_size,
                             dtype="bfloat16"), device=dev, seed=0)
    model_in = (a.frames, a.img_size, a.img_size, 3)
    if a.int8:
        model = bench.quantize(model, torch.from_numpy(
            np.random.default_rng(1).normal(size=(4, *model_in)).astype(
                np.float32)).to(dev))
    fn = make_serving_fn(model, uint8_gray=a.uint8)
    if a.uint8:
        sample_shape, label = model_in[:-1], "uint8-gray wire"
    else:
        sample_shape, label = model_in, "float32 wire"
    if a.int8:
        label += " + int8 backbone"
    return run_load(fn, sample_shape, len(sample_shape), a.clients,
                    a.seconds, a.req_batch, a.max_batch, a.max_delay_ms,
                    f"flagship video, {label}, on {dev.type}",
                    dtype=np.uint8 if a.uint8 else np.float32)


if __name__ == "__main__":
    main(sys.argv[1:])
