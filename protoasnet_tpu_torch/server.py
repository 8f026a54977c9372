"""Serving daemon of the port: dynamic batching over a bundle, HTTP front end.

The port's own copy of the JAX package's daemon (``protoasnet_tpu/server.py``)
with the same wire protocol, so the JAX package's client works against it:

- **One dispatch thread.** All device work happens on the batcher's single
  worker thread; HTTP handler threads only do numpy and queue operations,
  which keeps the device queue ordered and latency predictable.
- **Bucketed batch shapes.** Requests are coalesced and padded up to a
  fixed ladder (powers of two up to ``max_batch``), so the set of batch
  shapes the model sees is finite and is warmed at startup.
- **Delay-window coalescing.** The dispatcher blocks for the first request,
  then drains the queue for at most ``max_delay_ms`` or until ``max_batch``
  samples are gathered.

Usage:
    python -m protoasnet_tpu_torch.server --bundle b.zip --port 8300
    # POST /v1/predict   body = .npy bytes (b, T, H, W[, 3]) -> .npy logits
    # GET  /healthz      liveness
    # GET  /v1/spec      input contract (JSON)
    # GET  /v1/stats     batching/latency counters (JSON)
    # GET  /metrics      the same counters in Prometheus text format
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DynamicBatcher", "BatcherStats", "make_handler", "serve_forever",
           "prometheus_text"]


def prometheus_text(snapshot: dict, healthy: bool) -> str:
    """Render a ``BatcherStats.snapshot()`` as Prometheus exposition text.

    Dependency-free (no prometheus_client): the v0.0.4 text format is
    lines of ``# TYPE``/``# HELP`` + ``name{labels} value``. Served at
    GET /metrics so a standard Prometheus/Grafana scrape works against
    the daemon out of the box; /v1/stats stays the JSON twin.
    """
    lines: List[str] = []

    def metric(name, mtype, help_, value, labels=""):
        lines.append(f"# HELP protoasnet_{name} {help_}")
        lines.append(f"# TYPE protoasnet_{name} {mtype}")
        if value is not None:
            lines.append(f"protoasnet_{name}{labels} {value}")

    metric("healthy", "gauge", "1 while the dispatch thread is alive",
           1 if healthy else 0)
    metric("requests_total", "counter", "predict requests accepted",
           snapshot["requests"])
    metric("samples_total", "counter", "real samples computed",
           snapshot["samples"])
    metric("batches_total", "counter", "device batches dispatched",
           snapshot["batches"])
    metric("errors_total", "counter", "requests failed in compute",
           snapshot["errors"])
    metric("abandoned_total", "counter",
           "requests that timed out before compute", snapshot["abandoned"])
    metric("padding_fraction", "gauge",
           "fraction of device slots wasted on bucket padding",
           snapshot["padding_frac"])
    if snapshot.get("mean_batch") is not None:
        metric("mean_batch_size", "gauge", "real samples per device batch",
               round(snapshot["mean_batch"], 4))
    # latency percentiles over the recent-request ring buffer, exposed as
    # a summary (quantile-labelled gauges — a true histogram would need
    # fixed buckets chosen before the model's batch curve is known)
    lines.append("# HELP protoasnet_request_latency_ms request latency "
                 "summary over the last 4096 requests")
    lines.append("# TYPE protoasnet_request_latency_ms summary")
    for q, key in (("0.5", "latency_ms_p50"), ("0.95", "latency_ms_p95"),
                   ("0.99", "latency_ms_p99")):
        v = snapshot.get(key)
        if v is not None:
            lines.append(f'protoasnet_request_latency_ms{{quantile="{q}"}} '
                         f"{v}")
    # _count/_sum: quantiles are over the 4096-deep ring, but count/sum are
    # exact running totals — required by strict OpenMetrics summary parsers
    lines.append("protoasnet_request_latency_ms_count "
                 f"{snapshot.get('latency_ms_count', 0)}")
    lines.append("protoasnet_request_latency_ms_sum "
                 f"{snapshot.get('latency_ms_sum', 0.0)}")
    lines.append("# HELP protoasnet_batches_by_bucket_total device batches "
                 "per bucket size")
    lines.append("# TYPE protoasnet_batches_by_bucket_total counter")
    for bucket, count in snapshot["bucket_counts"].items():
        lines.append(f'protoasnet_batches_by_bucket_total{{bucket="{bucket}"}}'
                     f" {count}")
    return "\n".join(lines) + "\n"


def _bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """1, 2, 4, ... up to and including max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class BatcherStats:
    """Lock-protected counters; snapshot() returns a JSON-safe dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.samples = 0
        self.batches = 0
        self.padded_samples = 0  # wasted slots from bucket padding
        self.errors = 0
        self.abandoned = 0  # timed-out requests dropped before compute
        self.bucket_counts: dict = {}
        self._lat_ms: List[float] = []  # ring buffer of request latencies
        # running totals over ALL requests (not just the ring) so the
        # Prometheus summary can emit the _count/_sum series strict
        # OpenMetrics parsers require alongside the quantile samples
        self.lat_count = 0
        self.lat_sum_ms = 0.0

    def record_batch(self, n_real: int, bucket: int, lat_ms: Sequence[float]):
        with self._lock:
            self.batches += 1
            self.samples += n_real
            self.padded_samples += bucket - n_real
            self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            self.lat_count += len(lat_ms)
            self.lat_sum_ms += float(sum(lat_ms))
            self._lat_ms.extend(lat_ms)
            if len(self._lat_ms) > 4096:
                self._lat_ms = self._lat_ms[-4096:]

    def record_request(self):
        with self._lock:
            self.requests += 1

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_abandoned(self):
        with self._lock:
            self.abandoned += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
                   if lat else None)
            return {
                "requests": self.requests,
                "samples": self.samples,
                "batches": self.batches,
                "mean_batch": (self.samples / self.batches
                               if self.batches else None),
                "padding_frac": (self.padded_samples /
                                 max(1, self.samples + self.padded_samples)),
                "errors": self.errors,
                "abandoned": self.abandoned,
                "bucket_counts": {str(k): v
                                  for k, v in sorted(self.bucket_counts.items())},
                "latency_ms_p50": pct(0.50),
                "latency_ms_p95": pct(0.95),
                "latency_ms_p99": pct(0.99),
                "latency_ms_count": self.lat_count,
                "latency_ms_sum": round(self.lat_sum_ms, 3),
            }


class _Pending:
    __slots__ = ("x", "event", "result", "error", "t_submit", "abandoned")

    def __init__(self, x: np.ndarray):
        self.x = x              # (n, ...) batcher dtype, n >= 1
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.abandoned = False  # waiter gave up; skip compute if not started


class DynamicBatcher:
    """Coalesce concurrent requests into bucketed batches on ONE thread.

    fn: the model function, e.g. ``serve.load_serving_bundle(path)`` —
        called as ``fn(x)`` with x ``dtype`` (bucket, *sample_shape); must
        return per-sample outputs with leading dim == bucket. Called only
        from the dispatch thread.
    sample_shape: optional per-sample shape; when set, submit() rejects
        mismatched requests instead of letting one bad request poison the
        whole coalesced batch.
    """

    def __init__(self, fn: Callable, max_batch: int = 128,
                 max_delay_ms: float = 5.0,
                 dtype=np.float32,
                 sample_shape: Optional[Sequence[int]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.fn = fn
        self.dtype = np.dtype(dtype)  # uint8 for --uint8_input bundles
        self.sample_shape = tuple(sample_shape) if sample_shape else None
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.buckets = _bucket_ladder(self.max_batch)
        self.stats = BatcherStats()
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._closed = False
        self._fatal: Optional[BaseException] = None
        # dispatch-thread-only: the group currently being coalesced/served,
        # so the _run guard can fail its waiters if the thread dies
        self._current_group: List[_Pending] = []
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="batcher-dispatch")
        self._thread.start()

    # -- client side --------------------------------------------------------

    def _validate(self, x: np.ndarray) -> np.ndarray:
        if x.ndim < 2:
            raise ValueError("expected a batched array (n, ...)")
        if len(x) == 0:
            # fail loudly; downstream np.concatenate([]) would otherwise
            # produce a baffling "need at least one array" error
            raise ValueError("empty batch (0 samples)")
        if self.sample_shape is not None and x.shape[1:] != self.sample_shape:
            raise ValueError(f"sample shape {x.shape[1:]} != model input "
                             f"{self.sample_shape}")
        if not np.can_cast(x.dtype, self.dtype, casting="same_kind"):
            # e.g. float clips posted to a uint8 daemon would silently
            # truncate to garbage; uint8 -> float32 upcasts are fine
            raise ValueError(f"dtype {x.dtype} not safely castable to model "
                             f"input {self.dtype}")
        return np.ascontiguousarray(x, dtype=self.dtype)

    def _enqueue(self, x: np.ndarray) -> _Pending:
        p = _Pending(x)
        # lock orders the closed-check against close(): a put that won the
        # check lands before the sentinel, so _drain_closed always sees it
        with self._close_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.stats.record_request()
            self._q.put(p)
        return p

    def _wait(self, p: _Pending, deadline: Optional[float]) -> np.ndarray:
        remaining = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        if not p.event.wait(remaining):
            p.abandoned = True  # dispatcher drops it if not yet computed
            raise TimeoutError("inference timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def submit(self, x: np.ndarray, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Block until the batch containing ``x`` is served; returns the
        outputs for x's rows. x: (n, *sample_shape), n <= max_batch
        (use submit_many for larger requests)."""
        if len(x) > self.max_batch:
            raise ValueError(f"request batch {len(x)} > max_batch "
                             f"{self.max_batch}; split the request")
        x = self._validate(x)
        deadline = None if timeout is None else time.monotonic() + timeout
        return self._wait(self._enqueue(x), deadline)

    def submit_many(self, x: np.ndarray, timeout: Optional[float] = None
                    ) -> np.ndarray:
        """Any-size request: enqueue ALL max_batch-sized chunks up front
        (so chunk k+1's H2D staging overlaps chunk k's compute), then wait
        for each in order."""
        x = self._validate(x)
        deadline = None if timeout is None else time.monotonic() + timeout
        pendings = [self._enqueue(x[i:i + self.max_batch])
                    for i in range(0, len(x), self.max_batch)]
        try:
            return np.concatenate([self._wait(p, deadline) for p in pendings])
        except BaseException:
            # one chunk failed/timed out: nobody will read the rest of this
            # request, so flag the sibling chunks abandoned too — otherwise
            # the dispatcher spends chip time on dead work while the
            # client's retry queues behind it (overload spiral)
            for p in pendings:
                if not p.event.is_set():
                    p.abandoned = True
            raise

    def close(self):
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=10)

    # -- dispatch thread ----------------------------------------------------

    def warmup(self) -> None:
        """Run every bucket once up front (one fn call per bucket) so no
        live request pays the kernel build, cuDNN's algorithm choice or
        the allocator's first growth. Runs on the caller's thread — call
        before serving traffic."""
        if self.sample_shape is None:
            raise ValueError("warmup needs the batcher's sample_shape")
        for b in self.buckets:
            np.asarray(self.fn(np.zeros((b, *self.sample_shape), self.dtype)))

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @property
    def healthy(self) -> bool:
        """True while the dispatch thread is serving (or cleanly closed).
        False means the thread died on an unexpected error — /healthz
        reports 503 so an orchestrator restarts the daemon."""
        return self._fatal is None

    def _run(self):
        try:
            self._run_inner()
        except BaseException as e:  # noqa: BLE001 — never die silently
            # _flush already contains per-group failures; anything that
            # still escapes here would otherwise zombie the daemon. Fail
            # every queued waiter loudly instead of hanging them, and
            # refuse new submits (fail-fast beats accept-and-hang).
            self._fatal = e
            with self._close_lock:
                self._closed = True
            dead: List[_Pending] = list(self._current_group)
            while True:
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    break
                if p is not None:
                    dead.append(p)
            for p in dead:
                if not p.event.is_set():
                    p.error = RuntimeError(f"dispatch thread died: {e!r}")
                    p.event.set()
            raise

    def _run_inner(self):
        while True:
            first = self._q.get()
            if first is None:
                self._drain_closed()
                break
            if first.abandoned:
                self.stats.record_abandoned()
                continue
            group = [first]
            self._current_group = group
            total = len(first.x)
            deadline = time.monotonic() + self.max_delay_s
            # drain until the window closes or the max bucket fills
            while total < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # grab whatever is already queued, but don't wait more
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                else:
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                if nxt is None:
                    self._flush(group)
                    self._drain_closed()
                    return
                if nxt.abandoned:
                    self.stats.record_abandoned()
                    continue
                if (total + len(nxt.x) > self.max_batch
                        or nxt.x.shape[1:] != group[0].x.shape[1:]):
                    # doesn't fit (or, without submit-side shape validation,
                    # a different sample shape): serve the current group,
                    # start fresh — one request can't poison another's batch
                    self._flush(group)
                    group, total = [nxt], len(nxt.x)
                    self._current_group = group
                    deadline = time.monotonic() + self.max_delay_s
                    continue
                group.append(nxt)
                total += len(nxt.x)
            self._flush(group)
            self._current_group = []

    def _drain_closed(self):
        """After the shutdown sentinel: fail any requests still queued so
        their waiters don't hang until timeout."""
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return
            if p is not None:
                p.error = RuntimeError("batcher closed")
                p.event.set()

    def _flush(self, group: List[_Pending]):
        # drop requests whose waiter timed out while queued — computing
        # them would spend chip time on work nobody reads (overload spiral)
        live = [p for p in group if not p.abandoned]
        for _ in range(len(group) - len(live)):
            self.stats.record_abandoned()
        group = live
        total = sum(len(p.x) for p in group)
        if not group:
            return
        bucket = self._pick_bucket(total)
        try:
            # the buffer alloc is INSIDE the try: a transient MemoryError
            # on a big bucket must fail this group's waiters, not kill the
            # dispatch thread (which would zombie the whole daemon)
            x = np.zeros((bucket, *group[0].x.shape[1:]), self.dtype)
            ofs = 0
            for p in group:
                x[ofs:ofs + len(p.x)] = p.x
                ofs += len(p.x)
            out = np.asarray(self.fn(x), np.float32)
            t_done = time.monotonic()
            ofs = 0
            lats = []
            for p in group:
                p.result = out[ofs:ofs + len(p.x)]
                ofs += len(p.x)
                lats.append((t_done - p.t_submit) * 1e3)
                p.event.set()
            self.stats.record_batch(total, bucket, lats)
        except BaseException as e:  # noqa: BLE001 — propagate to all waiters
            self.stats.record_error()
            for p in group:
                if not p.event.is_set():
                    p.error = e
                    p.event.set()


# --- HTTP front end ---------------------------------------------------------


class _Inflight:
    """Counts requests a handler thread has accepted but not finished, so
    shutdown can wait for them: ThreadingHTTPServer marks handler threads
    daemon, which server_close() deliberately does NOT join — without
    this, stop_event teardown would close the batcher under a request
    that was fully received but not yet enqueued (client sees a 503/cut
    connection for work the daemon accepted)."""

    def __init__(self):
        self._n = 0
        self._cv = threading.Condition()

    def __enter__(self):
        with self._cv:
            self._n += 1

    def __exit__(self, *a):
        with self._cv:
            self._n -= 1
            self._cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True


def make_handler(batcher: DynamicBatcher, sample_ndim: int,
                 timeout_s: float = 60.0,
                 max_body_bytes: int = 256 << 20):
    """BaseHTTPRequestHandler subclass bound to ``batcher``.

    sample_ndim: rank WITHOUT batch (4 for video (T,H,W,3), 3 for image).
    Accepts request bodies with or without the batch dim.
    max_body_bytes: reject larger payloads with 413 before reading them
    (the daemon binds 0.0.0.0 by default — an unbounded Content-Length
    would let any client OOM the serving host)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # socket read timeout: a client that sends Content-Length and then
        # stalls would otherwise pin a handler thread forever (slow-loris
        # thread exhaustion); BaseHTTPRequestHandler applies this to the
        # connection and treats a timeout as close_connection
        timeout = 120.0
        inflight = _Inflight()

        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # tell the client too (set before _send, e.g. the 413
                # path, where the unread body would desync keep-alive)
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if batcher.healthy:
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(503, b"dispatch thread dead", "text/plain")
            elif self.path == "/v1/stats":
                snap = batcher.stats.snapshot()
                self._send(200, json.dumps(snap).encode(), "application/json")
            elif self.path == "/metrics":
                body = prometheus_text(batcher.stats.snapshot(),
                                       batcher.healthy).encode()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/v1/spec":
                # input contract discovery (client.ServingClient): lets a
                # client validate/encode locally (esp. uint8 daemons) and
                # size chunks to the body cap without a rejected probe
                self._send(200, json.dumps({
                    "sample_shape": list(batcher.sample_shape)
                    if batcher.sample_shape else None,
                    "dtype": batcher.dtype.name,
                    "max_batch": batcher.max_batch,
                    "buckets": list(batcher.buckets),
                    "max_body_bytes": max_body_bytes,
                    # explicit per-request sample ceiling so clients don't
                    # have to mirror the body-cap sizing heuristic
                    "max_request_samples": 16 * batcher.max_batch,
                }).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/v1/predict":
                self._send(404, b"not found", "text/plain")
                return
            with self.inflight:
                self._do_predict()

        def _do_predict(self):
            try:
                # Content-Length must exist and be a non-negative int:
                # chunked bodies have none (the unread body would desync
                # keep-alive), and a negative value would turn rfile.read
                # into read-to-EOF — a handler thread pinned until the
                # peer hangs up
                te = self.headers.get("Transfer-Encoding")
                cl = self.headers.get("Content-Length")
                if te or cl is None:
                    self.close_connection = True
                    self._send(400, b"Content-Length required "
                               b"(chunked bodies unsupported)", "text/plain")
                    return
                try:
                    n = int(cl)
                except ValueError:
                    n = -1
                if n < 0:
                    self.close_connection = True
                    self._send(400, f"bad Content-Length {cl!r}".encode(),
                               "text/plain")
                    return
                if n > max_body_bytes:
                    # the body was NOT read: close the connection, or a
                    # keep-alive client's unread npy bytes get parsed as
                    # the next request line (connection desync)
                    self.close_connection = True
                    self._send(413, f"body {n} bytes > limit "
                               f"{max_body_bytes}".encode(), "text/plain")
                    return
                try:
                    x = np.load(io.BytesIO(self.rfile.read(n)),
                                allow_pickle=False)
                except Exception as e:
                    # np.load raises EOFError/OSError/... on truncated or
                    # empty bodies — all client-side payload problems (400),
                    # not retryable server faults (503)
                    raise ValueError(f"bad .npy payload: {e}") from None
                if x.ndim == sample_ndim:
                    x = x[None]
                if x.ndim != sample_ndim + 1:
                    raise ValueError(
                        f"expected rank {sample_ndim} or {sample_ndim + 1}, "
                        f"got {x.ndim}")
                out = batcher.submit_many(x, timeout=timeout_s)
                buf = io.BytesIO()
                np.save(buf, out)
                self._send(200, buf.getvalue())
            except TimeoutError as e:
                # server overload/stall, not the client's fault: retryable
                self._send(504, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")
            except ValueError as e:  # bad payload (np.load, rank, shape,
                self._send(400, f"{type(e).__name__}: {e}".encode(),  # dtype)
                           "text/plain")
            except Exception as e:  # noqa: BLE001 — model/server fault
                self._send(503, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")

    return Handler


def _serve_loop(fn, sample_shape, dtype, host, port, max_batch,
                max_delay_ms, warmup, ready_event, banner="",
                stop_event=None):
    """ready_event (optional): set once the socket is bound; the bound
    port is published as ``ready_event.port`` (useful with port=0).
    stop_event (optional): setting it shuts the server down cleanly —
    the test/embedding hook, since serve_forever() otherwise only exits
    on KeyboardInterrupt."""
    from http.server import ThreadingHTTPServer

    batcher = DynamicBatcher(fn, max_batch=max_batch,
                             max_delay_ms=max_delay_ms, dtype=dtype,
                             sample_shape=sample_shape)
    try:
        if warmup:
            t0 = time.monotonic()
            batcher.warmup()
            print(f"warmed {len(batcher.buckets)} buckets "
                  f"{batcher.buckets} in {time.monotonic() - t0:.1f}s")
        sample_bytes = int(np.prod(sample_shape)) * np.dtype(dtype).itemsize
        handler_cls = make_handler(
            batcher, sample_ndim=len(sample_shape),
            # npy header is tiny; allow 16 full batches per request
            max_body_bytes=16 * max_batch * sample_bytes + (1 << 20))
        httpd = ThreadingHTTPServer((host, port), handler_cls)
    except BaseException:
        batcher.close()
        raise
    if ready_event is not None:
        ready_event.port = httpd.server_address[1]
        ready_event.set()
    if stop_event is not None:
        threading.Thread(
            target=lambda: (stop_event.wait(), httpd.shutdown()),
            daemon=True, name="server-stop").start()
    print(f"serving {banner} on {host}:{httpd.server_address[1]} "
          f"(max_batch={max_batch}, window={max_delay_ms}ms, "
          f"input dtype {np.dtype(dtype).name})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        # handler threads are daemons (server_close doesn't join them):
        # wait for requests already ACCEPTED to finish before closing the
        # batcher, or a request received moments before shutdown gets a
        # 503 for work the daemon took responsibility for. Bounded by the
        # handler's submit timeout; stragglers past it fail loud below.
        if not handler_cls.inflight.wait_idle(65.0):
            print("shutdown: abandoning handler(s) still in flight "
                  "after 65s", flush=True)
        batcher.close()


def serve_forever(bundle_path: str, host: str = "0.0.0.0", port: int = 8300,
                  max_batch: int = 128, max_delay_ms: float = 5.0,
                  warmup: bool = True, ready_event=None, stop_event=None,
                  device=None):
    """Serve a port bundle on one device (CUDA unless ``device="cpu"``)
    until interrupted or ``stop_event`` is set."""
    from protoasnet_tpu_torch.serve import load_serving_bundle_with_spec

    fn, shape, dtype = load_serving_bundle_with_spec(bundle_path, device)
    _serve_loop(fn, shape[1:], dtype, host, port, max_batch, max_delay_ms,
                warmup, ready_event, banner=bundle_path,
                stop_event=stop_event)


def main(argv=None):
    import argparse
    import signal

    ap = argparse.ArgumentParser(prog="python -m protoasnet_tpu_torch.server")
    ap.add_argument("--bundle", required=True,
                    help="port bundle (serve.save_serving_bundle)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8300)
    ap.add_argument("--max_batch", type=int, default=128)
    ap.add_argument("--max_delay_ms", type=float, default=5.0)
    ap.add_argument("--no_warmup", action="store_true")
    a = ap.parse_args(argv)

    # Supervisors (systemd, k8s, docker stop) send SIGTERM, not SIGINT;
    # route it through stop_event so in-flight batches drain cleanly.
    # During startup (bundle load, kernel build, warmup) there is nothing
    # to drain: exit at once with the conventional 128 + SIGTERM.
    stop, ready = threading.Event(), threading.Event()

    def _on_term(*_):
        stop.set()
        if not ready.is_set():
            raise SystemExit(143)

    signal.signal(signal.SIGTERM, _on_term)
    serve_forever(a.bundle, a.host, a.port, a.max_batch, a.max_delay_ms,
                  warmup=not a.no_warmup, ready_event=ready, stop_event=stop,
                  device=a.device)


if __name__ == "__main__":
    main()
