"""Serving daemon of the port: dynamic batching over a bundle, HTTP front end.

The port's own copy of the JAX package's daemon (``protoasnet_tpu/server.py``)
with the same wire protocol, so the JAX package's client works against it:

- **One dispatch thread.** All device work happens on the batcher's
  dispatch thread, which keeps the device queue ordered and latency
  predictable. HTTP handler threads and the batcher's assembly thread only
  do numpy and queue operations: the assembly thread builds the next
  batch in a resident host buffer (pinned on a card) while the dispatch
  thread runs this one.
- **Bucketed batch shapes.** Requests are coalesced and padded up to a
  fixed ladder (powers of two up to ``max_batch``), so the set of batch
  shapes the model sees is finite and is warmed at startup.
- **Delay-window coalescing.** A group takes requests until ``max_batch``
  samples are gathered, or until the dispatch thread is free and
  ``max_delay_ms`` has passed since the group's first request.
- **Hot weight reload** (``--allow_reload``). ``POST /v1/reload`` loads
  another bundle or run directory and runs every bucket once on a side
  stream while the old weights keep serving, then swaps the model
  function in one attribute store (``Reloader``).

A trained run directory (the port's, or the JAX package's) is served live
with ``--run_dir``: the agent is rebuilt from the run's config and
``last.ckpt`` and served data-parallel over every local card (a replica
each, the batch split, ``max_batch`` and the buckets in multiples of the
card count), with ``--int8`` as the w8a8 model calibrated on the run's
train loader. A bundle is served on one device.

Usage:
    python -m protoasnet_tpu_torch.server --bundle b.zip --port 8300
    python -m protoasnet_tpu_torch.server --run_dir runs/<run> \
        [--uint8_input] [--int8 [--calib_batches 4]] \
        [--allow_reload --reload_root runs]
    # POST /v1/predict   body = .npy bytes (b, T, H, W[, 3]) for a video
    #                    bundle, (b, H, W[, 3]) for an image bundle -> logits
    # GET  /healthz      liveness
    # GET  /v1/spec      input contract (JSON)
    # GET  /v1/stats     batching/latency counters (JSON)
    # GET  /metrics      the same counters in Prometheus text format
    # POST /v1/reload    {"target": <bundle or run dir under the reload
    #                    root>} -> 202, the state before the swap
    # GET  /v1/reload    the reload state (idle, loading, compiling,
    #                    serving, error)
"""

from __future__ import annotations

import collections
import io
import json
import socket
import threading
import time
from http.server import ThreadingHTTPServer
from typing import (Any, Callable, Deque, List, Optional, Sequence,
                    Tuple)

import numpy as np

from protoasnet_tpu_torch.utils.profiling import count, interval, span

__all__ = ["DynamicBatcher", "BatcherStats", "Reloader", "make_handler",
           "serve_forever", "serve_live", "prometheus_text"]


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
    __slots__ = ("x", "event", "result", "error", "t_submit", "abandoned",
                 "request")

    def __init__(self, x: np.ndarray, request: Optional[int] = None):
        self.x = x              # (n, ...) batcher dtype, n >= 1
        self.request = request  # the request's id in the spans, if traced
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.abandoned = False  # waiter gave up; skip compute if not started


class _Group:
    """Requests coalesced into one batch, their rows copied into ``buf``
    as they joined: filled on the assembly thread, served on the dispatch
    thread."""

    __slots__ = ("pendings", "buf", "total", "build_ns", "sealed_ns")

    def __init__(self, buf: Optional[np.ndarray]):
        self.pendings: List[_Pending] = []
        # a resident buffer, or None: a fresh array at the first request
        self.buf = buf
        self.total = 0  # rows in buf
        self.build_ns = 0  # host ns spent copying rows and zeroing padding
        self.sealed_ns = 0  # time.time_ns() when handed to the dispatcher


_STOP = object()  # in the hand-off: the dispatch thread exits


class DynamicBatcher:
    """Coalesce concurrent requests into bucketed batches: each batch's
    bucket is built on one thread while the device runs the batch before
    it on another.

    - ``batcher-assemble`` (numpy and queue work only) takes one of two
      resident buffers of (largest bucket, *sample_shape) and copies each
      request's rows into it as the request joins the group. Without a
      ``sample_shape`` each group gets a fresh ``np.empty`` array instead. The group is
      sealed when ``max_batch`` is full, or when the dispatch thread is
      free and ``max_delay_ms`` has passed since the group's first
      request; then its padding rows are zeroed and it goes to a hand-off
      that holds one sealed group.
    - ``batcher-dispatch`` does all device work: it calls ``fn`` on the
      sealed buffer's first ``bucket`` rows (a view, no copy), hands out
      the results and returns the buffer.

    The resident buffers are allocated once, at construction, by
    ``fn.host_buffer(shape, dtype)`` where ``fn`` offers it
    (``serve.make_sharded_serving_fn``: pinned memory when its devices are
    cards), else by ``np.empty``.

    fn: the model function, e.g. ``serve.load_serving_bundle(path)`` —
        called as ``fn(x)`` with x ``dtype`` (bucket, *sample_shape); must
        return per-sample outputs with leading dim == bucket. Called only
        from the dispatch thread. x is refilled once fn returns (an
        output that shares its memory is copied first).
    sample_shape: optional per-sample shape; when set, submit() rejects
        mismatched requests instead of letting one bad request poison the
        whole coalesced batch.
    buckets: the batch sizes a group is padded to (sorted here; the
        largest must hold ``max_batch``); default ``_bucket_ladder``.
    """

    def __init__(self, fn: Callable, max_batch: int = 128,
                 max_delay_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 dtype=np.float32,
                 sample_shape: Optional[Sequence[int]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.fn = fn
        self.dtype = np.dtype(dtype)  # uint8 for --uint8_input bundles
        self.sample_shape = tuple(sample_shape) if sample_shape else None
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.buckets = tuple(sorted(int(b) for b in buckets)) if buckets \
            else _bucket_ladder(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")
        self.stats = BatcherStats()
        # one lock over the queue, the buffers and the hand-off; the
        # assembly thread waits on the first condition, the dispatch
        # thread on the second
        self._lock = threading.Lock()
        self._assemble_cv = threading.Condition(self._lock)
        self._dispatch_cv = threading.Condition(self._lock)
        self._queue: Deque[_Pending] = collections.deque()
        self._closed = False
        self._fatal: Optional[BaseException] = None
        # the resident buffers free to fill (none without a sample_shape)
        self._free: List[np.ndarray] = []
        if self.sample_shape is not None:
            make = getattr(fn, "host_buffer", np.empty)
            self._free = [make((self.buckets[-1], *self.sample_shape),
                               self.dtype) for _ in range(2)]
        # the groups in flight, so a fatal error or close() can fail their
        # waiters: being filled, sealed in the hand-off, being served
        self._filling: Optional[_Group] = None
        self._sealed: Any = None  # a _Group, _STOP or None
        self._serving: Optional[_Group] = None
        # dispatch thread only: when the last fn call returned (time_ns)
        self._fn_returned_ns: Optional[int] = None
        self._threads = [
            threading.Thread(target=self._guarded,
                             args=(self._assemble, "assembly"),
                             daemon=True, name="batcher-assemble"),
            threading.Thread(target=self._guarded,
                             args=(self._dispatch, "dispatch"),
                             daemon=True, name="batcher-dispatch")]
        for t in self._threads:
            t.start()

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

    def _enqueue(self, x: np.ndarray, request: Optional[int] = None
                 ) -> _Pending:
        p = _Pending(x, request)
        # the closed-check and the append under one lock: a request that
        # won the check is in the queue before close() can drain it
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.stats.record_request()
            self._queue.append(p)
            self._assemble_cv.notify()
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

    def submit_many(self, x: np.ndarray, timeout: Optional[float] = None,
                    request: Optional[int] = None) -> np.ndarray:
        """Any-size request: enqueue ALL max_batch-sized chunks up front
        (so chunk k+1's bucket is built while chunk k is on the device),
        then wait for each in order. ``request`` is the request's id in the
        spans (``utils/profiling.py``): each chunk's ``batcher.queue``
        carries it."""
        x = self._validate(x)
        deadline = None if timeout is None else time.monotonic() + timeout
        pendings = [self._enqueue(x[i:i + self.max_batch], request)
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
        """Serve every request already accepted, then stop both threads;
        whoever still waits after 10 s (behind an ``fn`` call that has not
        returned) gets an error."""
        with self._lock:
            self._closed = True
            self._assemble_cv.notify()
        deadline = time.monotonic() + 10.0
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._fail_all(RuntimeError("batcher closed"))

    # -- both threads -------------------------------------------------------

    def warmup(self, sample_shape: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket (or ``buckets``) once up front, one fn call
        each, so no live request pays the kernel build, cuDNN's algorithm
        choice or the allocator's first growth. Runs on the caller's
        thread — call before serving traffic."""
        shape = tuple(sample_shape) if sample_shape else self.sample_shape
        if shape is None:
            raise ValueError("warmup needs a sample_shape")
        for b in (buckets or self.buckets):
            np.asarray(self.fn(np.zeros((b, *shape), self.dtype)))

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @property
    def healthy(self) -> bool:
        """True while both threads are serving (or cleanly closed). False
        means one died on an unexpected error — /healthz reports 503 so
        an orchestrator restarts the daemon."""
        return self._fatal is None

    @staticmethod
    def _fail(pendings: Sequence[_Pending], error: BaseException) -> None:
        for p in pendings:
            if not p.event.is_set():
                p.error = error
                p.event.set()

    def _fail_all(self, error: BaseException) -> None:
        """Fail every waiter still waiting: in the group being served, the
        sealed one, the one being filled and the queue. A thread that
        outlives this drops their rows instead of computing them."""
        with self._lock:
            dead = [p for g in (self._serving, self._sealed, self._filling)
                    if isinstance(g, _Group) for p in g.pendings]
            dead.extend(self._queue)
            self._queue.clear()
        for p in dead:
            if not p.event.is_set():
                p.abandoned = True
        self._fail(dead, error)

    def _guarded(self, loop: Callable[[], None], role: str) -> None:
        try:
            loop()
        except BaseException as e:  # noqa: BLE001 — never die silently
            # each group's failures are contained where it is built or
            # served; anything that still escapes here would otherwise
            # zombie the daemon. Stop the other thread, fail every waiter
            # loudly instead of hanging them, and refuse new submits
            # (fail-fast beats accept-and-hang).
            with self._lock:
                if self._fatal is None:
                    self._fatal = e
                self._closed = True
                self._assemble_cv.notify_all()
                self._dispatch_cv.notify_all()
            self._fail_all(RuntimeError(f"{role} thread died: {e!r}"))
            raise

    # -- assembly thread ----------------------------------------------------

    def _assemble(self):
        while True:
            with self._lock:
                while (self.sample_shape is not None and not self._free
                       and self._fatal is None):
                    self._assemble_cv.wait()
                if self._fatal is not None:
                    return
                g = self._filling = _Group(
                    self._free.pop() if self._free else None)
            deadline = 0.0
            while g.total < self.max_batch:
                p = self._join(g, deadline)
                if p is None:
                    break
                if g.buf is None:  # no resident buffers: a fresh array
                    try:
                        # INSIDE a try: a transient MemoryError on a big
                        # array must fail this request, not kill the thread
                        g.buf = np.empty((self.buckets[-1], *p.x.shape[1:]),
                                         self.dtype)
                    except Exception as e:  # noqa: BLE001 — to its waiter
                        with self._lock:
                            g.pendings.remove(p)
                        self.stats.record_error()
                        self._fail([p], e)
                        continue
                if len(g.pendings) == 1:  # the group's first request
                    deadline = time.monotonic() + self.max_delay_s
                t0 = time.perf_counter_ns()
                g.buf[g.total:g.total + len(p.x)] = p.x
                g.total += len(p.x)
                g.build_ns += time.perf_counter_ns() - t0
            if not self._seal(g):
                return

    def _join(self, g: _Group, deadline: float) -> Optional[_Pending]:
        """The next request for ``g``, taken from the queue; None when g
        is to be sealed: the next request does not fit it (too many rows,
        another sample shape), the batcher closes with the queue empty, or
        the dispatch thread is free and the delay window has passed."""
        with self._lock:
            while self._fatal is None:
                if self._queue:
                    p = self._queue[0]
                    if p.abandoned:
                        self._queue.popleft()
                        self.stats.record_abandoned()
                        continue
                    if g.pendings and (
                            g.total + len(p.x) > self.max_batch
                            or p.x.shape[1:] != g.pendings[0].x.shape[1:]):
                        # it opens the next group: one request can't
                        # poison another's batch
                        return None
                    self._queue.popleft()
                    g.pendings.append(p)
                    return p
                if self._closed:
                    return None
                if not g.pendings:
                    self._assemble_cv.wait()
                    continue
                left = deadline - time.monotonic()
                if left > 0:
                    self._assemble_cv.wait(left)
                elif self._serving is None and self._sealed is None:
                    return None
                else:  # past the window, the device busy: keep coalescing
                    self._assemble_cv.wait()
            return None

    def _seal(self, g: _Group) -> bool:
        """Zero g's padding rows and hand g to the dispatch thread; an
        empty group (closed, the queue drained) stops it instead. False
        when this thread is to exit."""
        if g.pendings:
            t0 = time.perf_counter_ns()
            g.buf[g.total:self._pick_bucket(g.total)] = 0
            g.build_ns += time.perf_counter_ns() - t0
        with self._lock:
            while self._sealed is not None and self._fatal is None:
                self._assemble_cv.wait()
            if self._fatal is not None:
                return False
            self._filling = None
            if g.pendings:
                g.sealed_ns = time.time_ns()
                self._sealed = g
            else:
                self._give_back(g)
                self._sealed = _STOP
            self._dispatch_cv.notify()
        return bool(g.pendings)

    def _give_back(self, g: _Group) -> None:
        """Under the lock: g's resident buffer is free to fill again."""
        if self.sample_shape is not None:
            self._free.append(g.buf)

    # -- dispatch thread ----------------------------------------------------

    def _dispatch(self):
        while True:
            with self._lock:
                while self._sealed is None and self._fatal is None:
                    self._dispatch_cv.wait()
                if self._fatal is not None or self._sealed is _STOP:
                    return
                g, self._sealed = self._sealed, None
                self._serving = g
                self._assemble_cv.notify()  # the hand-off is free
            self._serve(g)
            with self._lock:
                self._serving = None
                self._give_back(g)
                self._assemble_cv.notify()  # a buffer and the device free

    def _serve(self, g: _Group):
        # drop requests whose waiter timed out while queued — computing
        # them would spend chip time on work nobody reads (overload spiral)
        live = [p for p in g.pendings if not p.abandoned]
        for _ in range(len(g.pendings) - len(live)):
            self.stats.record_abandoned()
        if not live:
            return
        total = sum(len(p.x) for p in live)
        bucket = self._pick_bucket(total)
        with span("batcher.batch", samples=total, bucket=bucket) as batch:
            try:
                if len(live) < len(g.pendings):
                    # a waiter gave up after its rows went in: pack the
                    # rest again
                    t0 = time.perf_counter_ns()
                    ofs = 0
                    for p in live:
                        g.buf[ofs:ofs + len(p.x)] = p.x
                        ofs += len(p.x)
                    g.buf[ofs:bucket] = 0
                    g.build_ns += time.perf_counter_ns() - t0
                # sealed before the last fn call returned: built while it ran
                ahead = (self._fn_returned_ns is not None
                         and g.sealed_ns < self._fn_returned_ns)
                count("batcher.assembled_ahead" if ahead
                      else "batcher.assembled_inline")
                if batch is not None:
                    # the host time that built the bucket, on the assembly
                    # thread, up to its sealing
                    interval("batcher.assemble", g.sealed_ns - g.build_ns,
                             g.sealed_ns, parent=batch.id)
                    # each chunk's wait, from its enqueue to this call
                    now_ns, now = time.time_ns(), time.monotonic()
                    for p in live:
                        waited_ns = int((now - p.t_submit) * 1e9)
                        interval("batcher.queue", now_ns - waited_ns, now_ns,
                                 parent=batch.id, request=p.request)
                try:
                    out = self.fn(g.buf[:bucket])
                finally:
                    self._fn_returned_ns = time.time_ns()
                out = np.asarray(out, np.float32)
                if np.may_share_memory(out, g.buf):
                    out = out.copy()  # the buffer takes the next group
                t_done = time.monotonic()
                ofs = 0
                lats = []
                for p in live:
                    p.result = out[ofs:ofs + len(p.x)]
                    ofs += len(p.x)
                    lats.append((t_done - p.t_submit) * 1e3)
                    p.event.set()
                self.stats.record_batch(total, bucket, lats)
            except BaseException as e:  # noqa: BLE001 — to all waiters
                self.stats.record_error()
                self._fail(live, e)


class Reloader:
    """Hot-swap the batcher's model function without dropping traffic.

    The JAX package's state machine and JSON (``protoasnet_tpu/server.py``
    ``Reloader``), with the device work done the way PyTorch needs it:

    - ``build(target, int8)`` (from ``serve_live`` or ``serve_forever``)
      loads the new run or bundle and returns ``(fn, sample_shape,
      dtype)``, fn numpy in, numpy logits out ("loading");
    - the reloader thread then runs every bucket of the new fn once
      ("compiling": the state keeps the JAX package's name, which clients
      poll for). PyTorch compiles nothing ahead of time; a first call pays
      the kernel library's load, cuDNN's choice of plan per shape and the
      allocator's growth, and this pays them before the swap. On a CUDA
      device the load and the warm-up run on a dedicated stream, so the
      dispatch thread's stream keeps serving the old weights throughout,
      and that stream is synchronised before the swap, so no request can
      read weights whose copy to the device has not landed;
    - the swap is one attribute store (``batcher.fn = new_fn``), and the
      dispatch thread reads ``self.fn`` once per group, so every request
      is served entirely by one weight set. The old model is freed only
      when the last group that read it has finished. The batcher keeps
      its buffers: pinned host memory serves every card of the process.

    The head kernels' launch counters count the warm-up's launches too.

    Path safety: the daemon binds 0.0.0.0 by default, so reload is off
    unless ``--allow_reload`` is given, and targets must resolve
    (realpath, so symlinks cannot escape) under ``root``, by default the
    initial artifact's parent directory. A root of ``/`` admits every
    absolute path.

    One reload at a time (409 while busy); a failure (a bad file, a model
    whose input contract differs) leaves the old fn serving and parks the
    error in the status JSON (GET /v1/reload).
    """

    def __init__(self, batcher: DynamicBatcher, build: Callable, root: str,
                 default_int8: bool = False, device=None):
        import os

        self.batcher = batcher
        self.build = build  # (target, int8) -> (fn, sample_shape, dtype)
        self.root = os.path.realpath(root)
        self.default_int8 = bool(default_int8)
        self.device = device  # a CUDA device: warm up on a side stream
        self._stream = None  # that stream, made at the first reload
        self.generation = 0  # completed swaps
        self._lock = threading.Lock()
        self._busy = False
        self._state = {"generation": 0, "state": "idle", "target": None,
                       "error": None}

    def status(self) -> dict:
        with self._lock:
            return dict(self._state, root=self.root)

    def request(self, target: str, int8=None) -> Tuple[int, dict]:
        """Validate and start a reload; returns (http_code, body)."""
        import os

        real = os.path.realpath(target)
        # rstrip so a reload root of "/" yields the prefix "/", not "//"
        if real != self.root and not real.startswith(
                self.root.rstrip(os.sep) + os.sep):
            return 400, {"error": f"target {target!r} resolves outside the "
                                  f"reload root {self.root!r}"}
        if not os.path.exists(real):
            return 400, {"error": f"target {target!r} does not exist"}
        with self._lock:
            if self._busy:
                return 409, dict(self._state, error="reload in progress")
            self._busy = True
            self._state = {"generation": self.generation, "state": "loading",
                           "target": target, "error": None}
            # the 202 body is the state before the worker starts: taken
            # under the lock, since the worker may finish before we return
            accepted = dict(self._state, root=self.root)
        threading.Thread(target=self._work, args=(real, int8), daemon=True,
                         name="reloader").start()
        return 202, accepted

    def _side_stream(self):
        """The reloader's own CUDA stream on the daemon's device, else None.
        One stream for the daemon's lifetime: the caching allocator keeps
        freed blocks per stream, so a new stream per reload would hold
        another warm-up's worth of device memory each time."""
        if self.device is None:
            return None
        import torch

        dev = torch.device(self.device)
        if dev.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        return self._stream

    def _work(self, target: str, int8) -> None:
        import contextlib

        try:
            stream = self._side_stream()
            if stream is None:
                on_stream = contextlib.nullcontext()
            else:
                import torch

                on_stream = torch.cuda.stream(stream)
            with on_stream:
                fn, sample_shape, dtype = self.build(
                    target, self.default_int8 if int8 is None else bool(int8))
                sample_shape = tuple(sample_shape)
                if (sample_shape != self.batcher.sample_shape
                        or np.dtype(dtype) != self.batcher.dtype):
                    # the input contract (/v1/spec, checked per request) is
                    # fixed for the daemon's lifetime
                    raise ValueError(
                        f"new model input {sample_shape}/"
                        f"{np.dtype(dtype).name} != serving contract "
                        f"{self.batcher.sample_shape}/"
                        f"{self.batcher.dtype.name}")
                with self._lock:
                    self._state["state"] = "compiling"
                for b in self.batcher.buckets:
                    np.asarray(fn(np.zeros((b, *sample_shape), dtype)))
            if stream is not None:
                stream.synchronize()
            self.batcher.fn = fn  # THE swap: one attribute store
            with self._lock:
                self.generation += 1
                self._state.update(state="serving",
                                   generation=self.generation)
                self._busy = False
        except BaseException as e:  # noqa: BLE001 — old weights keep serving
            with self._lock:
                self._state.update(state="error",
                                   error=f"{type(e).__name__}: {e}")
                self._busy = False
            if not isinstance(e, Exception):
                raise


# --- HTTP front end ---------------------------------------------------------


_RELOAD_OFF = b"reload disabled (start the daemon with --allow_reload)"


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that closes a connection only after its client
    has, and listens with the kernel's largest backlog.

    A connection the server closes first leaves its address pair in
    TIME_WAIT on the server for a minute, out of sight of the client's
    port allocator: a client that opens a connection per request (every
    urllib request does) now and then picks that port again, and its
    handshake stalls until TIME_WAIT ends (63 s on the card's machine).
    Reading to the client's FIN first, for at most ``linger_s``, puts
    TIME_WAIT on the client's side. The default backlog of 5 overflows
    when a few clients connect at once, and each dropped handshake costs
    a retransmission of 1 s or more."""

    request_queue_size = socket.SOMAXCONN
    linger_s = 2.0

    def shutdown_request(self, request):
        deadline = time.monotonic() + self.linger_s
        try:
            while (left := deadline - time.monotonic()) > 0:
                request.settimeout(left)
                if not request.recv(1 << 16):
                    break
        except OSError:  # a timeout or a reset: close anyway
            pass
        super().shutdown_request(request)


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
                 max_body_bytes: int = 256 << 20,
                 reloader: Optional[Reloader] = None):
    """BaseHTTPRequestHandler subclass bound to ``batcher``.

    sample_ndim: rank WITHOUT batch (4 for video (T,H,W,3), 3 for image).
    Accepts request bodies with or without the batch dim.
    max_body_bytes: reject larger payloads with 413 before reading them
    (the daemon binds 0.0.0.0 by default — an unbounded Content-Length
    would let any client OOM the serving host).
    reloader: enables POST/GET /v1/reload; None (default) answers both
    with 403 (see Reloader's path safety)."""
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
                if reloader is not None:
                    snap["reload"] = reloader.status()
                self._send(200, json.dumps(snap).encode(), "application/json")
            elif self.path == "/v1/reload":
                if reloader is None:
                    self._send(403, _RELOAD_OFF, "text/plain")
                else:
                    self._send(200, json.dumps(
                        reloader.status()).encode(), "application/json")
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
            if self.path == "/v1/reload":
                self._do_reload()
                return
            if self.path != "/v1/predict":
                self._send(404, b"not found", "text/plain")
                return
            with self.inflight:
                self._do_predict()

        def _do_reload(self):
            if reloader is None:
                self._send(403, _RELOAD_OFF, "text/plain")
                return
            cl = self.headers.get("Content-Length")
            try:
                n = int(cl) if cl is not None else -1
            except ValueError:
                n = -1
            if not 0 <= n <= (64 << 10):  # control-plane body: tiny JSON
                self.close_connection = True
                self._send(400, b"Content-Length required (<= 64 KiB JSON)",
                           "text/plain")
                return
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                target = body["target"]
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, f'expected {{"target": <path>}} JSON: '
                           f"{e!r}".encode(), "text/plain")
                return
            code, resp = reloader.request(str(target), body.get("int8"))
            self._send(code, json.dumps(resp).encode(), "application/json")

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
                with span("http.decode") as decode:
                    try:
                        x = np.load(io.BytesIO(self.rfile.read(n)),
                                    allow_pickle=False)
                    except Exception as e:
                        # np.load raises EOFError/OSError/... on truncated
                        # or empty bodies — all client-side payload problems
                        # (400), not retryable server faults (503)
                        raise ValueError(f"bad .npy payload: {e}") from None
                    if x.ndim == sample_ndim:
                        x = x[None]
                    if x.ndim != sample_ndim + 1:
                        raise ValueError(
                            f"expected rank {sample_ndim} or "
                            f"{sample_ndim + 1}, got {x.ndim}")
                out = batcher.submit_many(
                    x, timeout=timeout_s,
                    request=None if decode is None else decode.id)
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
                max_delay_ms, warmup, ready_event, buckets=None,
                banner="", stop_event=None, reload_build=None,
                reload_root=None, reload_int8=False, device=None):
    """ready_event (optional): set once the socket is bound; the bound
    port is published as ``ready_event.port`` (useful with port=0).
    stop_event (optional): setting it shuts the server down cleanly —
    the test/embedding hook, since serve_forever() otherwise only exits
    on KeyboardInterrupt.
    reload_build (optional): ``(target, int8) -> (fn, sample_shape,
    dtype)``; enables the /v1/reload hot swap rooted at ``reload_root``,
    warmed on a side stream of ``device`` when that is a CUDA device."""
    batcher = DynamicBatcher(fn, max_batch=max_batch,
                             max_delay_ms=max_delay_ms, dtype=dtype,
                             buckets=buckets, sample_shape=sample_shape)
    try:
        if warmup:
            t0 = time.monotonic()
            batcher.warmup()
            print(f"warmed {len(batcher.buckets)} buckets "
                  f"{batcher.buckets} in {time.monotonic() - t0:.1f}s")
        sample_bytes = int(np.prod(sample_shape)) * np.dtype(dtype).itemsize
        reloader = None
        if reload_build is not None:
            reloader = Reloader(batcher, reload_build, reload_root,
                                default_int8=reload_int8, device=device)
        handler_cls = make_handler(
            batcher, sample_ndim=len(sample_shape),
            # npy header is tiny; allow 16 full batches per request
            max_body_bytes=16 * max_batch * sample_bytes + (1 << 20),
            reloader=reloader)
        httpd = _HTTPServer((host, port), handler_cls)
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
                  device=None, allow_reload: bool = False, reload_root=None):
    """Serve a port bundle on one device (CUDA unless ``device="cpu"``)
    until interrupted or ``stop_event`` is set.

    allow_reload: expose POST /v1/reload {"target": <bundle under
    reload_root>} to hot-swap to another port bundle (see Reloader); a
    bundle is self-contained, so its ``int8`` flag is ignored.
    """
    import os

    from protoasnet_tpu_torch.serve import load_serving_bundle_with_spec
    from protoasnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fn, shape, dtype = load_serving_bundle_with_spec(bundle_path, dev)

    reload_build = None
    if allow_reload:
        def reload_build(target, int8):
            nfn, nshape, ndtype = load_serving_bundle_with_spec(target, dev)
            return nfn, nshape[1:], ndtype

    _serve_loop(fn, shape[1:], dtype, host, port, max_batch, max_delay_ms,
                warmup, ready_event, banner=bundle_path,
                stop_event=stop_event, reload_build=reload_build,
                reload_root=reload_root or os.path.dirname(
                    os.path.abspath(bundle_path)), device=dev)


def live_devices(device=None, devices=None) -> List[Any]:
    """The devices ``serve_live`` replicates over: ``devices`` when given,
    else every local card for a CUDA ``device`` (the default), else the
    CPU."""
    import torch

    from protoasnet_tpu_torch.utils.device import resolve_device

    if devices is not None:
        return [torch.device(d) for d in devices]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def sharded_buckets(max_batch: int, n_dev: int
                    ) -> Tuple[int, Tuple[int, ...]]:
    """(max_batch, buckets) in multiples of the device count, so that every
    shard of a batch is equal, as the JAX package's ``serve_live`` has
    them: max_batch rounded down to a multiple (at least ``n_dev``), the
    ladder of max_batch / n_dev times ``n_dev``."""
    max_batch = max(n_dev, (max_batch // n_dev) * n_dev)
    return max_batch, tuple(n_dev * b
                            for b in _bucket_ladder(max_batch // n_dev))


def serve_live(run_dir: str, host: str = "0.0.0.0", port: int = 8300,
               max_batch: int = 128, max_delay_ms: float = 5.0,
               warmup: bool = True, ready_event=None,
               uint8_input: bool = False, int8: bool = False,
               calib_batches: int = 4, stop_event=None,
               allow_reload: bool = False, reload_root=None, device=None,
               devices=None):
    """Serve a trained run directory live, data-parallel over every local
    card (CUDA unless ``device="cpu"``; ``devices`` names them), with
    ``max_batch`` and the bucket ladder in multiples of the device count
    (``sharded_buckets``).

    The run (the port's, or the JAX package's) is rebuilt by
    ``serve.load_trained_agent`` on the first device and served through
    ``serve.make_sharded_serving_fn``, one replica a device; on one device
    that is ``make_serving_fn``, an exported bundle's, so the live logits
    equal the bundle's. uint8_input: raw grayscale uint8 frames in, the
    eval transform on the device. int8: the w8a8 backbone, calibrated on
    ``calib_batches`` batches of the run's train loader
    (``quant.calibrate_qstate_from_agent``, as ``serve export --int8``
    does, so the live logits equal the int8 bundle's).

    allow_reload: expose POST /v1/reload {"target": <run dir under
    reload_root>, "int8": bool?}: the new run is rebuilt (and, with int8,
    calibrated and quantised) with all its replicas on the reload thread
    and warmed while the old weights serve, then swapped in (see
    Reloader; its side stream is on the first device); ``int8`` defaults
    to this server's. A run whose per-sample input differs is refused.
    """
    import os

    from protoasnet_tpu_torch.quant import calibrate_qstate_from_agent
    from protoasnet_tpu_torch.serve import (load_trained_agent,
                                            make_sharded_serving_fn,
                                            serving_model)

    devs = live_devices(device, devices)
    dev = devs[0]
    max_batch, buckets = sharded_buckets(max_batch, len(devs))

    def build(run, want_int8):
        agent, shape = load_trained_agent(run, dev)
        qstate = (calibrate_qstate_from_agent(agent, calib_batches)
                  if want_int8 else None)
        model = serving_model(agent.model, qstate)
        return (make_sharded_serving_fn(model, devs, uint8_input),
                tuple(shape))

    fn, input_shape = build(run_dir, int8)
    sample_shape = input_shape[:-1] if uint8_input else input_shape
    dtype = np.dtype(np.uint8 if uint8_input else np.float32)

    reload_build = None
    if allow_reload:
        def reload_build(target, want_int8):
            new_fn, new_shape = build(target, want_int8)
            if new_shape != input_shape:
                raise ValueError(f"run {target!r} input {new_shape} != "
                                 f"serving contract {input_shape}")
            return new_fn, sample_shape, dtype

    _serve_loop(fn, sample_shape, dtype, host, port, max_batch,
                max_delay_ms, warmup, ready_event, buckets=buckets,
                banner=f"{run_dir} live ({', '.join(map(str, devs))})",
                stop_event=stop_event,
                reload_build=reload_build,
                reload_root=reload_root or os.path.dirname(
                    os.path.abspath(run_dir)), reload_int8=int8, device=dev)


def main(argv=None):
    import argparse
    import signal

    ap = argparse.ArgumentParser(prog="python -m protoasnet_tpu_torch.server")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle",
                     help="port bundle (serve.save_serving_bundle)")
    src.add_argument("--run_dir",
                     help="trained run dir (the port's or the JAX "
                          "package's): serve it live over every local "
                          "card")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8300)
    ap.add_argument("--max_batch", type=int, default=128,
                    help="measure it on the card: python -m "
                         "protoasnet_tpu_torch.serve tune")
    ap.add_argument("--max_delay_ms", type=float, default=5.0)
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--uint8_input", action="store_true",
                    help="(--run_dir only) raw grayscale uint8 frames in, "
                         "eval transform on the device")
    ap.add_argument("--int8", action="store_true",
                    help="(--run_dir only) w8a8 backbone, calibrated on the "
                         "run's train loader (reloads default to it)")
    ap.add_argument("--calib_batches", type=int, default=4,
                    help="(--int8 only) calibration batches")
    ap.add_argument("--allow_reload", action="store_true",
                    help="expose POST /v1/reload weight hot-swap; targets "
                         "must resolve under --reload_root")
    ap.add_argument("--reload_root", default=None,
                    help="directory reload targets must live under "
                         "(default: the initial artifact's parent dir)")
    a = ap.parse_args(argv)

    # Supervisors (systemd, k8s, docker stop) send SIGTERM, not SIGINT;
    # route it through stop_event so in-flight batches drain cleanly.
    # During startup (model load, kernel build, warmup) there is nothing
    # to drain: exit at once with the conventional 128 + SIGTERM.
    stop, ready = threading.Event(), threading.Event()

    def _on_term(*_):
        stop.set()
        if not ready.is_set():
            raise SystemExit(143)

    signal.signal(signal.SIGTERM, _on_term)
    if a.bundle:
        serve_forever(a.bundle, a.host, a.port, a.max_batch, a.max_delay_ms,
                      warmup=not a.no_warmup, ready_event=ready,
                      stop_event=stop, device=a.device,
                      allow_reload=a.allow_reload, reload_root=a.reload_root)
    else:
        serve_live(a.run_dir, a.host, a.port, a.max_batch, a.max_delay_ms,
                   warmup=not a.no_warmup, ready_event=ready,
                   uint8_input=a.uint8_input, int8=a.int8,
                   calib_batches=a.calib_batches, stop_event=stop,
                   allow_reload=a.allow_reload, reload_root=a.reload_root,
                   device=a.device)


if __name__ == "__main__":
    main()
