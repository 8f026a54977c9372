"""Python client of the port's serving daemon (``server.py``), the port's
own copy of ``protoasnet_tpu/client.py``: standard library and numpy only,
so a machine that runs only the port needs nothing else to reach its
daemon. The wire is the same as the JAX package's daemon's, so either
client works against either daemon.

Request and response bodies are ``.npy`` bytes (``allow_pickle=False``
both ways). The client

- discovers the input contract from ``GET /v1/spec`` (sample shape,
  dtype, body cap) and validates/encodes locally, so a uint8 daemon gets
  uint8 bytes (4x fewer than float32, 12x fewer than float32 RGB) without
  the caller knowing the wire dtype;
- chunks large arrays so every request stays under the server's body cap
  and request-sample ceiling (published in the spec). Within ONE request
  the server itself queues max_batch-sized chunks (server.submit_many);
  client-side requests are sequential — prefer few large requests over
  many small ones;
- maps status codes to typed errors — `BadRequestError` (400/403/404/413,
  the request is wrong, never retried) vs `RetryableError` (504 overload /
  503 fault / connection refused-reset, retried with backoff).

Usage::

    from protoasnet_tpu_torch.client import ServingClient
    c = ServingClient("http://host:8300")
    logits = c.predict(clips)          # (n, ...) -> (n, num_classes)
    c.reload("runs/newer_run")         # weight hot-swap (--allow_reload)

CLI::

    python -m protoasnet_tpu_torch.client --url http://host:8300 \
        --input clips.npy --out logits.npy
    python -m protoasnet_tpu_torch.client --url http://host:8300 \
        --reload runs/newer_run
"""
from __future__ import annotations

import http.client
import io
import json
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

__all__ = ["ServingClient", "ServingError", "BadRequestError",
           "RetryableError"]


class ServingError(Exception):
    """Base class; ``status`` is the HTTP code (0 for transport errors)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}" if status else message)
        self.status = status


class BadRequestError(ServingError):
    """400/413 — the payload itself is wrong; retrying cannot help."""


class RetryableError(ServingError):
    """504 overload, 503 server fault, or a transport error — the same
    request may succeed on retry (predict is idempotent)."""


def _encode(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def _decode(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


class ServingClient:
    def __init__(self, base_url: str, timeout_s: float = 300.0,
                 retries: int = 2, backoff_s: float = 0.5):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        # None = not probed yet; False = known absent/unreachable (cached
        # by _try_spec); dict = the contract
        self._spec = None

    # -- plumbing -----------------------------------------------------------

    def _request(self, path: str, body: Optional[bytes] = None) -> bytes:
        req = urllib.request.Request(
            self.base_url + path, data=body,
            method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            try:
                msg = e.read().decode(errors="replace")
            except OSError:  # connection died mid-error-body
                msg = "(error body unreadable)"
            if e.code in (400, 403, 404, 413):
                raise BadRequestError(e.code, msg) from None
            raise RetryableError(e.code, msg) from None
        # mid-response drops raise http.client exceptions (IncompleteRead,
        # RemoteDisconnected) that are neither URLError nor ConnectionError
        # — all transport faults, all retryable
        except (urllib.error.URLError, http.client.HTTPException,
                TimeoutError, OSError) as e:
            raise RetryableError(0, f"{type(e).__name__}: {e}") from None

    def _request_retry(self, path: str, body: Optional[bytes] = None) -> bytes:
        for attempt in range(self.retries + 1):
            try:
                return self._request(path, body)
            except RetryableError:
                if attempt == self.retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))
        raise AssertionError("unreachable")

    # -- surface ------------------------------------------------------------

    def healthy(self) -> bool:
        try:
            return self._request("/healthz") == b"ok"
        except ServingError:
            return False

    def stats(self) -> dict:
        return json.loads(self._request("/v1/stats"))

    def spec(self) -> dict:
        """Input contract (cached): sample_shape, dtype, max_batch,
        buckets, max_body_bytes, max_request_samples. Raises
        BadRequestError(404) against a pre-spec daemon — predict() then
        falls back to one request."""
        if not isinstance(self._spec, dict):  # None, or False = cached miss
            got = json.loads(self._request_retry("/v1/spec"))
            if not isinstance(got, dict):
                # a proxy/LB answering unknown paths with 200 + junk must
                # not poison predict(): surface as a non-retryable miss
                raise BadRequestError(
                    0, f"/v1/spec returned non-dict JSON: {got!r:.80}")
            self._spec = got
        return self._spec

    def _try_spec(self) -> Optional[dict]:
        """spec() for internal best-effort use — a broken or absent spec
        endpoint can never fail an otherwise-healthy /v1/predict.
        Definitive misses (404 pre-spec daemon, non-JSON/non-dict body)
        are cached so predict() probes at most once per client; transient
        transport failures are NOT cached, so a blip during the first
        call doesn't permanently disable chunking/coercion."""
        if self._spec is False:  # cached definitive negative
            return None
        try:
            return self.spec()
        except (BadRequestError, ValueError):  # ValueError: non-JSON body
            self._spec = False
            return None
        except RetryableError:
            return None  # transient — re-probe on the next call

    def _chunk_samples(self, x: np.ndarray, spec: Optional[dict]) -> int:
        """Largest per-request sample count the server accepts."""
        if spec is None:  # pre-/v1/spec daemon: single request
            return len(x)
        cap = len(x)
        if spec.get("max_request_samples"):
            cap = min(cap, int(spec["max_request_samples"]))
        elif spec.get("max_batch"):
            # older spec without the explicit ceiling: mirror the server's
            # 16-full-batches body-cap sizing (server.py make_handler)
            cap = min(cap, 16 * int(spec["max_batch"]))
        if spec.get("max_body_bytes"):
            per = int(np.prod(x.shape[1:])) * x.dtype.itemsize
            # leave the npy header + margin out of the budget
            cap = min(cap, max(1, (int(spec["max_body_bytes"]) - (1 << 16))
                               // max(1, per)))
        return max(1, cap)

    @staticmethod
    def _coerce(x: np.ndarray, spec: Optional[dict]) -> np.ndarray:
        """Cast to the wire dtype only when it SHRINKS the payload (a
        float64 array bound for a float32 daemon downcasts here rather
        than shipping 2x the bytes for the server to downcast anyway).
        Never widens — the server's validator upcasts narrow same-kind
        inputs for free, so e.g. float16 ships as float16. Never coerces
        lossily (float frames to a uint8 daemon) — that 400s loudly
        server-side instead of silently truncating."""
        if spec is None:
            return x
        want = np.dtype(spec.get("dtype", x.dtype))
        if (want.itemsize < x.dtype.itemsize
                and np.can_cast(x.dtype, want, casting="same_kind")):
            return x.astype(want)
        return x

    def reload_status(self) -> dict:
        """``GET /v1/reload`` — the daemon's reload state machine (keys:
        ``state``, ``generation``, ``target``, ``error``, ``root``).
        Raises BadRequestError(403) against a daemon started without
        ``--allow_reload``."""
        return json.loads(self._request("/v1/reload"))

    def reload(self, target: str, int8: Optional[bool] = None,
               wait: bool = True, poll_s: float = 0.5,
               timeout_s: Optional[float] = None) -> dict:
        """Hot-swap the daemon's weights: ``POST /v1/reload {"target": …}``.

        ``target`` is a path *on the daemon's host* under its reload root
        (server.Reloader path policy). ``int8`` overrides the daemon's
        quantization default for the new weights; None keeps it (the
        port's daemon refuses ``True`` until w8a8 is ported).

        The POST is deliberately NOT auto-retried (it is a control-plane
        mutation, not an idempotent read): 403 (reload disabled) and 400
        (bad target) raise BadRequestError; 409 (another reload already
        in flight) raises RetryableError — poll :meth:`reload_status`
        and re-issue when it leaves ``loading``/``compiling``.

        With ``wait=True`` (default) polls until the swap lands (status
        ``serving`` with a bumped ``generation``) and returns the final
        status; a load or warm-up failure raises ServingError with the
        daemon-side error (old weights keep serving — Reloader contract).
        With ``wait=False`` returns the 202 acceptance body immediately.

        ``timeout_s`` (the wait deadline) defaults to
        ``max(self.timeout_s, 1800)``, NOT the client's request timeout: a
        reload rebuilds the run's agent and runs every bucket of the
        ladder once before the swap, so it can take far longer than one
        request.
        """
        body = {"target": target}
        if int8 is not None:
            body["int8"] = bool(int8)
        accepted = json.loads(self._request(
            "/v1/reload", json.dumps(body).encode()))
        if not wait:
            return accepted
        # 202 body is the pre-swap status: generation = completed swaps
        gen0 = int(accepted.get("generation", 0))
        wait_s = (max(self.timeout_s, 1800.0) if timeout_s is None
                  else float(timeout_s))
        deadline = time.monotonic() + wait_s
        st = accepted
        while time.monotonic() < deadline:
            st = self.reload_status()
            if st.get("state") == "error":
                raise ServingError(0, f"reload of {target!r} failed "
                                      f"server-side: {st.get('error')}")
            if (st.get("state") == "serving"
                    and int(st.get("generation", 0)) > gen0):
                return st
            time.sleep(poll_s)
        raise RetryableError(
            0, f"reload of {target!r} not confirmed within {wait_s}s "
               f"(last status: {st})")

    def predict(self, x: np.ndarray) -> np.ndarray:
        """POST ``x`` (one sample or a batch) -> stacked outputs.

        Chunks client-side to the server's request ceiling; each chunk
        retried independently on RetryableError."""
        x = np.asarray(x)
        batched = True
        spec = self._try_spec()  # probed once per call, cached when definitive
        spec_shape = spec.get("sample_shape") if spec else None
        # NOTE against a pre-/v1/spec daemon the sample rank is unknown,
        # so an unbatched input comes back with the server-added batch
        # dim (1, ...) instead of being squeezed — pass batched arrays
        # for version-independent shapes
        if spec_shape is not None and x.ndim == len(spec_shape):
            x, batched = x[None], False
        if x.size == 0:
            raise BadRequestError(0, "empty input array")
        x = self._coerce(x, spec)
        step = self._chunk_samples(x, spec)
        outs = []
        for i in range(0, len(x), step):
            body = _encode(np.ascontiguousarray(x[i:i + step]))
            outs.append(_decode(self._request_retry("/v1/predict", body)))
        out = np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        return out if batched else out[0]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Remote predict against a serving daemon")
    ap.add_argument("--url", required=True, help="e.g. http://host:8300")
    ap.add_argument("--input", help=".npy array of inputs")
    ap.add_argument("--out", default=None, help=".npy to write logits to")
    ap.add_argument("--timeout_s", type=float, default=300.0)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--reload", metavar="TARGET", default=None,
                    help="hot-swap the daemon to this checkpoint/bundle "
                         "path (on the daemon's host) and exit; requires "
                         "a daemon started with --allow_reload")
    a = ap.parse_args(argv)

    c = ServingClient(a.url, timeout_s=a.timeout_s, retries=a.retries)
    if a.reload is not None:
        st = c.reload(a.reload)
        print(f"reloaded to {a.reload} (generation {st['generation']})")
        return
    if a.input is None:
        ap.error("--input is required unless --reload is given")
    x = np.load(a.input, allow_pickle=False)
    t0 = time.monotonic()
    out = c.predict(x)
    dt = time.monotonic() - t0
    print(f"{len(np.atleast_2d(out))} predictions in {dt:.2f}s")
    if a.out:
        np.save(a.out, out)
        print(f"wrote {a.out} {out.shape} {out.dtype}")
    else:
        print(out)


if __name__ == "__main__":
    main()
