"""Tracing and profiling (the JAX package's ``utils/profiling.py`` on
``torch.profiler``).

* ``StepTimer``: per-epoch wall-clock breakdown of data wait, step
  dispatch and host-metric time, logged at the epoch's end (always on).
* ``trace(log_dir)``: a ``torch.profiler`` window (CPU, and CUDA when the
  card is there) around the wrapped region, written to ``log_dir`` by
  ``tensorboard_trace_handler`` (a ``*.pt.trace.json`` TensorBoard's
  profiler plugin loads); the agents open it at ``profile_epoch`` of a
  training epoch when ``profile_dir`` or ``PROTOASNET_PROFILE_DIR`` is set.
* ``span(name, **ids)``, ``count(name, n)``, ``interval(...)`` and
  ``spans()``: spans and counters inside the program (the daemon's HTTP
  decode, queue wait, batch assembly and H2D copy; the train micro-step and
  its host synchronisations), recorded only while a torch profiler is open
  in the process (below).
* ``device_window(fn)``: a profiled run of ``fn`` that must hold device
  events: it raises when none came back, instead of returning an empty
  table (``DeviceWindow`` then reads kernels, device time, the host's
  runtime calls, and kernel records against kernel launch calls).

Why every window is checked. The profiler library (kineto) keeps a
device record only if its timestamp lies inside the window, and on the
card's machine the device timestamps do not always land there
(``scripts/profiler_window_probe.py``, H100 80GB HBM3 at 700 W; the
library's log says "Out-of-range = 1" for each window that lost its
kernel). In windows opened one after another, a kernel's recorded start
ranged from 3.18 ms before to 1.33 ms after its own launch call, and 13 of
1,160 one-launch windows without margins lost their kernel, none of 1,200
with 20 ms to 1 s of idle time at each end. But after other work on the
card outside any window, the first part of each window goes blind, a span
that grew to over a second within minutes of a process's life: 14 of 16
windows lost their kernel even with 1 s at each end (ROADMAP.md §3, F4,
open). So every window keeps ``PAD_S`` of idle time at each end,
``device_window`` raises when a window holds no device event, and
``device_ms`` averages over the kernels recorded.

Spans. Tracing is on exactly while a ``torch.profiler`` window is open in
the process, whichever thread opened it (``torch.autograd.profiler.
_is_profiler_enabled``, a module flag; the thread-local
``torch._C._autograd._profiler_enabled()`` reads False on other threads);
with torch not imported it is off. Off, ``span`` costs one flag read and
returns a shared no-op context. On, each span records its name, start and
end (Unix ns, the time base of the profiler's own events:
``KinetoEvent.start_ns()``), its thread, its id, its parent (the innermost
span open on the same thread) and its counts, and opens a host range of
its name (as ``record_function`` does, but without the range's copy on the
device timeline), so a profiler that records that thread shows it on the
trace's timeline (``torch.profiler`` records the host events of the thread
that opened it only). A wait that starts on one thread and ends on
another is recorded by ``interval`` with explicit ids.
This module imports torch only inside functions: the daemon's front end
(``server.py``) loads no torch at import.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = ["StepTimer", "trace", "device_window", "DeviceWindow",
           "EmptyDeviceWindow", "PAD_S", "tracing", "span", "count",
           "interval", "spans", "dropped", "reset", "counting_syncs",
           "MAX_SPANS"]

# idle host time at each end of a profiler window (see above)
PAD_S = 0.05
# spans kept in memory; past it ``dropped()`` counts the spans not kept
MAX_SPANS = 1 << 18
# the warning of ``torch.cuda.set_sync_debug_mode("warn")``
_SYNC_WARNING = "called a synchronizing CUDA operation"


class StepTimer:
    """Accumulates wall-clock per phase: use as
    ``with timer.phase("data"): ...`` and read ``timer.summary()``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def log(self, prefix: str = "") -> None:
        if not self.totals:
            return
        total = sum(self.totals.values())
        parts = " | ".join(
            f"{k}: {v:.2f}s ({v / max(total, 1e-9):.0%}, "
            f"{v / max(self.counts[k], 1) * 1000:.1f} ms/it)"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        )
        logging.info(f"{prefix}step-time breakdown: {parts}")


def _activities(cuda: Optional[bool] = None):
    import torch
    from torch.profiler import ProfilerActivity

    if cuda is None:
        cuda = torch.cuda.is_available()
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the wrapped region written to
    ``log_dir``; a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import profile, tensorboard_trace_handler

    prof = profile(activities=_activities(),
                   on_trace_ready=tensorboard_trace_handler(str(log_dir)))
    prof.start()
    time.sleep(PAD_S)
    logging.info(f"torch profiler trace -> {log_dir}")
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(PAD_S)
        prof.stop()


class EmptyDeviceWindow(RuntimeError):
    """A profiled window that ran device work came back without a device
    event."""


class DeviceWindow:
    """What one ``device_window`` recorded, per call of its function."""

    def __init__(self, prof, iters: int):
        import torch

        self.iters = iters
        self.events = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        self.device = [e for e in self.events if e.device_type == cuda]
        host = [e for e in self.events if e.device_type != cuda]
        # the kernels: not copies or fills, and not a host annotation's
        # range mirrored on the device (``Optimizer.step#Adam.step``);
        # kernel names may hold "#" themselves (``{lambda()#1}``)
        host_keys = {e.key for e in host}
        self.kernel_events = [
            e for e in self.device if e.key not in host_keys
            and not e.key.startswith(("Memcpy", "Memset"))]
        # kernel launches the host made (runtime or driver API) and the
        # kernel records that came back
        self.launch_calls = sum(
            e.count for e in host
            if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
        self.kernel_records = sum(e.count for e in self.kernel_events)

    @staticmethod
    def _device_us(e) -> float:
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def kernels(self) -> Dict[str, int]:
        """Device event name -> count per call (kernels and copies)."""
        return {e.key: e.count / self.iters for e in self.device}

    def device_ms(self, name: str) -> float:
        """Mean device ms of one recorded event whose name contains
        ``name`` (per call for a kernel launched once a call; a record the
        profiler dropped does not bias it); raises if there is none."""
        hits = [e for e in self.device if name in e.key]
        if not hits:
            raise EmptyDeviceWindow(
                f"no device event named like {name!r} in the window; it "
                f"holds {sorted(e.key for e in self.device)[:8]}")
        return (sum(self._device_us(e) for e in hits) / 1e3
                / sum(e.count for e in hits))

    def host_counts(self, names: Iterable[str]) -> Dict[str, float]:
        """Count per call of each host event named exactly ``name`` (the
        CUDA runtime's calls, ``cudaStreamSynchronize`` ..., and ops)."""
        from torch.autograd import DeviceType

        by = {e.key: e.count for e in self.events
              if e.device_type != DeviceType.CUDA}
        return {n: by.get(n, 0) / self.iters for n in names}

    def device_counts(self, prefix: str) -> float:
        """Count per call of the device events whose name starts with
        ``prefix`` (``Memcpy DtoH`` ...)."""
        return sum(e.count for e in self.device
                   if e.key.startswith(prefix)) / self.iters


def device_window(fn: Callable[[], object], iters: int = 1,
                  warmup: int = 1, cuda: Optional[bool] = None
                  ) -> DeviceWindow:
    """``iters`` calls of ``fn`` (after ``warmup`` unprofiled ones) in one
    ``torch.profiler`` window with ``PAD_S`` of idle time at each end, the
    card synchronised before it closes. Raises ``EmptyDeviceWindow`` when
    the window holds no device event: ``fn`` is meant to run device work,
    so an empty table is a fault of the measurement, never a result.
    ``launch_calls`` and ``kernel_records`` say whether records went
    missing. ``cuda=False`` (or no card) asks for CPU activity only."""
    import torch
    from torch.profiler import profile

    acts = _activities(cuda)
    on_card = len(acts) > 1
    for _ in range(warmup):
        fn()
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(PAD_S)
        for _ in range(iters):
            fn()
        if on_card:
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    window = DeviceWindow(prof, iters)
    if not window.device:
        raise EmptyDeviceWindow(
            f"the profiler window of {iters} call(s) holds no device event "
            f"(activities {[a.name for a in acts]}; on the card the profiler "
            f"can drop a window's records: ROADMAP.md section 3, F4)")
    return window


# -- spans and counters (see the module's docstring) --------------------------

def tracing() -> bool:
    """True while a torch profiler is open in this process."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Recorder:
    """The process's finished spans, at most ``MAX_SPANS`` of them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.kept: List["_Span"] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> List["_Span"]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, s: "_Span") -> None:
        with self.lock:
            if len(self.kept) < MAX_SPANS:
                self.kept.append(s)
            else:
                self.dropped += 1


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "id", "parent", "ids", "counts", "sites", "thread",
                 "start_ns", "end_ns", "_range")

    def __init__(self, name: str, ids: Dict[str, Any],
                 parent: Optional[int] = None):
        self.name, self.ids, self.parent = name, ids, parent
        self.id = next(_REC.ids)
        self.counts: Dict[str, int] = {}
        self.sites: List[str] = []
        self.thread = threading.current_thread().name
        self.start_ns = self.end_ns = 0
        self._range = None

    def __enter__(self) -> "_Span":
        from torch._C._profiler import _RecordFunctionFast

        stack = _REC.stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        # stamped outside the range: the span holds its range's event,
        # whose first call in a process takes a millisecond or more
        self.start_ns = time.time_ns()
        # a function-scope range: ``record_function`` opens a user-scope
        # one, which the CUDA profiler also mirrors onto the device's
        # timeline over the range's kernels, where a reader of device
        # intervals counts it as device work (a traced train micro-step's
        # mirror read as 13.7 s of "device time" in a 30-s window)
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(None, None, None)
        self.end_ns = time.time_ns()
        self._range = None
        _REC.stack().pop()
        _REC.add(self)

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "ids": dict(self.ids),
                "counts": dict(self.counts), "sites": list(self.sites)}


def span(name: str, **ids):
    """``with span(name, **ids) as s:`` records the block as a span while
    tracing (``s`` is the span, ``s.id`` its id); otherwise a no-op
    context whose ``s`` is None."""
    if not tracing():
        return _OFF
    return _Span(name, ids)


def count(name: str, n: int = 1, site: Optional[str] = None) -> None:
    """Add ``n`` to the count ``name`` of the innermost span open on this
    thread (and ``site``, a call site, to its ``sites``); nothing without
    one."""
    stack = getattr(_REC.local, "stack", None)
    if stack:
        s = stack[-1]
        s.counts[name] = s.counts.get(name, 0) + n
        if site is not None:
            s.sites.append(site)


def interval(name: str, start_ns: int, end_ns: int,
             parent: Optional[int] = None, **ids) -> None:
    """Record a span measured elsewhere (a wait that starts on one thread
    and ends on another), while tracing. It opens no host range: a range
    is entered and left on one thread."""
    if tracing():
        s = _Span(name, ids, parent)
        s.start_ns, s.end_ns = int(start_ns), int(end_ns)
        _REC.add(s)


def spans() -> List[Dict[str, Any]]:
    """Every span recorded (since ``reset``), as dicts: name, id, parent,
    thread, start_ns, end_ns, ids, counts, sites."""
    with _REC.lock:
        kept = list(_REC.kept)
    return [s.as_dict() for s in kept]


def dropped() -> int:
    """Spans not kept: recorded past ``MAX_SPANS``."""
    return _REC.dropped


def reset() -> None:
    """Forget every span recorded and the dropped count."""
    with _REC.lock:
        _REC.kept.clear()
        _REC.dropped = 0


def _call_site() -> str:
    """The innermost frame outside torch, ``warnings`` and this module."""
    import torch

    skip = (os.path.dirname(torch.__file__) + os.sep, warnings.__file__,
            __file__)
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.startswith(skip):
        f = f.f_back
    if f is None:
        return "?"
    path = f.f_code.co_filename
    short = os.sep.join(path.split(os.sep)[-2:])
    return f"{short}:{f.f_lineno} ({f.f_code.co_name})"


@contextlib.contextmanager
def _syncs_counted():
    import torch

    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            count("syncs", 1, _call_site())
        else:
            shown(message, category, filename, lineno, file, line)

    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(before)


def counting_syncs(device):
    """While tracing, and ``device`` is a card: the block runs under
    ``torch.cuda.set_sync_debug_mode("warn")``, and each host
    synchronisation it makes (on any thread: the mode and the warning
    filters are the process's) adds 1 to the count ``syncs`` of the
    innermost span open on the thread that is warned, with its call site;
    the mode is set back afterwards. Otherwise a no-op context."""
    if not tracing() or device.type != "cuda":
        return _OFF
    return _syncs_counted()
