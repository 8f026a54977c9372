"""Tracing and profiling (the JAX package's ``utils/profiling.py`` on
``torch.profiler``).

* ``StepTimer``: per-epoch wall-clock breakdown of data wait, step
  dispatch and host-metric time, logged at the epoch's end (always on).
* ``trace(log_dir)``: a ``torch.profiler`` window (CPU, and CUDA when the
  card is there) around the wrapped region, written to ``log_dir`` by
  ``tensorboard_trace_handler`` (a ``*.pt.trace.json`` TensorBoard's
  profiler plugin loads); the agents open it at ``profile_epoch`` of a
  training epoch when ``profile_dir`` or ``PROTOASNET_PROFILE_DIR`` is set.
* ``annotate(name)``: ``torch.profiler.record_function``, a named region
  inside an active trace.
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
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, Iterable, Optional

import torch

__all__ = ["StepTimer", "trace", "annotate", "device_window", "DeviceWindow",
           "EmptyDeviceWindow", "PAD_S"]

# idle host time at each end of a profiler window (see above)
PAD_S = 0.05


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


def annotate(name: str):
    """Named region inside an active trace."""
    return torch.profiler.record_function(name)


class EmptyDeviceWindow(RuntimeError):
    """A profiled window that ran device work came back without a device
    event."""


class DeviceWindow:
    """What one ``device_window`` recorded, per call of its function."""

    def __init__(self, prof, iters: int):
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
        by = {e.key: e.count for e in self.events
              if e.device_type != torch.autograd.DeviceType.CUDA}
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
