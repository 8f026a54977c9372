"""The port's profiling helpers (``utils/profiling.py``) on the CPU.

- ``StepTimer`` as ``tests/test_misc_utils.py`` holds the JAX package's,
  and the same totals and counts as the JAX one for the same phases.
- ``trace(None)`` is a no-op; ``trace(dir)`` writes one trace file that
  loads as JSON (the agent's window: ``tests/test_torch_port_device_metrics.py``).
- ``device_window`` raises ``EmptyDeviceWindow`` on a window without a
  device event: here a window with no CUDA activity requested, the case
  that stands for the card's empty traces (ROADMAP §3, F4); ``span``
  names a region of an active window.
"""

import json
import time

import pytest
import torch

from protoasnet_tpu.utils.profiling import StepTimer as JaxStepTimer
from protoasnet_tpu_torch.utils.profiling import (PAD_S, DeviceWindow,
                                                  EmptyDeviceWindow,
                                                  StepTimer, device_window,
                                                  span, trace)


def test_step_timer():
    t = StepTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    s = t.summary()
    assert s["a"] >= 0.01 and t.counts["a"] == 2 and "b" in s
    t.log("test ")  # must not raise


def test_step_timer_counts_as_the_jax_one():
    timers = (StepTimer(), JaxStepTimer())
    for t in timers:
        for name in ("data", "step", "data", "host_metrics", "data"):
            with t.phase(name):
                pass
    assert timers[0].counts == timers[1].counts == {
        "data": 3, "step": 1, "host_metrics": 1}
    assert set(timers[0].summary()) == set(timers[1].summary())


def test_trace_noop_without_dir(tmp_path):
    with trace(None):
        pass
    with trace(""):
        pass
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_one_loadable_file(tmp_path):
    t0 = time.perf_counter()
    with trace(str(tmp_path)):
        with span("the_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert time.perf_counter() - t0 >= 2 * PAD_S  # the window's margins
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "the_region" in names and "aten::mm" in names


def test_device_window_raises_on_a_window_without_device_events():
    with pytest.raises(EmptyDeviceWindow, match="no device event"):
        device_window(lambda: torch.ones(8) * 2, iters=3, cuda=False)


def test_device_window_counts_per_call():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            torch.ones(8).add_(1)
    window = DeviceWindow(prof, iters=4)
    assert window.device == [] and window.kernel_records == 0
    assert window.host_counts(["aten::add_", "aten::nope"]) == {
        "aten::add_": 1.0, "aten::nope": 0.0}
    with pytest.raises(EmptyDeviceWindow, match="no device event named"):
        window.device_ms("some_kernel")
