"""Why does a short ``torch.profiler`` window on the card sometimes hold no
device event at all?

Each worker process (a fresh CUDA context and a fresh profiler) profiles
one call of the L2 + min kernel (``ops/l2_min_cuda.py``, launched through
ctypes from its own library) many times, in four kinds of window, rotated
round by round:

- ``bare``: the call and ``torch.cuda.synchronize()``, as the card tests'
  ``_device_kernels`` did;
- ``torch_op``: a torch kernel (``add_``) launched just before the call;
- ``padded``: the bare window with 20 ms of host sleep before the call and
  after the synchronisation; ``padded50``: with 50 ms;
- ``ten``: ten calls in one window;
- ``wide``: the bare window with 1 s of host sleep at each end (it keeps a
  kernel whose recorded time is off by up to a second);
- ``primed50``: a throwaway window (CPU and CUDA activity, no work) just
  before a ``padded50`` one;
- ``many``: 200 small torch kernels (``add_``) before the call in a
  ``padded50`` window, to compare kernel records with launch calls;
- ``step``: two bf16 train micro-steps of the full-width flagship at
  batch 5 (``chip_smoke.py`` phase 7's profile) after 20 unprofiled ones,
  in a ``padded50`` window;
- ``long``: 30 calls 100 ms apart in one window (a 3-s window), so that
  the kernels kept show how far their recorded times moved;
- ``spin50``: the ``padded50`` window with its 50 ms margins spent
  busy-waiting on the host instead of sleeping;
- ``warm300``: 10 small torch kernels 30 ms apart in the window before
  the call; ``spaced5``: 5 calls 100 ms apart.

``--gap S`` keeps the card busy with matmuls for S seconds, outside any
window, before each window (as other work runs between the profiled
calls of a test file).

For every window it records the device events that reached
``prof.profiler.kineto_results.events()``, their start and end against
the host's clock (``time.time_ns()`` read just before the first launch
and just after the synchronisation), and the trace's own start. The
worker's standard error (the profiler library's own log at its most
verbose level, ``KINETO_LOG_LEVEL=0``, with a marker line before and after
each window) is kept, and the lines that speak of the profiling window,
dropped records or CUPTI's buffers are counted.

Run on one card: ``python scripts/profiler_window_probe.py [--procs 4]
[--rounds 40] [--variants bare,padded50,...] [--gap 5]``. It prints one JSON summary per worker and one for all,
and writes the raw records to ``chiprun_out/profiler_window_probe.json``
and each worker's log to ``chiprun_out/profiler_window_probe_<i>.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
VARIANTS = ("bare", "torch_op", "padded", "ten")
PAD_S = {"padded": 0.02, "padded50": 0.05, "primed50": 0.05, "wide": 1.0,
         "many": 0.05, "step": 0.05, "spin50": 0.05}
# words of the profiler library's log lines about lost or clipped records
_WORDS = ("outside", "window", "drop", "overflow", "buffer", "cupti",
          "CUPTI")


def _spin(seconds: float) -> None:
    """Wait on the host without sleeping."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def _window(index, variant, fn, side):
    import torch
    from torch.profiler import ProfilerActivity, profile

    if variant == "primed50":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    # a marker in the profiler library's log, which shares standard error
    sys.stderr.write(f"PROBE window {index} {variant} begin\n")
    sys.stderr.flush()
    pad = _spin if variant == "spin50" else time.sleep
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad(PAD_S.get(variant, 0.0))
        if variant == "torch_op":
            side.add_(1.0)
        for _ in range(200 if variant == "many" else 0):
            side.add_(1.0)
        for _ in range(10 if variant == "warm300" else 0):
            side.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.03)
        t_launch = time.time_ns()
        calls = {"ten": 10, "step": 2, "long": 30, "spaced5": 5}.get(
            variant, 1)
        for _ in range(calls):
            (side if variant == "step" else fn)()
            if variant in ("long", "spaced5"):
                torch.cuda.synchronize()
                time.sleep(0.1)
        torch.cuda.synchronize()
        t_sync = time.time_ns()
        pad(PAD_S.get(variant, 0.0))
    sys.stderr.write(f"PROBE window {index} {variant} end\n")
    sys.stderr.flush()
    res = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.name(), e.start_ns(), e.end_ns()) for e in res.events()
           if e.device_type() == cuda]
    host = [(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
            for e in res.events() if e.device_type() != cuda]
    averaged = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
    return {"variant": variant, "t_launch": t_launch, "t_sync": t_sync,
            "trace_start": res.trace_start_ns(),
            "device": dev, "host": host, "averaged": averaged}


def _flagship_step(dev):
    """Phase 7's bf16 train micro-step at batch 5 (the config's terms)."""
    import torch

    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
    from protoasnet_tpu_torch.utils.config import load_config

    cfg = load_config(str(REPO / "protoasnet_tpu" / "configs"
                          / "ours_protoasnet_video.yml"))
    model = build_model(cfg["model"], device=dev, seed=0)
    opt = GroupAdam(model, {g: 1e-3 for g in GROUPS})
    step = make_xprotonet_steps(
        model, LossBundle(cfg["train"]["criterion"], num_classes=4,
                          abstain_class=True),
        opt, GradAccumulator(opt.params, 2))[0]
    x = torch.randn((5, 32, 112, 112, 3), device=dev)
    target = torch.tensor([0, 1, 2, 0, 1], device=dev)
    valid = torch.ones(5, dtype=torch.bool, device=dev)
    gen = torch.Generator().manual_seed(8)
    return lambda: step(x, target, valid, {g: 1e-4 for g in GROUPS},
                        generator=gen)


def _busy(seconds: float, a) -> None:
    import torch

    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def worker(rounds: int, variants, gap: float) -> None:
    import torch

    sys.path.insert(0, str(REPO))
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((8, 49, 512), generator=g).to(dev)
    w = torch.randn((30, 512), generator=g).to(dev)
    side = torch.zeros(1024, device=dev)
    fn = lambda: l2_min_cuda(x, w)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    step = _flagship_step(dev) if "step" in variants else None
    out = []
    a = torch.randn(2048, 2048, device=dev)
    k = len(variants)
    for r in range(rounds):
        for v in variants[r % k:] + variants[:r % k]:
            _busy(gap, a)
            if v == "step":
                for _ in range(20):
                    step()
                torch.cuda.synchronize()
            out.append(_window(len(out), v, fn, step if v == "step"
                               else side))
    print(json.dumps(out))


def _summary(records):
    by = {}
    for rec in records:
        s = by.setdefault(rec["variant"], {
            "windows": 0, "empty": 0, "kernel_missing": 0,
            "torch_kernel_missing": 0, "kernels_seen": 0,
            "kernels_expected": 0, "start_minus_launch_us": [],
            "end_minus_sync_us": []})
        s["windows"] += 1
        names = [d[0] for d in rec["device"]]
        s["kernel_records"] = s.get("kernel_records", 0) + len(names)
        s["launch_calls"] = s.get("launch_calls", 0) + sum(
            1 for h in rec["host"] if h[0].startswith(("cudaLaunchKernel",
                                                       "cuLaunchKernel")))
        l2 = [d for d in rec["device"] if "l2_min" in d[0]]
        want = 10 if rec["variant"] == "ten" else 1
        s["out_of_range"] = s.get("out_of_range", 0) + rec.get(
            "out_of_range", 0)
        s["kernels_expected"] += want
        s["kernels_seen"] += len(l2)
        s["empty"] += not names
        s["kernel_missing"] += not l2
        if rec["variant"] == "torch_op":
            s["torch_kernel_missing"] += not any("l2_min" not in n
                                                for n in names)
        for _, st, en in l2:
            s["start_minus_launch_us"].append((st - rec["t_launch"]) / 1e3)
            s["end_minus_sync_us"].append((en - rec["t_sync"]) / 1e3)
    for s in by.values():
        for k in ("start_minus_launch_us", "end_minus_sync_us"):
            v = sorted(s[k])
            s[k] = ({"min": v[0], "median": v[len(v) // 2], "max": v[-1]}
                    if v else None)
    return by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated window kinds, rotated per round")
    ap.add_argument("--gap", type=float, default=0.0,
                    help="seconds of matmuls on the card before each window")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    variants = tuple(args.variants.split(","))
    if args.worker:
        worker(args.rounds, variants, args.gap)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profiler_window_probe: no CUDA device", file=sys.stderr)
        return 2
    all_records, workers = [], []
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    for i in range(args.procs):
        # the profiler library's most verbose log: its record counts per
        # window (out of range, stopped early, ...)
        env = dict(os.environ, KINETO_LOG_LEVEL="0")
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", "--rounds",
             str(args.rounds), "--variants", args.variants, "--gap",
             str(args.gap)],
            capture_output=True, text=True, env=env, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        records = json.loads(proc.stdout.strip().splitlines()[-1])
        (out / f"profiler_window_probe_{i}.log").write_text(proc.stderr)
        # the library's record counts of each window, between its markers
        for rec, part in zip(records, re.split(r"PROBE window \d+ \w+ begin",
                                               proc.stderr)[1:]):
            m = re.search(r"Out-of-range = (\d+)", part)
            rec["out_of_range"] = int(m[1]) if m else -1
            m = re.search(r"Processed (\d+) GPU records", part)
            rec["gpu_records"] = int(m[1]) if m else -1
        lines = proc.stderr.splitlines()
        flagged = [ln for ln in lines if any(w in ln for w in _WORDS)]
        info = {"worker": i, "kineto_log_level": env.get("KINETO_LOG_LEVEL"),
                "stderr_lines": len(lines), "flagged_lines": len(flagged),
                "flagged_sample": flagged[:12],
                "summary": _summary(records)}
        print(json.dumps(info), flush=True)
        workers.append(info)
        all_records.extend(records)
    (out / "profiler_window_probe.json").write_text(json.dumps(
        {"workers": workers, "records": all_records}))
    print(json.dumps({"all": _summary(all_records)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
