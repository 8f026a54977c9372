"""Timing, bounds, tolerances, precision settings and the card's name
shared by the experiment scripts, the bench, ``chip_smoke.py`` and the
card tests."""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Iterator, Tuple

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOP_PER_S", "BATCH", "TOL", "bound_ms",
           "time_ms", "wall_ms", "no_tf32", "max_rel_err", "card_line"]

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s for the input dtype at fp32 accuracy: bf16 on the tensor cores (a
# bf16 product with fp32 sums is exact); fp32 also on the tensor cores, as
# 3xTF32 (hi*hi + hi*lo + lo*hi of each operand split into two TF32s keeps
# fp32 accuracy, where one TF32 product would round the inputs), at a third
# of the 495 TFLOP/s TF32 rate: above the 67 TFLOP/s of the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}

BATCH = 8  # clips per run at the flagship's shapes, as in the JAX scripts

# the R(2+1)D kernels' limits, of max |reference|. fp32 kernel vs float64:
# fp32 sums of up to 2304 terms in another order, ~1e-6. bf16 kernel vs the
# plain version on the same bf16 inputs (fp32 sums, the same bf16
# roundings): one bf16 step (2^-8) of an element at most, plus a flipped mid
# rounding carried through the temporal sum
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype
             ) -> Tuple[float, str]:
    """Least time on an H100 for moving ``nbytes`` and doing ``flops``:
    (ms, "bytes" or "operations"), the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn: Callable[[], object], target_ms: float = 200.0,
            max_iters: int = 100) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events over enough
    back-to-back calls to fill about ``target_ms`` (at least 3), after one
    warm-up call and one estimating call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, target_ms / est)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn: Callable[[], object], iters: int = 2) -> float:
    """Mean host time of ``fn()`` in ms over ``iters`` calls after one
    warm-up call: the CPU's stand-in for ``time_ms`` (``--device cpu``)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """fp32 convolutions and products at full fp32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def max_rel_err(out: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(max abs error, that over max |ref|), in float64."""
    err = (out.double() - ref.double()).abs().max().item()
    return err, err / max(ref.double().abs().max().item(), 1e-30)
