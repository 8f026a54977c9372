"""The Video Swin trunk's window attention on the card: the fused kernel
against its bound, the plain route and the library's fused attention, at
the three stage shapes of 32x112x112 clips, then the served Swin model.

    python -m protoasnet_tpu_torch.experiments.window_attn [--batch 128]
        [--rounds 3] [--model_batch 128] [--device cuda|cpu]

First ptxas' registers, shared memory and spills of each instantiation of
``csrc/window_attn.cu`` (where this process built it).

Per stage (tokens, width, heads of ``STAGES``; window 8x7x7), unshifted
and shifted, a bf16 ``qkv`` volume of ``--batch`` clips and an N(0, 1)
bias table, each route timed with CUDA events, the routes in turn in each
of ``--rounds`` rounds:
- ``kernel``: ``ops/window_attn_cuda.py`` (the roll and the window
  partition folded into its addressing), the wrapper call; ``device``:
  the kernel alone on the device (profiler);
- ``plain``: ``ops/window_attn.py::window_attention_torch`` under bf16
  autocast, as training runs it;
- ``library``: the roll and partition as torch copies, then
  ``F.scaled_dot_product_attention`` with the bias (and the shifted
  windows' mask) as one (1, windows·heads, N, N) bf16 tensor broadcast
  over the batch, then the merge and roll back (a yardstick only: the
  port never calls it);
- ``copies``: the roll and partition of ``qkv`` and the merge and roll of
  the output alone, what folding them into the kernel's addressing saves;
- ``bound``: q, k, v read and o written once (bf16) and the table once,
  over 3.35 TB/s, against 4·N²·d FLOP a (window, head) over 989 TFLOP/s.
The kernel is held against the float64 plain route in fp32 first. Then
the served Swin-B model (``build_model``, bf16, uint8-gray wire) at
``--model_batch`` clips: ms a batch through the kernel and through the
plain route (``window_attention`` replaced by it for the timing), peak
memory, and the top device ops of one forward (profiler). One JSON line a
measurement. ``--device cpu`` runs the routes' arithmetic at a small
size only.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
from typing import Dict, List

import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.experiments.common import (bound_ms, card_line,
                                                     max_rel_err, no_tf32,
                                                     time_ms)
from protoasnet_tpu_torch.ops import window_attn
from protoasnet_tpu_torch.utils.device import resolve_device
from protoasnet_tpu_torch.utils.profiling import device_window

__all__ = ["main", "STAGES", "WINDOW", "library_route", "copies"]

# 32x112x112 clips through Swin-B's patch (2, 4, 4): (tokens, width, heads,
# shift of the odd blocks)
STAGES = {1: ((16, 28, 28), 128, 4, (4, 3, 3)),
          2: ((16, 14, 14), 256, 8, (4, 3, 3)),
          3: ((16, 7, 7), 512, 16, (4, 0, 0))}
WINDOW = (8, 7, 7)


def _bias_and_mask(table, index, heads, size, window, shift, dtype):
    n = math.prod(window)
    bias = table[index[:n, :n].reshape(-1)].reshape(n, n, heads).permute(
        2, 0, 1)
    nw = math.prod(s // w for s, w in zip(size, window))
    full = bias[None].expand(nw, heads, n, n)
    if any(shift):
        full = full + window_attn.shift_mask(size, window, shift,
                                             table.device)[:, None]
    return full.reshape(1, nw * heads, n, n).to(dtype).contiguous()


def library_route(qkv, attn_bias, heads, window, shift):
    """Roll, partition, SDPA with the broadcast bias, merge, roll back."""
    b, t, h, w, c3 = qkv.shape
    c = c3 // 3
    if any(shift):
        qkv = torch.roll(qkv, [-s for s in shift], dims=(1, 2, 3))
    x = window_attn._partition(qkv, window)
    bw, n = x.shape[:2]
    nw = bw // b
    x = x.reshape(b, nw, n, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5)
    q, k, v = (x[i].reshape(b, nw * heads, n, c // heads) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_bias)
    o = o.reshape(b, nw, heads, n, c // heads).permute(0, 1, 3, 2, 4)
    o = window_attn._merge(o.reshape(bw, n, c), b, (t, h, w), window)
    return torch.roll(o, list(shift), dims=(1, 2, 3)) if any(shift) else o


def copies(qkv, out, window, shift):
    """The torch copies the kernel's addressing replaces."""
    b, t, h, w, _ = qkv.shape
    x = torch.roll(qkv, [-s for s in shift], dims=(1, 2, 3)) \
        if any(shift) else qkv
    window_attn._partition(x, window).contiguous()
    o = window_attn._merge(window_attn._partition(out, window), b, (t, h, w),
                           window)
    if any(shift):
        torch.roll(o, list(shift), dims=(1, 2, 3))


def _stage(stage: int, batch: int, shifted: bool, rounds: int,
           dev: torch.device) -> Dict:
    from protoasnet_tpu_torch.ops.window_attn_cuda import window_attn_cuda

    size, c, heads, shift = STAGES[stage]
    shift = shift if shifted else (0, 0, 0)
    g = torch.Generator(device=dev).manual_seed(stage)
    qkv32 = torch.randn((2, *size, 3 * c), generator=g, device=dev)
    table = torch.randn((15 * 13 * 13, heads), generator=g, device=dev)
    index = window_attn.relative_position_index(WINDOW, dev)
    with no_tf32():  # the kernel's fp32 path against the plain route
        err = max_rel_err(
            window_attn_cuda(qkv32, table, index, heads, WINDOW, shift,
                             WINDOW),
            window_attn.window_attention_torch(qkv32.double(),
                                               table.double(), index, heads,
                                               WINDOW, shift))[1]
    qkv = torch.randn((batch, *size, 3 * c), generator=g, device=dev,
                      dtype=torch.bfloat16)
    out = torch.empty((batch, *size, c), device=dev, dtype=torch.bfloat16)
    attn_bias = _bias_and_mask(table, index, heads, size, WINDOW, shift,
                               torch.bfloat16)

    def plain():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            window_attn.window_attention_torch(qkv, table, index, heads,
                                               WINDOW, shift)

    def kernel():
        window_attn_cuda(qkv, table, index, heads, WINDOW, shift, WINDOW)

    routes = {"kernel": kernel, "plain": plain,
              "library": lambda: library_route(qkv, attn_bias, heads,
                                               WINDOW, shift),
              "copies": lambda: copies(qkv, out, WINDOW, shift)}
    times: Dict[str, List[float]] = {k: [] for k in routes}
    for _ in range(rounds):
        for name, fn in routes.items():
            times[name].append(time_ms(fn, target_ms=300.0, max_iters=50))
    device = device_window(kernel, iters=20).device_ms("window_attn_kernel")
    n = math.prod(WINDOW)
    d = c // heads
    pairs = batch * math.prod(s // w for s, w in zip(size, WINDOW)) * heads
    bound, by = bound_ms(pairs * 4 * n * d * 2 + table.numel() * 4,
                         pairs * 4 * n * n * d, torch.bfloat16)
    lib_err = max_rel_err(
        library_route(qkv[:2], attn_bias, heads, WINDOW, shift),
        window_attn.window_attention_torch(qkv[:2].double(), table.double(),
                                           index, heads, WINDOW, shift))[1]
    return {"stage": stage, "shifted": shifted, "batch": batch,
            "fp32_kernel_err": err, "library_bf16_err": lib_err,
            "bound_ms": bound, "bound_by": by, "device_ms": device,
            **{f"{k}_ms": statistics.median(v) for k, v in times.items()},
            **{f"{k}_ms_rounds": v for k, v in times.items()}}


def _model(batch: int, dev: torch.device) -> List[Dict]:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from protoasnet_tpu_torch.models.backbones import swin3d
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import _device_forward

    cfg = {"name": "Video_XProtoNet", "base_architecture": "swin3d_b",
           "backbone_last_layer_num": -3,
           "prototype_shape": "(40, 256, 1, 1, 1)", "num_classes": 4,
           "dtype": "bfloat16"}
    model = build_model(cfg, device=dev)
    forward = _device_forward(model, uint8_gray=True)
    fused = swin3d.window_attention

    def plain(qkv, table, index, heads, window, shift, table_window):
        return window_attn.window_attention_torch(qkv, table, index, heads,
                                                  window, shift)

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(batch, 32, 112, 112), dtype=np.uint8)).to(dev)
    out = []
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        for route in ("kernel", "plain", "kernel", "plain"):
            swin3d.window_attention = fused if route == "kernel" else plain
            try:
                ms = time_ms(lambda: forward(x), target_ms=1000.0,
                             max_iters=20)
            finally:
                swin3d.window_attention = fused
            out.append({"model": "swin3d_b", "route": route, "batch": batch,
                        "ms": ms})
        out.append({"peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        forward(x)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward(x)
            torch.cuda.synchronize(dev)
    dev_ops = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t:
            dev_ops[e.key] = t / 1e3
    total = sum(v for k, v in dev_ops.items() if not k.startswith("aten::")
                and not k.startswith("autograd"))
    kernels = sorted(((k, v) for k, v in dev_ops.items()
                      if not k.startswith("aten::")), key=lambda kv: -kv[1])
    out.append({"top_device_ops_ms": [[k[:90], v] for k, v in kernels[:25]],
                "device_ms": total})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.experiments.window_attn")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--model_batch", type=int, default=128)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type != "cuda":
        for stage, (size, c, heads, shift) in STAGES.items():
            small = (8, 7, 7) if stage < 3 else size[:1] + (7, 7)
            qkv = torch.randn((1, *small, 3 * 32 * 2))
            table = torch.randn((15 * 13 * 13, 2))
            index = window_attn.relative_position_index(WINDOW)
            o = window_attn.window_attention_torch(qkv, table, index, 2,
                                                   (8, 7, 7), (0, 0, 0))
            lib = library_route(qkv, _bias_and_mask(
                table, index, 2, small, WINDOW, (0, 0, 0), torch.float32),
                2, WINDOW, (0, 0, 0))
            print(json.dumps({"stage": stage, "device": "cpu",
                              "library_vs_plain": max_rel_err(lib, o)[1]}))
        return 0
    print(json.dumps({"card": card_line(), "torch": torch.__version__}),
          flush=True)
    from protoasnet_tpu_torch.ops import cuda_build, window_attn_cuda

    window_attn_cuda._lib()
    print(json.dumps({"ptxas": cuda_build.build_logs.get("window_attn.cu",
                                                         "(built before)")}),
          flush=True)
    for stage in STAGES:
        for shifted in (False, True):
            print(json.dumps(_stage(stage, a.batch, shifted, a.rounds, dev)),
                  flush=True)
    if a.model_batch:
        for line in _model(a.model_batch, dev):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
