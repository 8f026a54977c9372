"""Time the two head kernels of a checkout of this repository on the card,
so that two versions can be compared in one chip call.

    python scripts/head_kernels_ab.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``protoasnet_tpu_torch`` is imported and
built (default: this script's own repository), e.g. a ``git archive`` of
an earlier commit unpacked into ``_parent/``. Run parent, change, change,
parent in one call and take each version's faster run.

At the served head shapes of ``chip_smoke.py`` phase 2 (batch 128, inputs
drawn as there): ``roi_cosine_cuda`` at the video head (S=8*14*14, P=40,
D=256) and the image head (S=7*7, P=40, D=512) in fp32 and bf16, and
``l2_min_cuda`` at ProtoPNet's head (S=7*7, P=30, D=512, fp32). For each:
the kernel's device time (``torch.profiler``, kernels whose name contains
``roi_cosine_kernel`` or ``l2_min_kernel``), the wrapper call's time (CUDA
events over back-to-back calls) and the largest error of roi (relative to
max |roi|) or dist (absolute) against the checkout's own plain version in
float64. Prints the card's name and power limit, then one JSON line.
Uses nothing of the root beyond the two wrappers and their plain versions.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HEADS = {"video": (128, 8 * 14 * 14, 40, 256), "image": (128, 7 * 7, 40, 512),
         "ppnet": (128, 7 * 7, 30, 512)}


def events_ms(fn, iters: int = 200) -> float:
    """Mean time of ``fn()`` in ms from CUDA events over ``iters`` calls
    after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str, iters: int = 100):
    """Mean device time in ms of the kernels whose name contains ``name``
    per call, from ``torch.profiler``; None if it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if name in e.key and e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("head_kernels_ab: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(a.root).resolve()))
    from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
    from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    rows = []
    with torch.inference_mode():
        for head in ("video", "image"):
            n, s, p, d = HEADS[head]
            g = torch.Generator(device=dev).manual_seed(1)
            occ32 = torch.rand((n, s, p), device=dev, generator=g) * 0.05
            feat32 = torch.randn((n, s, d), device=dev, generator=g)
            protos = torch.rand((p, d), device=dev, generator=g)
            for dtype in (torch.float32, torch.bfloat16):
                occ, feat = occ32.to(dtype), feat32.to(dtype)
                roi, _ = roi_cosine_cuda(occ, feat, protos)
                ref, _ = roi_cosine_torch(occ.double(), feat.double(),
                                          protos.double())
                err = ((roi.double() - ref).abs().max()
                       / ref.abs().max()).item()
                def fn():
                    return roi_cosine_cuda(occ, feat, protos)
                rows.append(dict(kernel="roi_cosine_cuda", head=head,
                                 dtype=str(dtype)[6:],
                                 device_ms=device_ms(fn, "roi_cosine_kernel"),
                                 call_ms=events_ms(fn), rel_err=err))
                print(json.dumps(rows[-1]), flush=True)
        n, s, p, d = HEADS["ppnet"]
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.sigmoid(torch.randn((n, s, d), device=dev, generator=g))
        w = torch.rand((p, 1, 1, d), device=dev, generator=g)
        dist, _ = l2_min_cuda(x, w)
        ref, _ = l2_min_torch(x.double(), w.double())
        err = (dist.double() - ref).abs().max().item()
        def fn():
            return l2_min_cuda(x, w)
        rows.append(dict(kernel="l2_min_cuda", head="ppnet", dtype="float32",
                         device_ms=device_ms(fn, "l2_min_kernel"),
                         call_ms=events_ms(fn), abs_err=err))
        print(json.dumps(rows[-1]), flush=True)
    out = {"label": a.label or a.root, "card": card, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
