"""Where the device time of the port's flagship forward goes, on one GPU.

    python scripts/torch_port_profile.py [--batch 128] [--dtype bfloat16]

Builds the flagship Video ProtoASNet (``ours_protoasnet_video.yml``, full
width, seeded random weights) on the card, runs a few warm forwards under
``torch.profiler`` and prints the card's name and power limit, the wall
time per forward, the device-busy share (summed kernel time over wall
time) and the kernels by device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from protoasnet_tpu_torch.models.builder import build_model  # noqa: E402
from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda  # noqa
from protoasnet_tpu_torch.utils.config import load_config  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = load_config(str(REPO / "protoasnet_tpu" / "configs"
                          / "ours_protoasnet_video.yml"))
    model = build_model(dict(cfg["model"], dtype=a.dtype), seed=0)
    x = torch.randn((a.batch, 32, 112, 112, 3), device="cuda")
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        roi_cosine_cuda.launches = 0
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            for _ in range(a.iters):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / a.iters
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memsets, copies): an aten op's own
    # row repeats the time of the kernels it launched
    kernels = sorted((e for e in events if dev_us(e) > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / a.iters
    print(card)
    print(f"flagship forward {a.dtype} batch {a.batch}: wall {wall_ms:.2f} "
          f"ms/forward under the profiler, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), roi_cosine_cuda launches "
          f"{roi_cosine_cuda.launches} in {a.iters} forwards")
    for e in kernels[:20]:
        ms = dev_us(e) / 1e3 / a.iters
        print(f"  {ms:9.3f} ms/fwd {100 * ms / busy_ms:5.1f}%  x"
              f"{e.count // a.iters:<4d} {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
