"""Where the device time of a port model's forward goes, on one GPU.

    python scripts/torch_port_profile.py [--config PATH] [--batch 128]
        [--dtype bfloat16|float32]

Builds the model of ``--config`` (default: the video flagship
``ours_protoasnet_video.yml``; also ``baseline_protopnet.yml`` and
``ours_protoasnet_image.yml``) at full width with seeded random weights on
the card, runs a few warm forwards under ``torch.profiler`` and prints the
card's name and power limit, the wall time per forward, the device-busy
share (summed kernel time over wall time), the hand-written kernels'
launches and the kernels by device time. ``--dtype`` defaults to the
config's own. Imports nothing of JAX.
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

from protoasnet_tpu_torch.models.builder import (build_model,  # noqa: E402
                                                 example_input)
from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda  # noqa: E402
from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda  # noqa
from protoasnet_tpu_torch.utils.config import load_config  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=str(
        REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = load_config(a.config)
    mcfg = dict(cfg["model"])
    if a.dtype:
        mcfg["dtype"] = a.dtype
    dtype = mcfg.get("dtype", "float32")
    model = build_model(mcfg, seed=0)
    x = torch.randn_like(example_input(mcfg, cfg["data"], a.batch))
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        roi_cosine_cuda.launches = l2_min_cuda.launches = 0
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
    print(f"{Path(a.config).name} forward {dtype} batch {a.batch} "
          f"(input {tuple(x.shape)}): wall {wall_ms:.2f} ms/forward under "
          f"the profiler, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), roi_cosine_cuda launches "
          f"{roi_cosine_cuda.launches}, l2_min_cuda launches "
          f"{l2_min_cuda.launches} in {a.iters} forwards")
    for e in kernels[:20]:
        ms = dev_us(e) / 1e3 / a.iters
        print(f"  {ms:9.3f} ms/fwd {100 * ms / busy_ms:5.1f}%  x"
              f"{e.count // a.iters:<4d} {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
