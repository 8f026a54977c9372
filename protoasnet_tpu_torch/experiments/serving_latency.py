"""Serving latency against batch size on the card, bf16 and w8a8 int8.

    python -m protoasnet_tpu_torch.experiments.serving_latency [--quick]
        [--batches 1 2 4 8 16 32 64 128] [--device cuda|cpu]

The port's counterpart of ``experiments/serving_latency.py``: ms per
forward of the video flagship (R(2+1)D-18 cut after layer3, 40x256
prototypes, 32x112x112 clips, bf16, seeded random weights) on a
device-resident batch at each of ``--batches``, and of its w8a8 model
(``quant.quantized_model``) with the activation scales calibrated once,
on 8 seeded clips, for every batch. Timed with CUDA events after warm-up
(``experiments/common.py::time_ms``; ``--quick`` fills about 200 ms a
point, else 1 s); the host -> device copy is not in it (the daemon's
function adds it: ``experiments/daemon_load.py``, ``bench.py``'s serving
keys). Prints one JSON object a batch on stdout, ``{"batch", "bf16_ms",
"int8_ms", "bf16_clips_per_sec", "int8_clips_per_sec"}``, and the card's
name and power limit on stderr; ``main(argv)`` returns the objects.
The flagship and its clip are ``bench.VIDEO`` and ``bench.CLIP`` (in
bf16), the int8 model ``bench.quantize``'s. ``--device cpu`` runs the
same on the CPU (host clock), at the sizes a test sets in those dicts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from protoasnet_tpu_torch.experiments.common import (card_line, time_ms,
                                                     wall_ms)
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["main", "CALIB_CLIPS"]

CALIB_CLIPS = 8  # one calibration batch, as the JAX script's


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.experiments.serving_latency",
        description="ms per flagship forward against batch, bf16 and int8")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[1, 2, 4, 8, 16, 32, 64, 128])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    from protoasnet_tpu_torch import bench
    from protoasnet_tpu_torch.models.builder import build_model

    args = _parse(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)}; card "
            f"{card_line()}")

        def ms(fn):
            return time_ms(fn, target_ms=200.0 if args.quick else 1000.0)
    else:
        log("device: cpu (host clock; no measure of the card)")
        ms = wall_ms
    clip = bench.CLIP
    model = build_model(dict(bench.VIDEO, dtype="bfloat16"), device=dev,
                        seed=0)
    rng = np.random.default_rng(0)
    calib = torch.from_numpy(rng.normal(size=(CALIB_CLIPS, *clip)).astype(
        np.float32)).to(dev)
    qmodel = bench.quantize(model, calib)  # once, for every batch
    del calib
    rows = []
    for b in args.batches:
        x = torch.from_numpy(rng.normal(size=(b, *clip)).astype(
            np.float32)).to(dev)
        with torch.inference_mode():
            ms_fp = ms(lambda: model(x))
            ms_q = ms(lambda: qmodel(x))
        row = {"batch": b, "bf16_ms": ms_fp, "int8_ms": ms_q,
               "bf16_clips_per_sec": b / ms_fp * 1e3,
               "int8_clips_per_sec": b / ms_q * 1e3}
        log(f"batch {b:>3}: bf16 {ms_fp:8.2f} ms "
            f"({row['bf16_clips_per_sec']:7.1f} clips/s) | int8 "
            f"{ms_q:8.2f} ms ({row['int8_clips_per_sec']:7.1f} clips/s, "
            f"{ms_fp / ms_q:.2f}x)")
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
