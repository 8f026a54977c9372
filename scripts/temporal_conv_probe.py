"""Where the temporal-conv kernel's time goes, on the card: the kernel as
built against probe builds of the same source that change or drop parts of
the work (the outputs of those that drop work are wrong; they are only
timed).

    python scripts/temporal_conv_probe.py

- ``chunks_only``: never takes the resident kernel (taps kept in shared
  memory, x staged a frame at a time), always the ring of channel chunks;
- ``no_mma``: stages x and the taps and writes y, but runs no product;
- ``taps_once``: the chunk ring stages the taps only with the first frame's
  chunks, so their traffic from L2 for every later frame goes (the ring
  then reuses stale taps; on the cp.async path only, so not at the stem's
  C=45, and a no-op where the taps are resident);
- ``no_store``: computes everything but writes no y;
- ``x_only``: the last three together: the staging of x alone.

Each probe is ``protoasnet_tpu_torch/csrc/temporal_conv.cu`` with text
substitutions, built with the package's ``nvcc`` flags into
``protoasnet_tpu_torch/_build/probe/`` and called through the wrapper
``temporal_conv_cuda`` (so the taps are split and the staging path chosen as
in the port). Times are CUDA-event means at the four trunk shapes of
``protoasnet_tpu_torch/experiments/temporal_conv.py`` (B=8), fp32 and bf16,
printed one line per shape and dtype after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from protoasnet_tpu_torch.experiments.common import time_ms  # noqa: E402
from protoasnet_tpu_torch.experiments.temporal_conv import (  # noqa: E402
    SHAPES, dims)
from protoasnet_tpu_torch.ops import cuda_build  # noqa: E402
from protoasnet_tpu_torch.ops import temporal_conv_cuda as wrapper  # noqa: E402

# (text of the source, its replacement) for each part a probe changes
NO_MMA = ("    multiply<In, kLo,", "    if (T < 0) multiply<In, kLo,")
TAPS_ONCE = ("e0 < 3 * kBK * kKRow; e0 += kThreads",
             "e0 < (i < nck ? 3 * kBK * kKRow : 0); e0 += kThreads")
# (S < 0 never holds, but unlike T < 0 the compiler cannot drop the
# products whose sums it would store)
NO_STORE = ("store_frame<In>(acc[", "if (q.S < 0) store_frame<In>(acc[")
CHUNKS_ONLY = ("  if (temporal_conv_taps_resident(x_bf16, k_lo != nullptr, B, S, C, "
               "O))", "  if (false)")
PROBES = {"chunks_only": [CHUNKS_ONLY], "no_mma": [NO_MMA],
          "taps_once": [TAPS_ONCE],
          "no_store": [NO_STORE], "x_only": [NO_MMA, TAPS_ONCE, NO_STORE]}


def build(name: str) -> Path:
    src = (cuda_build.CSRC_DIR / "temporal_conv.cu").read_text()
    for old, new in PROBES[name]:
        if old not in src:
            raise RuntimeError(f"probe {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    return so


def bind(path) -> ctypes.CDLL:
    """Load a build with the wrapper's own argument types."""
    real = wrapper._lib()
    lib = ctypes.CDLL(str(path))
    for fn in ("temporal_conv_forward", "temporal_conv_tile_rows",
               "temporal_conv_error_string"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("temporal_conv_probe: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    real, own = wrapper._lib(), wrapper._lib
    with ThreadPoolExecutor(len(PROBES)) as ex:
        libs = {"kernel": real,
                **dict(zip(PROBES, map(bind, ex.map(build, PROBES))))}
    dev = torch.device("cuda")
    try:
        for shape in SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                b, t, h, w, c, o = dims(shape, "cuda")
                rng = np.random.default_rng(0)
                x = torch.from_numpy(rng.standard_normal(
                    (b, t, h * w, c), np.float32)).to(dev, dtype)
                k = torch.from_numpy(rng.standard_normal(
                    (3, c, o), np.float32) * 0.05).to(dev, dtype)
                times = []
                for name, lib in libs.items():
                    wrapper._lib = lambda lib=lib: lib
                    with torch.inference_mode():
                        ms = time_ms(lambda: wrapper.temporal_conv_cuda(x, k))
                    times.append(f"{name} {ms:.4f} ms")
                print(f"{shape} {str(dtype)[6:]}: " + ", ".join(times),
                      flush=True)
    finally:
        wrapper._lib = own


if __name__ == "__main__":
    main()
