"""Where the fused Conv2Plus1D kernel's time goes, on the card: the kernel
as built against probe builds of the same source that drop parts of the
work (their outputs are wrong; they are only timed).

    python scripts/fused_c2p1d_probe.py

- ``no_taps``: stages the taps only for the first frame's items, so their
  stream from L2 for every later frame goes (the stages then hold stale
  taps);
- ``spatial_only``: runs no temporal product (its taps are still staged
  and out is still written);
- ``no_mma``: stages the halo and the taps and writes mid and out, but
  runs no product;
- ``no_fragments`` (bf16 only): runs every ``mma`` of the kernel, but on
  constant operand fragments instead of the ``ldmatrix`` loads from shared
  memory: against the kernel it shows what the fragment loads cost;
- ``no_store``: computes everything but writes no out (nor the parts);
- ``x_only``: ``no_taps``, ``no_mma`` and ``no_store`` together: the
  staging of the x halo and the item loop alone.

Each probe is ``protoasnet_tpu_torch/csrc/fused_c2p1d.cu`` with text
substitutions, built with the package's ``nvcc`` flags into
``protoasnet_tpu_torch/_build/probe/`` and called through the wrapper
``fused_c2p1d_cuda`` (so the taps are prepared and the tiling chosen as in
the port). Times are CUDA-event means at the three block shapes of
``protoasnet_tpu_torch/experiments/fused_c2p1d.py`` (B=8), bf16 and fp32,
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

from protoasnet_tpu_torch.experiments.common import (  # noqa: E402
    BATCH, time_ms)
from protoasnet_tpu_torch.experiments.fused_c2p1d import BLOCKS  # noqa: E402
from protoasnet_tpu_torch.ops import cuda_build  # noqa: E402
from protoasnet_tpu_torch.ops import fused_c2p1d_cuda as wrapper  # noqa: E402

# (text of the source, its replacement) for each part a probe changes
NO_TAPS = [("e < 9 * L::kCK * kGR;", "e < (c.f == 0 ? 9 * L::kCK * kGR : 0);"),
           ("e < 3 * L::kMK * kGR;", "e < (c.f <= 1 ? 3 * L::kMK * kGR : 0);")]
# (T < 0 never holds; the compiler cannot drop what it guards)
NO_TEMPORAL = [("mma_rows<In, kLo, false>(acc_t,",
                "if (p.T < 0) mma_rows<In, kLo, false>(acc_t,")]
NO_MMA = NO_TEMPORAL + [("mma_rows<In, kLo, kF32>(acc_s,",
                         "if (p.T < 0) mma_rows<In, kLo, kF32>(acc_s,")]
NO_STORE = [("if (cs.chunk == q.n_mk - 1) store_out",
             "if (cs.chunk == q.n_mk - 1 && p.H < 0) store_out")]
# every ldmatrix (both its forms) replaced by constant fragments, bf16
# pairs of 1.0, with its address arithmetic; the mma still run on them.
# fp32 reads its fragments with plain loads, so this probe is bf16 only.
NO_FRAGMENTS = [('asm volatile(\n      "ldmatrix.sync.aligned.m8n8.x4.',
                 'r[0] = r[1] = r[2] = r[3] = 0x3f803f80u;\n'
                 '  if (false) asm volatile(\n'
                 '      "ldmatrix.sync.aligned.m8n8.x4.')]
BF16_ONLY = ("no_fragments",)
PROBES = {"no_taps": NO_TAPS, "spatial_only": NO_TEMPORAL, "no_mma": NO_MMA,
          "no_fragments": NO_FRAGMENTS, "no_store": NO_STORE,
          "x_only": NO_TAPS + NO_MMA + NO_STORE}


def build(name: str) -> Path:
    src = (cuda_build.CSRC_DIR / "fused_c2p1d.cu").read_text()
    for old, new in PROBES[name]:
        if old not in src:
            raise RuntimeError(f"probe {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"fused_{name}.cu", out / f"fused_{name}.so"
    cu.write_text(src)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    return so


def bind(path) -> ctypes.CDLL:
    """Load a build with the wrapper's own argument types."""
    real = wrapper._lib()
    lib = ctypes.CDLL(str(path))
    for fn in ("fused_c2p1d_forward", "fused_c2p1d_smem_bytes",
               "fused_c2p1d_error_string"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("fused_c2p1d_probe: needs an NVIDIA GPU")
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
        for block, (t, h, w, c, cm, co) in BLOCKS.items():
            for dtype in (torch.bfloat16, torch.float32):
                rng = np.random.default_rng(0)
                x = rng.standard_normal((BATCH, t, h, w, c), np.float32)
                ks = rng.standard_normal((3, 3, c, cm), np.float32) * 0.05
                kt = rng.standard_normal((3, cm, co), np.float32) * 0.05
                x, ks, kt = (torch.from_numpy(a).to(dev, dtype)
                             for a in (x, ks, kt))
                scale = torch.ones(cm, device=dev)
                shift = torch.zeros(cm, device=dev)
                times = []
                for name, lib in libs.items():
                    if name in BF16_ONLY and dtype == torch.float32:
                        continue
                    wrapper._lib = lambda lib=lib: lib
                    with torch.inference_mode():
                        ms = time_ms(lambda: wrapper.fused_c2p1d_cuda(
                            x, ks, scale, shift, kt))
                    times.append(f"{name} {ms:.4f} ms")
                print(f"{block} {str(dtype)[6:]}: " + ", ".join(times),
                      flush=True)
    finally:
        wrapper._lib = own


if __name__ == "__main__":
    main()
