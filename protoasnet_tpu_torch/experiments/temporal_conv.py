"""The (3,1,1) temporal convolution on the card: hand-written kernel vs its
plain version vs cuDNN, at the flagship trunk's stride-1 temporal-conv
shapes.

    python -m protoasnet_tpu_torch.experiments.temporal_conv [--bf16]
        [--shape stem|layer1|layer2|layer3] [--device cuda|cpu]

The port's counterpart of ``experiments/pallas_temporal.py``: x (B, T, S,
C) and k (3, C, O) from a seeded numpy generator, fp32 unless ``--bf16``,
B=8 (``BATCH``) at one of the trunk's shapes (``SHAPES``; default
``layer1``): ``stem`` T=32, 56x56, 45 -> 64; ``layer1``, ``layer2`` and
``layer3`` the Cm -> Co temporal conv of the blocks in
``experiments/fused_c2p1d.py::BLOCKS`` (T=32, 56x56, 144 -> 64; T=16,
28x28, 288 -> 128; T=8, 14x14, 576 -> 256). The kernel
(``ops/temporal_conv_cuda.py``) is held against the plain version: fp32
against float64 within 1e-5 of the largest output, bf16 against the plain
version on the same bf16 inputs (fp32 sums, one bf16 rounding) within 1e-2;
past that it raises. Then kernel, plain version and ``F.conv3d`` on a
``channels_last_3d`` view (TF32 off) are timed with CUDA events and printed
with TFLOP/s beside the H100's bound. FLOPs count the taps that land
inside the clip, 2*B*S*C*O*(3T-2): the zero frames at t=-1 and t=T need
no multiply. ``--device cpu`` runs the plain version only, at the shape's
widths on a small clip (B=2, T=min(T, 4), 4x4), against ``F.conv3d`` in
float64.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.experiments.common import (BATCH, TOL, bound_ms,
                                                     max_rel_err, no_tf32,
                                                     time_ms)
from protoasnet_tpu_torch.experiments.fused_c2p1d import BLOCKS
from protoasnet_tpu_torch.ops.temporal_conv import temporal_conv_torch
from protoasnet_tpu_torch.ops.temporal_conv_cuda import (taps_resident,
                                                         temporal_conv_cuda,
                                                         tile_rows)
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["main", "conv3d_reference", "flops", "nbytes", "dims", "SHAPES",
           "SMALL"]

# the trunk's stride-1 (3,1,1) convs at 32x112x112 clips: (t, h, w, c, o);
# the stem's 45 -> 64, and each block's mid -> out
SHAPES = {"stem": (32, 56, 56, 45, 64),
          **{name: (t, h, w, cm, co)
             for name, (t, h, w, _, cm, co) in BLOCKS.items()}}
SMALL = (2, 4, 4, 4)  # (b, t, h, w) on the CPU; t at most the shape's T


def dims(shape: str, device_type: str) -> Tuple[int, ...]:
    """(b, t, h, w, c, o) of ``shape``: batch ``BATCH`` on the card, the
    small clip at the same widths on the CPU."""
    t, h, w, c, o = SHAPES[shape]
    if device_type == "cpu":
        b, t_small, h, w = SMALL
        return b, min(t, t_small), h, w, c, o
    return BATCH, t, h, w, c, o


def flops(b: int, t: int, s: int, c: int, o: int) -> int:
    """Multiply-adds x 2 of the taps inside [0, T): 3T - 2 per position."""
    return 2 * b * s * c * o * (3 * t - 2)


def nbytes(b: int, t: int, s: int, c: int, o: int, elem: int) -> int:
    """x and k read once and y written once, ``elem`` bytes each."""
    return (b * t * s * (c + o) + 3 * c * o) * elem


def conv3d_reference(x: torch.Tensor, k: torch.Tensor, h: int, w: int
                     ) -> torch.Tensor:
    """The library counterpart: ``F.conv3d`` of the (B, T, H*W, C) input
    as a ``channels_last_3d`` NCDHW view, output back as (B, T, S, O)."""
    b, t, s, c = x.shape
    x5 = x.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    w5 = k.to(x.dtype).permute(2, 1, 0).reshape(k.shape[2], c, 3, 1, 1)
    y = F.conv3d(x5, w5.contiguous(memory_format=torch.channels_last_3d),
                 padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1).reshape(b, t, s, -1)


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.experiments.temporal_conv",
        description="temporal conv kernel vs plain version vs cuDNN")
    p.add_argument("--bf16", action="store_true", help="bf16 (default fp32)")
    p.add_argument("--shape", choices=list(SHAPES), default="layer1",
                   help="the trunk's conv: (t, h, w, c, o) = " + "; ".join(
                       f"{k} {v}" for k, v in SHAPES.items()))
    p.add_argument("--device", default=None,
                   help=f"cuda (default) or cpu: the plain version only, at "
                        f"(b, t, h, w) = {SMALL} and the shape's widths")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = _parse(argv)
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    b, t, h, w, c, o = dims(args.shape, dev.type)
    s = h * w
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, t, s, c), np.float32))
    k = torch.from_numpy(rng.standard_normal((3, c, o), np.float32) * 0.05)
    x, k = x.to(dev, dtype), k.to(dev, dtype)
    nflop = flops(b, t, s, c, o)
    tol = TOL[dtype]
    res: Dict[str, Any] = {
        "name": "temporal_conv_cuda", "device": dev.type,
        "dtype": str(dtype).replace("torch.", ""), "shape_name": args.shape,
        "shape": dict(b=b, t=t, s=s, c=c, o=o), "gflop": nflop / 1e9,
        "tol": tol}
    print(f"device={dev.type} dtype={res['dtype']} shape={args.shape} "
          f"(B,T,S,C,O)={(b, t, s, c, o)}", flush=True)
    with no_tf32(), torch.inference_mode():
        y = temporal_conv_cuda(x, k)  # the kernel; plain on the CPU
        if dev.type == "cpu":
            ref = conv3d_reference(x.double(), k.double(), h, w)
        elif dtype == torch.float32:
            ref = temporal_conv_torch(x.double(), k.double())
        else:
            ref = temporal_conv_torch(x, k)
        err, rel = max_rel_err(y, ref)
        res.update(max_abs_err=err, rel_err=rel)
        print(f"max abs err {err:.4g} (rel {rel:.3e}, limit {tol:g})",
              flush=True)
        if not rel <= tol:
            raise AssertionError(f"temporal_conv {res['dtype']} "
                                 f"{args.shape}: rel err {rel:.3e} > {tol:g}")
        if dev.type == "cpu":
            return res
        lib_err, _ = max_rel_err(conv3d_reference(x, k, h, w), ref)
        ms = time_ms(lambda: temporal_conv_cuda(x, k))
        plain_ms = time_ms(lambda: temporal_conv_torch(x, k))
        library_ms = time_ms(lambda: conv3d_reference(x, k, h, w))
    bnd, by = bound_ms(nbytes(b, t, s, c, o, x.element_size()), nflop, dtype)
    res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bnd, bound_by=by, library_max_abs_err=lib_err,
               rows_per_block=tile_rows(b, s, o),
               taps_resident=taps_resident(dtype, dtype == torch.float32, b,
                                           s, c, o),
               kind=torch.cuda.get_device_name(dev))
    for name, t_ms in (("kernel", ms), ("plain", plain_ms),
                       ("cudnn conv3d", library_ms), ("bound", bnd)):
        print(f"{name:13s} fwd {t_ms:8.4f} ms ({nflop / t_ms / 1e9:7.1f} "
              f"TF/s)", flush=True)
    print(f"bound by {by}; {res['rows_per_block']} positions per block, "
          f"taps {'resident' if res['taps_resident'] else 'in chunks'}; "
          f"cudnn max abs err {lib_err:.4g}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
