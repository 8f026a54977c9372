"""The fused eval-mode Conv2Plus1D block on the card: hand-written kernel
vs its plain version vs the unfused cuDNN sequence, at the flagship's
stride-1 block shapes.

    python -m protoasnet_tpu_torch.experiments.fused_c2p1d [--fp32]
        [--block layer1|layer2|layer3] [--device cuda|cpu]

The port's counterpart of ``experiments/pallas_fused_c2p1d.py``: x (B, T,
H, W, C), spatial taps ks (3, 3, C, Cm), the folded BatchNorm affine
scale/shift (Cm,) and temporal taps kt (3, Cm, Co) from a seeded numpy
generator, bf16 unless ``--fp32``, B=8 at layer1's block (T=32, 56x56,
64 -> 144 -> 64; ``--block layer2``: T=16, 28x28, 128 -> 288 -> 128;
``layer3``: T=8, 14x14, 256 -> 576 -> 256). The kernel
(``ops/fused_c2p1d_cuda.py``) is held against the plain version: fp32
against float64 within 1e-5 of the largest output, bf16 against the plain
version on the same bf16 inputs (fp32 sums, the same bf16 rounding of mid)
within 1e-2; past that it raises. Then kernel, plain version and the
unfused cuDNN sequence conv3d -> affine -> ReLU -> cast -> conv3d on
``channels_last_3d`` tensors (TF32 off) are timed with CUDA events and
printed with TFLOP/s beside the H100's bound, and the kernel's tiling
(``ops/fused_c2p1d_cuda.py::tiling``: positions per block, the split of the
mid channels across blocks, blocks). FLOPs count the taps that
land inside the clip, 2*B*T*C*Cm*(3H-2)*(3W-2) + 2*B*H*W*Cm*Co*(3T-2): the
SAME zero padding needs no multiply. ``--device cpu`` runs the plain
version only, at the JAX script's small size (B=2, T=6, 8x8, 16 -> 24 ->
16), against the unfused sequence in float64.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.experiments.common import (BATCH, TOL, bound_ms,
                                                     max_rel_err, no_tf32,
                                                     time_ms)
from protoasnet_tpu_torch.ops.fused_c2p1d import fused_c2p1d_torch
from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import (device_tiling,
                                                       fused_c2p1d_cuda)
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["main", "unfused_reference", "flops", "BLOCKS", "SMALL"]

# the flagship's stride-1 Conv2Plus1D blocks at 32x112x112 clips:
# (t, h, w, c, cm, co)
BLOCKS = {"layer1": (32, 56, 56, 64, 144, 64),
          "layer2": (16, 28, 28, 128, 288, 128),
          "layer3": (8, 14, 14, 256, 576, 256)}
SMALL = (2, 6, 8, 8, 16, 24, 16)  # (b, t, h, w, c, cm, co), as in JAX's

_CL3D = torch.channels_last_3d


def flops(b: int, t: int, h: int, w: int, c: int, cm: int, co: int) -> int:
    """Multiply-adds x 2 of the taps inside the clip: (3H-2)(3W-2) spatial
    taps per frame and 3T-2 temporal taps per position."""
    return (2 * b * t * c * cm * (3 * h - 2) * (3 * w - 2)
            + 2 * b * h * w * cm * co * (3 * t - 2))


def unfused_reference(ks: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, kt: torch.Tensor,
                      dtype: torch.dtype
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The library counterpart, as a function of x (B, T, H, W, C): cuDNN
    conv3d (1,3,3) -> affine -> ReLU -> cast to x's dtype -> conv3d
    (3,1,1), on ``channels_last_3d`` tensors; weights laid out once."""
    ws = ks.to(dtype).permute(3, 2, 0, 1).unsqueeze(2).contiguous(
        memory_format=_CL3D)  # (Cm, C, 1, 3, 3)
    wt = kt.to(dtype).permute(2, 1, 0)[..., None, None].contiguous(
        memory_format=_CL3D)  # (Co, Cm, 3, 1, 1)
    sc = scale.to(torch.promote_types(dtype, torch.float32)).view(
        1, -1, 1, 1, 1)
    sh = shift.to(sc.dtype).view(1, -1, 1, 1, 1)

    def run(x: torch.Tensor) -> torch.Tensor:
        mid = F.conv3d(x.permute(0, 4, 1, 2, 3), ws, padding=(0, 1, 1))
        mid = torch.relu(mid * sc + sh).to(x.dtype)
        return F.conv3d(mid, wt, padding=(1, 0, 0)).permute(0, 2, 3, 4, 1)

    return run


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.experiments.fused_c2p1d",
        description="fused Conv2Plus1D kernel vs plain version vs cuDNN")
    p.add_argument("--fp32", action="store_true", help="fp32 (default bf16)")
    p.add_argument("--block", choices=sorted(BLOCKS), default="layer1")
    p.add_argument("--device", default=None,
                   help=f"cuda (default) or cpu: the plain version only, at "
                        f"(b, t, h, w, c, cm, co) = {SMALL}")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = _parse(argv)
    dev = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if dev.type == "cpu":
        b, t, h, w, c, cm, co = SMALL
        block = "small"
    else:
        b, (t, h, w, c, cm, co), block = (BATCH, BLOCKS[args.block],
                                          args.block)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, h, w, c), np.float32)
    ks = rng.standard_normal((3, 3, c, cm), np.float32) * 0.05
    kt = rng.standard_normal((3, cm, co), np.float32) * 0.05
    scale = rng.uniform(0.5, 1.5, size=cm).astype(np.float32)
    shift = (rng.standard_normal(cm, np.float32) * 0.1).astype(np.float32)
    x, ks, kt = (torch.from_numpy(a).to(dev, dtype) for a in (x, ks, kt))
    scale, shift = (torch.from_numpy(a).to(dev) for a in (scale, shift))
    nflop = flops(b, t, h, w, c, cm, co)
    es = x.element_size()
    nbytes = (x.numel() + b * t * h * w * co + ks.numel() + kt.numel()) * es \
        + 2 * cm * 4
    tol = TOL[dtype]
    res: Dict[str, Any] = {
        "name": "fused_c2p1d_cuda", "device": dev.type, "block": block,
        "dtype": str(dtype).replace("torch.", ""),
        "shape": dict(b=b, t=t, h=h, w=w, c=c, cm=cm, co=co),
        "gflop": nflop / 1e9, "tol": tol}
    print(f"device={dev.type} dtype={res['dtype']} block={block} "
          f"(B,T,H,W,C,Cm,Co)={(b, t, h, w, c, cm, co)}", flush=True)
    args5 = (x, ks, scale, shift, kt)
    with no_tf32(), torch.inference_mode():
        out = fused_c2p1d_cuda(*args5)  # the kernel; plain on the CPU
        if dev.type == "cpu":
            ref = unfused_reference(*(a.double() for a in args5[1:]),
                                    torch.float64)(x.double())
        elif dtype == torch.float32:
            ref = fused_c2p1d_torch(*(a.double() for a in args5))
        else:
            ref = fused_c2p1d_torch(*args5)
        err, rel = max_rel_err(out, ref)
        res.update(max_abs_err=err, rel_err=rel)
        print(f"max abs err {err:.4g} (rel {rel:.3e}, limit {tol:g})",
              flush=True)
        if not rel <= tol:
            raise AssertionError(f"fused_c2p1d {res['dtype']} {block}: rel "
                                 f"err {rel:.3e} > {tol:g}")
        if dev.type == "cpu":
            return res
        library = unfused_reference(ks, scale, shift, kt, dtype)
        lib_err, _ = max_rel_err(library(x), ref)
        ms = time_ms(lambda: fused_c2p1d_cuda(*args5))
        plain_ms = time_ms(lambda: fused_c2p1d_torch(*args5))
        library_ms = time_ms(lambda: library(x))
    bnd, by = bound_ms(nbytes, nflop, dtype)
    tl = device_tiling(x, cm, dtype == torch.float32)
    res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bnd, bound_by=by, library_max_abs_err=lib_err,
               tile=(tl.th, tl.tw), splits=tl.splits, mid_per_block=tl.slice,
               blocks=tl.blocks, kind=torch.cuda.get_device_name(dev))
    for name, t_ms in (("kernel", ms), ("plain", plain_ms),
                       ("cudnn 2-conv", library_ms), ("bound", bnd)):
        print(f"{name:13s} fwd {t_ms:8.4f} ms ({nflop / t_ms / 1e9:7.1f} "
              f"TF/s)", flush=True)
    print(f"bound by {by}; {tl.th}x{tl.tw} positions per block, Cm in "
          f"{tl.splits} slice(s) of {tl.slice}, {tl.blocks} blocks; cudnn "
          f"sequence max abs err {lib_err:.4g}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
