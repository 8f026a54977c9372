"""Wrapper of the hand-written Hopper fused Conv2Plus1D kernel (forward).

``csrc/fused_c2p1d.cu`` replaces the Pallas TPU kernel
``experiments/pallas_fused_c2p1d.py::fused_c2p1d``; its header says what
bounds it and how it keeps the mid activation in shared memory. The source
is compiled for ``sm_90a`` at first use (``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ops/fused_c2p1d.py::fused_c2p1d_torch``). It
counts its launches in ``fused_c2p1d_cuda.launches``. x is fp32 or bf16
and the output takes its dtype; the taps and the affine are cast to fp32
(exact for bf16 taps), as the plain version computes with them. Forward
only: an input that requires grad is refused.
"""

from __future__ import annotations

import ctypes

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.fused_c2p1d import fused_c2p1d_torch

__all__ = ["fused_c2p1d_cuda", "tile_positions", "SOURCE", "REPLACES"]

SOURCE = "protoasnet_tpu_torch/csrc/fused_c2p1d.cu"
REPLACES = "experiments/pallas_fused_c2p1d.py:129"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    lib = load_library("fused_c2p1d.cu")
    fn = lib.fused_c2p1d_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.fused_c2p1d_positions.argtypes = [i, i]
        lib.fused_c2p1d_positions.restype = ctypes.c_int
        lib.fused_c2p1d_error_string.argtypes = [ctypes.c_int]
        lib.fused_c2p1d_error_string.restype = ctypes.c_char_p
    return lib


def tile_positions(dtype: torch.dtype, cm: int) -> int:
    """Positions per block the kernel takes for ``cm`` mid channels in
    ``dtype`` (64, 32 or 16; 0 if the mid ring does not fit)."""
    return _lib().fused_c2p1d_positions(int(dtype == torch.bfloat16), cm)


def fused_c2p1d_cuda(x: torch.Tensor, ks: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, W, C) fp32 or bf16, ks (3, 3, C, Cm), scale/shift (Cm,),
    kt (3, Cm, Co) -> (B, T, H, W, Co) in x's dtype."""
    if x.device.type == "cpu":
        return fused_c2p1d_torch(x, ks, scale, shift, kt)
    if x.device.type != "cuda":
        raise ValueError(f"fused_c2p1d_cuda: unsupported device {x.device}")
    args = (("x", x), ("ks", ks), ("scale", scale), ("shift", shift),
            ("kt", kt))
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in args):
        raise RuntimeError(
            "fused_c2p1d_cuda is forward-only: an input requires grad. Run "
            "under torch.no_grad()/inference_mode()")
    for name, t in args:
        if t.device != x.device:
            raise ValueError(f"fused_c2p1d_cuda: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"fused_c2p1d_cuda: {name} is {t.dtype}; the "
                            f"kernel takes float32 or bfloat16 (float64 runs "
                            f"through fused_c2p1d_torch)")
    if x.dim() != 5 or ks.dim() != 4 or kt.dim() != 3:
        raise ValueError(f"fused_c2p1d_cuda: x {tuple(x.shape)}, ks "
                         f"{tuple(ks.shape)}, kt {tuple(kt.shape)} must be "
                         f"(B, T, H, W, C), (3, 3, C, Cm), (3, Cm, Co)")
    b, t, h, w, c = x.shape
    cm, co = kt.shape[1], kt.shape[2]
    if tuple(ks.shape) != (3, 3, c, cm) or kt.shape[0] != 3 \
            or tuple(scale.shape) != (cm,) or tuple(shift.shape) != (cm,):
        raise ValueError(f"fused_c2p1d_cuda: shapes x {tuple(x.shape)}, ks "
                         f"{tuple(ks.shape)}, scale {tuple(scale.shape)}, "
                         f"shift {tuple(shift.shape)}, kt {tuple(kt.shape)} "
                         f"do not agree")
    if b > _MAX_GRID_Y or max(t, h * w, c, cm, co) > _INT_MAX:
        raise ValueError(f"fused_c2p1d_cuda: (B, T, H, W, C, Cm, Co) = "
                         f"{(b, t, h, w, c, cm, co)} exceeds the kernel's "
                         f"grid; split the batch")
    out = torch.empty((b, t, h, w, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if cm == 0:  # no mid channels: the temporal sums are empty
        return out.zero_()
    if tile_positions(x.dtype, cm) == 0:
        raise ValueError(f"fused_c2p1d_cuda: Cm={cm} mid channels in "
                         f"{x.dtype} do not fit the kernel's shared-memory "
                         f"ring")
    x2 = x.detach().contiguous()
    ks2, scale2, shift2, kt2 = (a.detach().to(torch.float32).contiguous()
                                for a in (ks, scale, shift, kt))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_c2p1d_forward(
            x2.data_ptr(), int(x.dtype == torch.bfloat16), ks2.data_ptr(),
            scale2.data_ptr(), shift2.data_ptr(), kt2.data_ptr(),
            out.data_ptr(), b, t, h, w, c, cm, co, stream)
    if err != 0:
        raise RuntimeError("fused_c2p1d_cuda launch failed: "
                           + lib.fused_c2p1d_error_string(err).decode())
    fused_c2p1d_cuda.launches += 1
    return out


fused_c2p1d_cuda.launches = 0
