"""Wrapper of the hand-written Hopper fused Conv2Plus1D kernel (forward).

``csrc/fused_c2p1d.cu`` replaces the Pallas TPU kernel
``experiments/pallas_fused_c2p1d.py::fused_c2p1d``; its header says what
bounds it and how it keeps the mid activation in shared memory. The source
is compiled for ``sm_90a`` at first use (``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ops/fused_c2p1d.py::fused_c2p1d_torch``). It
counts its launches in ``fused_c2p1d_cuda.launches``. x is fp32 or bf16
and the output takes its dtype. Each call prepares the taps for the tensor
cores (inside the call, so a timing of the call covers it): for fp32 x the
TF32 hi/lo split of both tap arrays (``split_tf32``), for bf16 x the taps in
bf16 and, where an fp32 tap array is not exactly bf16, its bf16 k_lo
(``split_bf16``: a second product). ``tiling`` chooses the spatial tile and
the split of the mid channels across blocks. Forward only: an input that
requires grad is refused.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.fused_c2p1d import fused_c2p1d_torch
from protoasnet_tpu_torch.ops.temporal_conv import split_bf16, split_tf32

__all__ = ["fused_c2p1d_cuda", "tiling", "device_tiling", "smem_bytes",
           "staging_aligned", "Tiling", "SOURCE", "REPLACES"]

SOURCE = "protoasnet_tpu_torch/csrc/fused_c2p1d.cu"
REPLACES = "experiments/pallas_fused_c2p1d.py:129"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1
POSITIONS = 64  # positions per block (TH * TW <= 64)
H100_SMS = 132
H100_SMEM = 232448  # shared memory a block may opt into on an H100


class Tiling(NamedTuple):
    th: int      # tile rows
    tw: int      # tile columns
    tiles: int   # tiles per frame
    slice: int   # mid channels per block (a multiple of 16, or >= Cm)
    splits: int  # S = ceil(Cm / slice) blocks across the mid channels
    blocks: int  # tiles * S * B
    smem: int    # dynamic shared memory per block, bytes


def smem_bytes(elem: int, two_arrays: bool, th: int, tw: int,
               slice_: int) -> int:
    """The kernel's shared memory (``Layout::bytes`` in the source) for x of
    ``elem`` bytes with one tap array or two: three items of the cp.async
    ring (halo tile of a channel chunk, twice for fp32, + its taps) and
    three mid frames."""
    two = two_arrays or elem == 4
    ck = 8 if elem == 4 else (16 if two else 32)  # x channels per item
    pad = 16 // elem
    halos = 2 if elem == 4 else 1  # fp32: the halo's TF32 hi and lo
    stage = (th + 2) * (tw + 2) * (ck + pad) * halos \
        + 9 * ck * 72 * (2 if two else 1)
    ring = POSITIONS * (-(-slice_ // 16) * 16 + pad)
    return (3 * stage + 3 * ring) * elem


def tiling(b: int, h: int, w: int, cm: int, elem: int, two_arrays: bool,
           sms: int = H100_SMS, smem_max: int = H100_SMEM) -> Tiling:
    """The kernel's blocks for B samples of H x W with Cm mid channels: the
    TH x TW <= 64 tile with the fewest tiles per frame (then the smallest
    halo), and the fewest splits S of Cm (slices of a multiple of 16) that
    give at least ``sms`` blocks and fit ``smem_max``."""
    tiles, _, th, tw = min(
        ((-(-h // min(h, POSITIONS // tw))) * (-(-w // tw)),
         (min(h, POSITIONS // tw) + 2) * (tw + 2), min(h, POSITIONS // tw),
         tw) for tw in range(1, min(w, POSITIONS) + 1))
    fit = 16
    while smem_bytes(elem, two_arrays, th, tw, fit + 16) <= smem_max \
            and fit < cm:
        fit += 16
    if smem_bytes(elem, two_arrays, th, tw, fit) > smem_max:
        raise ValueError(f"fused_c2p1d: a {th}x{tw} tile does not fit "
                         f"{smem_max} bytes of shared memory")
    splits = min(max(-(-sms // (tiles * b)), -(-cm // fit)), -(-cm // 16))
    slice_ = min(-(-(-(-cm // splits)) // 16) * 16, cm)
    splits = -(-cm // slice_)
    return Tiling(th, tw, tiles, slice_, splits, tiles * splits * b,
                  smem_bytes(elem, two_arrays, th, tw, slice_))


def staging_aligned(elem: int, *rows_and_ptrs: int) -> bool:
    """Whether the kernel can stage through 16-byte ``cp.async``: every row
    length (C, Cm, Co elements of ``elem`` bytes) and every pointer given is
    a multiple of 16 bytes."""
    return all(v * elem % 16 == 0 for v in rows_and_ptrs[:3]) \
        and all(p % 16 == 0 for p in rows_and_ptrs[3:])


def _lib() -> ctypes.CDLL:
    lib = load_library("fused_c2p1d.cu")
    fn = lib.fused_c2p1d_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i,
                       i, i, i, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.fused_c2p1d_smem_bytes.argtypes = [i, i, i, i, i]
        lib.fused_c2p1d_smem_bytes.restype = ctypes.c_int64
        lib.fused_c2p1d_error_string.argtypes = [ctypes.c_int]
        lib.fused_c2p1d_error_string.restype = ctypes.c_char_p
    return lib


def device_tiling(x: torch.Tensor, cm: int, two_arrays: bool) -> Tiling:
    """``tiling`` for x (B, T, H, W, C) on its card (its SM count and the
    shared memory a block may opt into; an H100's for a CPU tensor)."""
    sms, smem = H100_SMS, H100_SMEM
    if x.device.type == "cuda":
        props = torch.cuda.get_device_properties(x.device)
        sms = props.multi_processor_count
        smem = getattr(props, "shared_memory_per_block_optin", H100_SMEM)
    return tiling(x.shape[0], x.shape[2], x.shape[3], cm, x.element_size(),
                  two_arrays, sms, smem)


def _taps(ks: torch.Tensor, kt: torch.Tensor, dtype: torch.dtype):
    """(ks, ks_lo, kt, kt_lo) in x's dtype as the kernel's products take
    them; the lo arrays None for bf16 x with bf16 taps (one product)."""
    ks, kt = ks.detach().contiguous(), kt.detach().contiguous()
    if dtype == torch.float32:
        return (*split_tf32(ks), *split_tf32(kt))
    if ks.dtype == kt.dtype == torch.bfloat16:
        return ks, None, kt, None
    (ks_hi, ks_lo), (kt_hi, kt_lo) = split_bf16(ks), split_bf16(kt)
    if not bool(ks_lo.any() or kt_lo.any()):  # every tap is a bf16
        return ks_hi, None, kt_hi, None
    return ks_hi, ks_lo, kt_hi, kt_lo


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
    if b > _MAX_GRID_YZ or -(-cm // 16) > _MAX_GRID_YZ \
            or max(t, h * w, c, cm, co) > _INT_MAX:
        raise ValueError(f"fused_c2p1d_cuda: (B, T, H, W, C, Cm, Co) = "
                         f"{(b, t, h, w, c, cm, co)} exceeds the kernel's "
                         f"grid; split the batch")
    out = torch.empty((b, t, h, w, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if cm == 0:  # no mid channels: the temporal sums are empty
        return out.zero_()
    x2 = x.detach().contiguous()
    ks_hi, ks_lo, kt_hi, kt_lo = _taps(ks, kt, x.dtype)
    scale2, shift2 = (a.detach().to(torch.float32).contiguous()
                      for a in (scale, shift))
    tl = device_tiling(x2, cm, ks_lo is not None)
    part = (torch.empty((tl.splits, *out.shape), dtype=torch.float32,
                        device=x.device) if tl.splits > 1 else None)
    ptrs = [a.data_ptr() for a in (x2, ks_hi, ks_lo, kt_hi, kt_lo)
            if a is not None]
    aligned = staging_aligned(x.element_size(), c, cm, co, *ptrs)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_c2p1d_forward(
            x2.data_ptr(), int(x.dtype == torch.bfloat16), ks_hi.data_ptr(),
            None if ks_lo is None else ks_lo.data_ptr(), scale2.data_ptr(),
            shift2.data_ptr(), kt_hi.data_ptr(),
            None if kt_lo is None else kt_lo.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), int(aligned), b, t, h,
            w, c, cm, co, tl.th, tl.tw, tl.slice, stream)
    if err != 0:
        raise RuntimeError("fused_c2p1d_cuda launch failed: "
                           + lib.fused_c2p1d_error_string(err).decode())
    fused_c2p1d_cuda.launches += 1
    return out


fused_c2p1d_cuda.launches = 0
