"""Wrapper of the hand-written Hopper temporal-convolution kernel (forward).

``csrc/temporal_conv.cu`` replaces the Pallas TPU kernels
``experiments/pallas_temporal.py::temporal_conv_pallas`` (and its ``_v2``
and ``_v3`` tilings of the same function); its header says what bounds it
and how it is laid out. The source is compiled for ``sm_90a`` at first use
(``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ops/temporal_conv.py::temporal_conv_torch``).
It counts its launches in ``temporal_conv_cuda.launches``. x is fp32 or
bf16 and the output takes its dtype. With fp32 x the kernel multiplies
through 3xTF32 and takes the taps as ``split_tf32``'s hi and lo. With bf16 x
the taps go to the kernel's bf16 products as ``split_bf16``'s k_hi and, for
an fp32 k whose k_lo is not all zero, k_lo too (a second product). The
kernel keeps the taps in shared memory where they fit (``taps_resident``),
and stages through ``cp.async`` when ``staging_aligned`` holds, else element
by element. Forward only: an input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import math

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.temporal_conv import (split_bf16, split_tf32,
                                                    temporal_conv_torch)

__all__ = ["temporal_conv_cuda", "staging_aligned", "tile_rows",
           "taps_resident", "SOURCE", "REPLACES"]

SOURCE = "protoasnet_tpu_torch/csrc/temporal_conv.cu"
REPLACES = "experiments/pallas_temporal.py:66"
_DTYPES = (torch.float32, torch.bfloat16)
_MIN_ROWS = 32  # the kernel's smallest tile of positions
_MAX_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    lib = load_library("temporal_conv.cu")
    fn = lib.temporal_conv_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.temporal_conv_tile_rows.argtypes = [i, i, i]
        lib.temporal_conv_tile_rows.restype = ctypes.c_int
        lib.temporal_conv_taps_resident.argtypes = [i, i, i, i, i, i]
        lib.temporal_conv_taps_resident.restype = ctypes.c_int
        lib.temporal_conv_error_string.argtypes = [ctypes.c_int]
        lib.temporal_conv_error_string.restype = ctypes.c_char_p
    return lib


def staging_aligned(c: int, o: int, elem: int, *ptrs: int) -> bool:
    """Whether the kernel can stage through 16-byte ``cp.async``: rows of C
    and of O elements of ``elem`` bytes are 16-byte multiples and every
    pointer in ``ptrs`` (x and the tap arrays) starts on a 16-byte
    boundary."""
    return (c * elem) % 16 == 0 and (o * elem) % 16 == 0 \
        and all(p % 16 == 0 for p in ptrs)


def tile_rows(b: int, s: int, o: int) -> int:
    """Positions per block the kernel takes for B samples of S positions
    and O outputs on the current device (64, or 32 when 64 would leave SMs
    without a block)."""
    return _lib().temporal_conv_tile_rows(b, s, o)


def taps_resident(dtype: torch.dtype, two_arrays: bool, b: int, s: int,
                  c: int, o: int) -> bool:
    """Whether the kernel keeps the taps in shared memory and stages x a
    frame at a time (else it stages x and the taps in channel chunks), for
    x in ``dtype`` with one tap array or two (fp32 x always has two)."""
    return bool(_lib().temporal_conv_taps_resident(
        int(dtype == torch.bfloat16), int(two_arrays), b, s, c, o))


def temporal_conv_cuda(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, T, ..., C) fp32 or bf16, k (3, C, O) -> (B, T, ..., O) in x's
    dtype."""
    if x.device.type == "cpu":
        return temporal_conv_torch(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"temporal_conv_cuda: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad):
        raise RuntimeError(
            "temporal_conv_cuda is forward-only: an input requires grad. Run "
            "under torch.no_grad()/inference_mode()")
    if k.device != x.device:
        raise ValueError(f"temporal_conv_cuda: k on {k.device}, x on "
                         f"{x.device}")
    if x.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise TypeError(f"temporal_conv_cuda: x {x.dtype}, k {k.dtype}; the "
                        f"kernel takes float32 or bfloat16 (float64 runs "
                        f"through temporal_conv_torch)")
    if x.dim() < 3 or k.dim() != 3 or k.shape[0] != 3 \
            or k.shape[1] != x.shape[-1]:
        raise ValueError(f"temporal_conv_cuda: x {tuple(x.shape)} must be "
                         f"(B, T, ..., C) and k {tuple(k.shape)} (3, C, O) "
                         f"with the same C")
    b, t, c, o = x.shape[0], x.shape[1], x.shape[-1], k.shape[2]
    s = math.prod(x.shape[2:-1])  # positions (explicit: B may be 0)
    if b > _MAX_GRID_YZ or -(-s // _MIN_ROWS) > _MAX_GRID_YZ \
            or max(t, s, c, o, t * -(-c // 16)) > _INT_MAX:
        raise ValueError(f"temporal_conv_cuda: (B, T, S, C, O) = "
                         f"{(b, t, s, c, o)} exceeds the kernel's grid; "
                         f"split the batch")
    y = torch.empty((b, t, s, o), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.reshape(*x.shape[:-1], o)
    if c == 0:  # no input channels: the sums are empty
        return y.zero_().reshape(*x.shape[:-1], o)
    x2 = x.detach().reshape(b, t, s, c).contiguous()
    kd = k.detach().contiguous()
    if x.dtype == torch.float32:
        k_hi, k_lo = split_tf32(kd)
    elif k.dtype == torch.bfloat16:
        k_hi, k_lo = kd, None
    else:
        k_hi, k_lo = split_bf16(kd)
        if not bool(k_lo.any()):  # every tap is a bf16: one product
            k_lo = None
    ptrs = [x2.data_ptr(), k_hi.data_ptr()]
    if k_lo is not None:
        ptrs.append(k_lo.data_ptr())
    aligned = staging_aligned(c, o, x.element_size(), *ptrs)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.temporal_conv_forward(
            x2.data_ptr(), int(x.dtype == torch.bfloat16), k_hi.data_ptr(),
            None if k_lo is None else k_lo.data_ptr(), y.data_ptr(),
            int(aligned), b, t, s, c, o, stream)
    if err != 0:
        raise RuntimeError("temporal_conv_cuda launch failed: "
                           + lib.temporal_conv_error_string(err).decode())
    temporal_conv_cuda.launches += 1
    return y.reshape(*x.shape[:-1], o)


temporal_conv_cuda.launches = 0
