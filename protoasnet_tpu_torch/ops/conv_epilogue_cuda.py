"""The served R(2+1)D trunk's conv epilogue, ``relu(x + b[c] (+ r))`` on a
conv output (N, C, ...) with a per-channel fp32 bias ``b`` and an optional
residual ``r``: the hand-written Hopper kernel, its plain route and the
routing by device.

``csrc/conv_epilogue.cu`` replaces no TPU kernel (the JAX package leaves
BatchNorm, the residual add and the ReLU to XLA); its header says what
bounds it and how it is laid out. The source is compiled for ``sm_90a`` at
first use (``ops/cuda_build.py``); a shape needs no plan and no build of
its own.

``conv_epilogue`` sends a tensor on the card to ``conv_epilogue_cuda``,
which rewrites ``x`` in place and raises on what it does not take
(``unsupported`` says why: dtype, channels-last and dense, C a multiple of
8, 16-byte aligned, no autograd through the in-place write), and counts
``serve.conv_epilogue`` on the innermost span open; a tensor off the card
runs ``conv_epilogue_torch``, the plain route, and counts
``serve.conv_epilogue.plain``. Both sum in fp32 (x + b, then + r) and
round once to x's dtype. ``conv_epilogue_cuda`` counts its launches in
``conv_epilogue_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.utils.profiling import count

__all__ = ["conv_epilogue", "conv_epilogue_torch", "conv_epilogue_cuda",
           "unsupported", "bytes_moved", "SOURCE", "REPLACES"]

SOURCE = "protoasnet_tpu_torch/csrc/conv_epilogue.cu"
REPLACES = "none (the served trunk's folded BatchNorm, residual and ReLU)"
_DTYPES = (torch.float32, torch.bfloat16)

_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = load_library("conv_epilogue.cu")
    fn = lib.conv_epilogue_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, ctypes.c_int64, i, vp]
        fn.restype = i
        lib.conv_epilogue_error_string.argtypes = [i]
        lib.conv_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _channels_last(t: torch.Tensor) -> bool:
    """(N, C, ...) laid out densely with C innermost."""
    return t.movedim(1, -1).is_contiguous()


def unsupported(x: torch.Tensor, bias: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why ``conv_epilogue_cuda`` does not take these tensors, or None
    where it does."""
    if x.device.type != "cuda":
        return f"x lies on {x.device}, not a card"
    if x.dtype not in _DTYPES:
        return f"x is {x.dtype}, not bf16 or fp32"
    if x.dim() < 2 or x.shape[1] % 8:
        return f"x {tuple(x.shape)} has no channel count that is a " \
               f"multiple of 8 in dim 1"
    if not _channels_last(x) or x.data_ptr() % 16:
        return "x is not channels-last, dense and 16-byte aligned"
    if torch.is_grad_enabled() and x.requires_grad:
        return "x requires grad: the kernel writes it in place"
    if bias.device != x.device or bias.dtype != torch.float32 or \
            tuple(bias.shape) != (x.shape[1],) or not bias.is_contiguous() \
            or bias.data_ptr() % 16:
        return f"bias {tuple(bias.shape)} {bias.dtype} on {bias.device} is " \
               f"not a 16-byte aligned fp32 vector of C on x's card"
    if residual is not None and (
            residual.device != x.device or residual.dtype != x.dtype
            or residual.shape != x.shape or not _channels_last(residual)
            or residual.data_ptr() % 16):
        return "the residual is not laid out as x"
    return None


def conv_epilogue_cuda(x: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``x`` rewritten in place as ``relu(x + bias[c] (+ residual))`` by
    one launch of the kernel; raises on what ``unsupported`` names."""
    why = unsupported(x, bias, residual)
    if why is not None:
        raise ValueError(f"conv_epilogue_cuda: {why}")
    if x.numel() == 0:
        return x
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_epilogue_forward(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            bias.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
            x.shape[1], stream)
    if err != 0:
        raise RuntimeError("conv_epilogue_cuda launch failed: "
                           + lib.conv_epilogue_error_string(err).decode())
    with _count_lock:  # a reload warms up on a second thread
        conv_epilogue_cuda.launches += 1
    return x


conv_epilogue_cuda.launches = 0


def conv_epilogue_torch(x: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain route: ``relu(x + bias[c] (+ residual))`` summed in the
    wider of x's and the bias's dtype, in x's dtype (a new tensor)."""
    y = x + bias.view(-1, *[1] * (x.dim() - 2))
    if residual is not None:
        y = y + residual
    return torch.relu(y).to(x.dtype)


def conv_epilogue(x: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(x + bias[c] (+ residual))``: the kernel, in place, for a
    tensor on the card (it raises on what it does not take), else the
    plain route; each call counted."""
    if x.is_cuda:
        out = conv_epilogue_cuda(x, bias, residual)
        count("serve.conv_epilogue")
        return out
    count("serve.conv_epilogue.plain")
    return conv_epilogue_torch(x, bias, residual)


def bytes_moved(numel: int, elem: int, channels: int,
                residual: bool) -> int:
    """What a call must move at least: x read and written, the residual
    read, the bias read once."""
    return numel * elem * (3 if residual else 2) + channels * 4
