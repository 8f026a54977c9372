"""Wrapper of the hand-written Hopper shifted-window attention kernel, and
its autograd Function.

``csrc/window_attn.cu`` replaces no TPU kernel (the JAX package has no
transformer trunk); its header says what bounds it and how it is laid out.
The source is compiled for ``sm_90a`` at first use (``ops/cuda_build.py``).

``window_attn_cuda`` launches the kernel once a call on a CUDA volume of
bf16 or fp32 (it raises on anything else) and counts its launches in
``window_attn_cuda.launches``. The roll and the window partition are the
kernel's addressing: ``index_tables`` gives, once per shape, the token at
each position of each window of the rolled volume, each window index's
place in the module's window (the bias is read at ``c0 + pos[i] -
pos[j]``) and each position's region (the shifted windows' mask). When an
input requires grad, the call goes through ``WindowAttnFunction``: its
forward launches the kernel and keeps qkv and the table, its backward
recomputes the plain route in fp32 under autograd, a few clips at a time
(``ops/window_attn.py::window_attention_backward``), and counts its calls
in ``window_attn_cuda.backward_calls``.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Sequence, Tuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.window_attn import (MASK_VALUE, _partition,
                                                  region_labels,
                                                  window_attention_backward)
from protoasnet_tpu_torch.utils.flops import kernel_flops

__all__ = ["window_attn_cuda", "WindowAttnFunction", "index_tables",
           "table_offset", "smem_bytes", "SOURCE", "REPLACES", "KERNEL"]

SOURCE = "protoasnet_tpu_torch/csrc/window_attn.cu"
REPLACES = "none (added for the Video Swin trunk)"
KERNEL = "window_attn_kernel"
HEAD_DIM = 32  # the source's kHD
LOG2E = 1.4426950408889634
_INT_MAX = 2 ** 31 - 1
_SMEM_MAX = 232448  # a block's shared memory on an H100

_count_lock = threading.Lock()
_tables: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _lib() -> ctypes.CDLL:
    lib = load_library("window_attn.cu")
    fn = lib.window_attn_forward
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, i, vp, vp, vp, vp, f, f, i, i, i, i, i, i, i,
                       i, i, vp]
        fn.restype = ctypes.c_int
        lib.window_attn_smem_bytes.argtypes = [i, i, i]
        lib.window_attn_smem_bytes.restype = ctypes.c_int
        lib.window_attn_error_string.argtypes = [ctypes.c_int]
        lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(elem: int, n: int, rows: int) -> int:
    """Dynamic shared memory of one block, as the source lays it out: k
    rows of 40 (bf16) or 36 (fp32) elements and v transposed, N rounded up
    to 16, the keys' int words and the head's table column."""
    npad = -(-n // 16) * 16
    kp = HEAD_DIM + (8 if elem == 2 else 4)
    return npad * kp * elem + HEAD_DIM * (npad + 8) * elem + npad * 4 \
        + rows * 4


def table_offset(table_window: Sequence[int]) -> int:
    """The table row of the pair (i, i): A(i) - A(j) + this is the pair's
    relative-position index."""
    vt, vh, vw = (int(v) for v in table_window)
    return ((vt - 1) * (2 * vh - 1) * (2 * vw - 1) + (vh - 1) * (2 * vw - 1)
            + (vw - 1))


def index_tables(size: Sequence[int], window: Sequence[int],
                 shift: Sequence[int], table_window: Sequence[int],
                 device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's int32 tables for one volume, made once per shape and
    device: ``tok`` (windows, N), the token (row within a clip) at each
    position of each window of the volume rolled by -shift; ``pos`` (N,),
    A(j), a window index's place in the table's window; ``lab`` (windows,
    N), the region of each position (all 0 without a shift)."""
    key = (tuple(size), tuple(window), tuple(shift), tuple(table_window),
           str(device))
    if key not in _tables:
        t, h, w = (int(x) for x in size)
        tokens = torch.arange(t * h * w, device=device).reshape(t, h, w)
        if any(shift):
            tokens = torch.roll(tokens, [-int(x) for x in shift], (0, 1, 2))
        tok = _partition(tokens[None], window)
        lab = _partition(region_labels(size, window, shift, device)[None],
                         window)
        n = math.prod(window)
        j = torch.arange(n, device=device)
        _, vh, vw = (int(v) for v in table_window)
        pos = ((j // (vh * vw)) * ((2 * vh - 1) * (2 * vw - 1))
               + ((j // vw) % vh) * (2 * vw - 1) + j % vw)
        _tables[key] = (tok.to(torch.int32).contiguous(),
                        pos.to(torch.int32), lab.to(torch.int32).contiguous())
    return _tables[key]


def _launch(qkv: torch.Tensor, table: torch.Tensor, num_heads: int,
            window: Tuple[int, ...], shift: Tuple[int, ...],
            table_window: Tuple[int, ...]) -> torch.Tensor:
    """One launch on a checked, contiguous qkv."""
    b, t, h, w, c3 = qkv.shape
    c = c3 // 3
    n = math.prod(window)
    nw = (t // window[0]) * (h // window[1]) * (w // window[2])
    rows = table.shape[0]
    out = torch.empty((b, t, h, w, c), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    tok, pos, lab = index_tables((t, h, w), window, shift, table_window,
                                 qkv.device)
    tbl = (table.detach().to(torch.float32).t() * LOG2E).contiguous()
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.window_attn_forward(
            qkv.data_ptr(), out.data_ptr(), int(qkv.dtype == torch.bfloat16),
            tbl.data_ptr(), tok.data_ptr(), pos.data_ptr(), lab.data_ptr(),
            HEAD_DIM ** -0.5 * LOG2E, MASK_VALUE * LOG2E, t * h * w, c,
            num_heads, n, nw, b * nw, rows, table_offset(table_window),
            int(any(shift)), stream)
    if err != 0:
        raise RuntimeError("window_attn_cuda launch failed: "
                           + lib.window_attn_error_string(err).decode())
    with _count_lock:  # a reload warms up on a second thread
        window_attn_cuda.launches += 1
    # the plain route's two products, for count_flops (ctypes is unseen)
    kernel_flops("window_attn_cuda", 4.0 * b * nw * num_heads * n * n
                 * HEAD_DIM)
    return out


class WindowAttnFunction(torch.autograd.Function):
    """The CUDA forward with the plain route's gradient, recomputed."""

    @staticmethod
    def forward(ctx, qkv, table, index, num_heads, window, shift,
                table_window):
        out = _launch(qkv, table, num_heads, window, shift, table_window)
        ctx.save_for_backward(qkv, table, index)
        ctx.args = (num_heads, window, shift)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        qkv, table, index = ctx.saved_tensors
        with _count_lock:
            window_attn_cuda.backward_calls += 1
        g_qkv, g_table = window_attention_backward(qkv, table, index,
                                                   *ctx.args, g_out)
        return g_qkv, g_table, None, None, None, None, None


def window_attn_cuda(qkv: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, num_heads: int,
                     window: Sequence[int], shift: Sequence[int],
                     table_window: Sequence[int]) -> torch.Tensor:
    """(B, T, H, W, 3C) bf16 or fp32 on the card, sides multiples of
    ``window``, heads 32 wide -> (B, T, H, W, C) in its dtype; ``table``
    ((2·Vt-1)(2·Vh-1)(2·Vw-1), heads) of the module's window
    ``table_window``, ``index`` its relative-position index (the backward's
    plain route reads it). Differentiable in qkv and the table."""
    if qkv.device.type != "cuda":
        raise ValueError("window_attn_cuda takes CUDA tensors; the plain "
                         "route is ops/window_attn.py::window_attention_torch")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attn_cuda takes bf16 or fp32, not "
                        f"{qkv.dtype}")
    if qkv.dim() != 5:
        raise ValueError(f"qkv must be a (B, T, H, W, 3C) volume, not "
                         f"{tuple(qkv.shape)}")
    if table.device != qkv.device:
        raise ValueError(f"window_attn_cuda: table on {table.device}, qkv on "
                         f"{qkv.device}")
    b, t, h, w, c3 = qkv.shape
    window = tuple(int(x) for x in window)
    shift = tuple(int(x) for x in shift)
    table_window = tuple(int(x) for x in table_window)
    if any(s % x for s, x in zip((t, h, w), window)) or any(
            x > v for x, v in zip(window, table_window)):
        raise ValueError(f"volume {(t, h, w)} is not a whole number of "
                         f"windows {window} within {table_window}")
    if c3 != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"3C = {c3} over {num_heads} heads: the kernel "
                         f"takes heads {HEAD_DIM} wide")
    rows = math.prod(2 * v - 1 for v in table_window)
    if tuple(table.shape) != (rows, num_heads):
        raise ValueError(f"table {tuple(table.shape)}, expected "
                         f"{(rows, num_heads)}")
    n = math.prod(window)
    nw = (t // window[0]) * (h // window[1]) * (w // window[2])
    if smem_bytes(qkv.element_size(), n, rows) > _SMEM_MAX or \
            b * nw > _INT_MAX or num_heads > 65535:
        raise ValueError(f"windows of {n} tokens, a table of {rows} rows or "
                         f"{b * nw} windows exceed the kernel's limits")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("window_attn_cuda reads qkv 16 bytes at a time: it "
                         "must start on a 16-byte boundary")
    if torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad):
        return WindowAttnFunction.apply(qkv, table, index, num_heads, window,
                                        shift, table_window)
    return _launch(qkv, table, num_heads, window, shift, table_window)


window_attn_cuda.launches = 0
window_attn_cuda.backward_calls = 0
