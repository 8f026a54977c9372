"""Wrapper of the hand-written Hopper pooling-attention kernel, and its
autograd Function.

``csrc/pool_attn.cu`` replaces no TPU kernel (the JAX package has no
transformer trunk); its header says what bounds it and how it is laid out.
The source is compiled for ``sm_90a`` at first use (``ops/cuda_build.py``),
by the first MViT block that runs on the card: nothing else builds it.

``pool_attn_cuda`` launches the kernel once a call on CUDA tensors (it
raises on anything it does not take) and counts its launches in
``pool_attn_cuda.launches``. It computes in bf16 (fp32 sums and softmax)
where the inputs are bf16 or bf16 autocast is on, as the served trunk runs
(the pooling norms then give fp32 q, k and v, read as they are and rounded
once), else in fp32; the output is in the compute type. The positional
terms' inputs are made here, small and once a call: the three tables as
one, each axis's rows rounded up to 8 and times d^1/2, in the compute type
(``kernel_tables``), and the index rule per axis as int32
(``index_table``, made once per shape). When an input requires grad, the
call goes through ``PoolAttnFunction``: its forward launches the kernel and
keeps the inputs, its backward recomputes the plain route in fp32 under
autograd, a few clips at a time (``ops/pool_attn.py::
pool_attention_backward``), and counts its calls in
``pool_attn_cuda.backward_calls``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.pool_attn import (pool_attention_backward,
                                                rel_index, table_rows)
from protoasnet_tpu_torch.utils.flops import kernel_flops

__all__ = ["pool_attn_cuda", "PoolAttnFunction", "index_table",
           "kernel_tables", "smem_bytes", "SOURCE", "REPLACES", "KERNEL"]

SOURCE = "protoasnet_tpu_torch/csrc/pool_attn.cu"
REPLACES = "none (added for the MViTv2 trunk)"
KERNEL = "pool_attn_kernel"
HEAD_DIM = 96  # the source's kHD
REL_MAX = 32   # kRel: k_t + k_h + k_w at most
TABLE_MAX = 64  # kTabMax: one axis's table rows at most
LOG2E = 1.4426950408889634

_count_lock = threading.Lock()
_index: Dict[Tuple, torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = load_library("pool_attn.cu")
    fn = lib.pool_attn_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, ctypes.c_float, vp, vp]
        fn.restype = i
        lib.pool_attn_smem_bytes.argtypes = [i]
        lib.pool_attn_smem_bytes.restype = i
        lib.pool_attn_error_string.argtypes = [i]
        lib.pool_attn_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(elem: int) -> int:
    """Dynamic shared memory of one block, as the source lays it out: a
    chunk of 64 key rows of 96 + 32 columns (pitch 136 bf16, 132 fp32), v
    of the chunk transposed (pitch 72), and each of the 8 warps' 16 x 64
    fp32 table products."""
    pitch = 136 if elem == 2 else 132
    return 64 * pitch * elem + HEAD_DIM * 72 * elem + 8 * 16 * TABLE_MAX * 4


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def index_table(q_thw: Sequence[int], k_thw: Sequence[int],
                device) -> torch.Tensor:
    """int32 ``rel_index`` of the t, h and w axes in a row (qt·kt + qh·kh +
    qw·kw), made once per shape and device."""
    key = (tuple(q_thw), tuple(k_thw), str(device))
    if key not in _index:
        _index[key] = torch.cat([rel_index(int(q), int(k)).reshape(-1)
                                 for q, k in zip(q_thw, k_thw)]).to(
            device=device, dtype=torch.int32)
    return _index[key]


def kernel_tables(rel_t: torch.Tensor, rel_h: torch.Tensor,
                  rel_w: torch.Tensor, dtype) -> torch.Tensor:
    """The t, h and w tables in a row, each rounded up to 8 rows with zeros,
    times d^1/2, in ``dtype``."""
    parts = []
    for t in (rel_t, rel_h, rel_w):
        pad = t.new_zeros((_round8(t.shape[0]) - t.shape[0], t.shape[1]))
        parts += [t.detach().double(), pad.double()]
    return (torch.cat(parts) * HEAD_DIM ** 0.5).to(dtype).contiguous()


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype == torch.bfloat16 or (
            torch.is_autocast_enabled("cuda")
            and torch.get_autocast_dtype("cuda") == torch.bfloat16):
        return torch.bfloat16
    return torch.float32


def _launch(toks: Sequence[torch.Tensor], tables: Sequence[torch.Tensor],
            heads: int, dtype: torch.dtype) -> torch.Tensor:
    """One launch on checked, contiguous inputs; the output in ``dtype``."""
    q_sp, k_sp = toks[1], toks[3]
    n, qt, qh, qw, d = q_sp.shape
    kt, kh, kw = k_sp.shape[1:4]
    lq, lk = 1 + qt * qh * qw, 1 + kt * kh * kw
    out = torch.empty((n // heads, lq, heads * d), dtype=dtype,
                      device=q_sp.device)
    tab = kernel_tables(*tables, dtype)
    idx = index_table((qt, qh, qw), (kt, kh, kw), q_sp.device)
    ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in toks])
    sizes = (ctypes.c_int * 13)(n, heads, lq, lk, qt, qh, qw, kt, kh, kw,
                                *[t.shape[0] for t in tables])
    lib = _lib()
    with torch.cuda.device(q_sp.device):
        stream = torch.cuda.current_stream(q_sp.device).cuda_stream
        err = lib.pool_attn_forward(
            ctypes.addressof(ptrs), tab.data_ptr(), idx.data_ptr(),
            out.data_ptr(), int(q_sp.dtype == torch.bfloat16),
            int(dtype == torch.bfloat16), d ** -0.5 * LOG2E,
            ctypes.addressof(sizes), stream)
    if err != 0:
        raise RuntimeError("pool_attn_cuda launch failed: "
                           + lib.pool_attn_error_string(err).decode())
    with _count_lock:  # a reload warms up on a second thread
        pool_attn_cuda.launches += 1
    # the plain route's products, for count_flops (ctypes is unseen)
    kernel_flops("pool_attn_cuda", 4.0 * n * lq * lk * d
                 + 2.0 * n * (lq - 1) * (kt + kh + kw) * d)
    return out


class PoolAttnFunction(torch.autograd.Function):
    """The CUDA forward with the plain route's gradient, recomputed."""

    @staticmethod
    def forward(ctx, heads, dtype, *inputs):
        out = _launch(inputs[:6], inputs[6:], heads, dtype)
        ctx.save_for_backward(*inputs)
        ctx.heads = heads
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        with _count_lock:
            pool_attn_cuda.backward_calls += 1
        grads = pool_attention_backward(ctx.saved_tensors, ctx.heads, g_out)
        return (None, None) + grads


def pool_attn_cuda(q_cls: torch.Tensor, q_sp: torch.Tensor,
                   k_cls: torch.Tensor, k_sp: torch.Tensor,
                   v_cls: torch.Tensor, v_sp: torch.Tensor,
                   rel_t: torch.Tensor, rel_h: torch.Tensor,
                   rel_w: torch.Tensor, heads: int) -> torch.Tensor:
    """The class tokens (N, 96) and pooled spatial tokens (N, T, H, W, 96)
    of q, k and v on the card, one dtype (bf16 or fp32), N = clips·heads;
    the per-axis tables (2·max(q, k) - 1, 96) -> (clips, Lq, heads·96) in
    the compute type. Differentiable in every input."""
    toks = (q_cls, q_sp, k_cls, k_sp, v_cls, v_sp)
    tables = (rel_t, rel_h, rel_w)
    if any(t.device.type != "cuda" for t in toks + tables):
        raise ValueError("pool_attn_cuda takes CUDA tensors; the plain route "
                         "is ops/pool_attn.py::pool_attention_torch")
    if len({t.device for t in toks + tables}) != 1:
        raise ValueError("pool_attn_cuda: inputs on more than one device")
    if len({t.dtype for t in toks}) != 1 or q_sp.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"pool_attn_cuda takes q, k and v in one dtype, bf16 "
                        f"or fp32, not {sorted({str(t.dtype) for t in toks})}")
    if q_sp.dim() != 5 or k_sp.dim() != 5 or v_sp.shape != k_sp.shape:
        raise ValueError(f"q, k and v must be (N, T, H, W, d) volumes, not "
                         f"{tuple(q_sp.shape)}, {tuple(k_sp.shape)}, "
                         f"{tuple(v_sp.shape)}")
    n, qt, qh, qw, d = q_sp.shape
    kt, kh, kw = k_sp.shape[1:4]
    if d != HEAD_DIM or k_sp.shape[-1] != d:
        raise ValueError(f"heads {d} wide: the kernel takes heads "
                         f"{HEAD_DIM} wide")
    if any(tuple(c.shape) != (n, d) for c in (q_cls, k_cls, v_cls)) or \
            k_sp.shape[0] != n or heads < 1 or n % heads:
        raise ValueError(f"class tokens {[tuple(c.shape) for c in toks[::2]]}"
                         f" for {n} rows of {heads} heads")
    for t, q, k in zip(tables, (qt, qh, qw), (kt, kh, kw)):
        if tuple(t.shape) != (table_rows(q, k), d):
            raise ValueError(f"a table of {tuple(t.shape)} for sides {q}, "
                             f"{k}: {(table_rows(q, k), d)} expected")
    if kt + kh + kw > REL_MAX or max(t.shape[0] for t in tables) > \
            TABLE_MAX or n > 65535:
        raise ValueError(f"keys of sides {(kt, kh, kw)}, tables of "
                         f"{[t.shape[0] for t in tables]} rows or {n} rows "
                         f"of heads exceed the kernel's limits")
    toks = tuple(t.contiguous() for t in toks)
    if any(t.data_ptr() % 16 for t in toks):
        raise ValueError("pool_attn_cuda reads q, k and v 16 bytes at a "
                         "time: they must start on a 16-byte boundary")
    dtype = _compute_dtype(q_sp)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in toks + tables):
        return PoolAttnFunction.apply(heads, dtype, *toks, *tables)
    return _launch(toks, tables, heads, dtype)


pool_attn_cuda.launches = 0
pool_attn_cuda.backward_calls = 0
