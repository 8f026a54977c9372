"""Wrapper of the hand-written Hopper L2-distance + min-pool kernel, and its
autograd Function.

``csrc/l2_min.cu`` replaces the Pallas TPU kernel
``protoasnet_tpu/ops/pallas_l2.py::l2_min_pallas``; its header says what
bounds it and how it is laid out. The source is compiled for ``sm_90a`` at
first use (``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel, once per call (|w|^2 is
computed inside it), or raises; on a CPU tensor it runs the plain version
(``ops/l2_min.py::l2_min_torch``) and its own autograd. It counts its
launches in ``l2_min_cuda.launches``. The kernel computes in fp32: bf16
inputs are cast to fp32 first, as the Pallas wrapper does, and float64 is
refused rather than rounded. When an input requires grad, the CUDA call
goes through ``L2MinFunction``: its forward launches the kernel and keeps
(x, w, dist) with dist the kernel's own output, so the backward's argmin
is taken on the values the forward returned; its backward is
``l2_min_backward``, the closed form of the JAX package's custom VJP
(``pallas_l2.py::_bwd``, plain XLA there, so two ``torch.matmul`` in fp32
here); it counts its calls in ``l2_min_cuda.backward_calls``. The
prototypes' gradient comes only from that backward, never from the
detached fp32 copy the kernel reads.

``plan`` gives the launch the kernel takes (cluster size, d range per
block, blocks, shared memory); it mirrors the source's constants, and a
card test compares its shared memory with the library's
``l2_min_smem_bytes``; ``active_clusters`` asks the card how many clusters
it holds at once.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Tuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.l2_min import l2_min_backward, l2_min_torch
from protoasnet_tpu_torch.utils.flops import kernel_flops

__all__ = ["l2_min_cuda", "L2MinFunction", "plan", "staging_aligned",
           "active_clusters", "SOURCE", "REPLACES"]

_count_lock = threading.Lock()
SOURCE = "protoasnet_tpu_torch/csrc/l2_min.cu"
REPLACES = "protoasnet_tpu/ops/pallas_l2.py:45"
_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
# the source's constants: prototypes per block, d per stage, warps, dynamic
# shared memory per block (the warps' stages of 56 + 32 rows, the block's
# partials, the partials it receives), cluster size; d per block aimed at
# (the cluster splits D)
P_BLOCK, D_CHUNK, WARPS = 32, 32, 8
SMEM = (WARPS * (56 + 32) * 32 + 56 * 40 + 56 + 32 + 64 * 32 + 64
        + 8 * 32) * 4
MAX_CLUSTER, _D_TARGET = 8, 256


class Plan(NamedTuple):
    cluster: int  # blocks per sample, splitting D
    d_range: int  # d per block, a multiple of 256
    blocks: int
    smem: int  # dynamic shared memory per block, bytes


def plan(n: int, p: int, d: int) -> Plan:
    """The launch for N samples, P prototypes and D channels: d ranges of
    ceil(D / min(8, ceil(D/256))) rounded up to a multiple of 256 (32 d or
    more for each of a block's warps), one block each, so C = ceil(D/dr)
    blocks a cluster (at most 8), none without d; grid (C*N,
    ceil(P/32))."""
    c = min(MAX_CLUSTER, max(1, -(-d // _D_TARGET)))
    dr = max(1, -(-d // c))
    dr = -(-dr // (WARPS * D_CHUNK)) * WARPS * D_CHUNK
    c = max(1, -(-d // dr))
    return Plan(c, dr, c * n * -(-p // P_BLOCK), SMEM)


def staging_aligned(d: int, *ptrs: int) -> bool:
    """Whether the kernel can stage through 16-byte ``cp.async``: fp32 rows
    of D are 16-byte multiples and every pointer in ``ptrs`` (x and w)
    starts on a 16-byte boundary."""
    return d % 4 == 0 and all(q % 16 == 0 for q in ptrs)


def active_clusters(cluster: int) -> int:
    """Clusters of ``cluster`` blocks the current device holds at once (the
    CUDA occupancy query)."""
    n = _lib().l2_min_active_clusters(cluster)
    if n < 0:
        raise RuntimeError("l2_min_active_clusters failed: "
                           + _lib().l2_min_error_string(-n).decode())
    return n


def _lib() -> ctypes.CDLL:
    lib = load_library("l2_min.cu")
    fn = lib.l2_min_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.l2_min_smem_bytes.argtypes = []
        lib.l2_min_smem_bytes.restype = ctypes.c_int
        lib.l2_min_active_clusters.argtypes = [i]
        lib.l2_min_active_clusters.restype = ctypes.c_int
        lib.l2_min_error_string.argtypes = [ctypes.c_int]
        lib.l2_min_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x3: torch.Tensor, prototypes: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on x3 (N, S, D) and prototypes (P, ..., D) that
    the wrapper checked: (dist (N, S, P), min_d (N, P)) fp32."""
    n, s, d = x3.shape
    p = prototypes.shape[0]
    dist = torch.empty((n, s, p), dtype=torch.float32, device=x3.device)
    min_d = torch.empty((n, p), dtype=torch.float32, device=x3.device)
    if n == 0 or p == 0:
        return dist, min_d
    pl = plan(n, p, d)
    xf = x3.detach().to(torch.float32).contiguous()
    w = prototypes.detach().reshape(p, d).to(torch.float32).contiguous()
    aligned = staging_aligned(d, xf.data_ptr(), w.data_ptr())
    lib = _lib()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = lib.l2_min_forward(xf.data_ptr(), w.data_ptr(),
                                 dist.data_ptr(), min_d.data_ptr(),
                                 int(aligned), n, s, p, d, pl.cluster,
                                 pl.d_range, stream)
    if err != 0:
        raise RuntimeError("l2_min_cuda launch failed: "
                           + lib.l2_min_error_string(err).decode())
    with _count_lock:  # a reload warms up on a second thread
        l2_min_cuda.launches += 1
    # the plain version's product, for count_flops (ctypes is unseen)
    kernel_flops("l2_min_cuda", 2.0 * n * s * p * d)
    return dist, min_d


class L2MinFunction(torch.autograd.Function):
    """The CUDA forward with the closed-form backward of ``pallas_l2``."""

    @staticmethod
    def forward(ctx, x3, prototypes):
        dist, min_d = _launch(x3, prototypes)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x3, prototypes, dist)
        return dist, min_d

    @staticmethod
    def backward(ctx, g_dist, g_min):
        x3, prototypes, dist = ctx.saved_tensors
        l2_min_cuda.backward_calls += 1
        p, d = prototypes.shape[0], x3.shape[-1]
        g_x, g_w = l2_min_backward(x3, prototypes.reshape(p, d), dist,
                                   g_dist, g_min)
        return g_x, g_w.reshape(prototypes.shape)


def l2_min_cuda(x: torch.Tensor, prototypes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, ..., D), prototypes (P, 1, 1, D) or (P, D) -> (dist (N, ...,
    P) fp32, min_d (N, P) fp32); differentiable in both."""
    if x.device.type == "cpu":
        return l2_min_torch(x, prototypes)
    if x.device.type != "cuda":
        raise ValueError(f"l2_min_cuda: unsupported device {x.device}")
    if prototypes.device != x.device:
        raise ValueError(f"l2_min_cuda: prototypes on {prototypes.device}, "
                         f"x on {x.device}")
    for name, t in (("x", x), ("prototypes", prototypes)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"l2_min_cuda: {name} is {t.dtype}; the kernel "
                            f"computes in float32 and takes float32 or "
                            f"bfloat16 (float64 runs through l2_min_torch)")
    n, d = x.shape[0], x.shape[-1]
    p = prototypes.shape[0]
    if prototypes.dim() not in (2, 4) or prototypes.shape[-1] != d or (
            prototypes.dim() == 4 and tuple(prototypes.shape[1:3]) != (1, 1)):
        raise ValueError(f"l2_min_cuda: prototypes {tuple(prototypes.shape)}"
                         f" must be (P, {d}) or (P, 1, 1, {d}) for x "
                         f"{tuple(x.shape)}")
    s = math.prod(x.shape[1:-1])  # positions (explicit: N may be 0)
    if s == 0:
        raise ValueError(f"l2_min_cuda: x {tuple(x.shape)} has no positions "
                         f"to take the minimum over")
    pl = plan(n, p, d)
    if max(pl.cluster * n, s, d) > _INT_MAX or -(-p // P_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"l2_min_cuda: (N, S, P, D) = {(n, s, p, d)} "
                         f"exceeds the kernel's grid")
    x3 = x.reshape(n, s, d)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or prototypes.requires_grad):
        dist, min_d = L2MinFunction.apply(x3, prototypes)
    else:
        dist, min_d = _launch(x3, prototypes)
    return dist.reshape(*x.shape[:-1], p), min_d


l2_min_cuda.launches = 0
l2_min_cuda.backward_calls = 0
