"""Wrapper of the hand-written Hopper L2-distance + min-pool kernel (forward).

``csrc/l2_min.cu`` replaces the Pallas TPU kernel
``protoasnet_tpu/ops/pallas_l2.py::l2_min_pallas``; its header says what
bounds it and how it is laid out. The source is compiled for ``sm_90a`` at
first use (``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel, once per call (|w|^2 is
computed inside it), or raises; on a CPU tensor it runs the plain version
(``ops/l2_min.py::l2_min_torch``). It counts its launches in
``l2_min_cuda.launches``. The kernel computes in fp32: bf16 inputs are cast
to fp32 first, as the Pallas wrapper does, and float64 is refused rather
than rounded. Forward only: the gradient (``pallas_l2._bwd``) comes with the
training slice, so an input that requires grad is refused.

``plan`` gives the launch the kernel takes (cluster size, d range per
block, blocks, shared memory); it mirrors the source's constants, and a
card test compares its shared memory with the library's
``l2_min_smem_bytes``; ``active_clusters`` asks the card how many clusters
it holds at once.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.l2_min import l2_min_torch

__all__ = ["l2_min_cuda", "plan", "staging_aligned", "active_clusters",
           "SOURCE", "REPLACES"]

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


def l2_min_cuda(x: torch.Tensor, prototypes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, ..., D), prototypes (P, 1, 1, D) or (P, D) -> (dist (N, ...,
    P) fp32, min_d (N, P) fp32)."""
    if x.device.type == "cpu":
        return l2_min_torch(x, prototypes)
    if x.device.type != "cuda":
        raise ValueError(f"l2_min_cuda: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad
                                    or prototypes.requires_grad):
        raise RuntimeError(
            "l2_min_cuda is forward-only: an input requires grad. Run under "
            "torch.no_grad()/inference_mode(); the kernel's backward is "
            "ported with the training slice")
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
    x3 = x.detach().reshape(n, s, d).to(torch.float32).contiguous()
    if s == 0:
        raise ValueError(f"l2_min_cuda: x {tuple(x.shape)} has no positions "
                         f"to take the minimum over")
    pl = plan(n, p, d)
    if max(pl.cluster * n, s, d) > _INT_MAX or -(-p // P_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"l2_min_cuda: (N, S, P, D) = {(n, s, p, d)} "
                         f"exceeds the kernel's grid")
    dist = torch.empty((n, s, p), dtype=torch.float32, device=x.device)
    min_d = torch.empty((n, p), dtype=torch.float32, device=x.device)
    if n == 0 or p == 0:
        return dist.reshape(*x.shape[:-1], p), min_d
    w = prototypes.detach().reshape(p, d).to(torch.float32).contiguous()
    aligned = staging_aligned(d, x3.data_ptr(), w.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.l2_min_forward(x3.data_ptr(), w.data_ptr(),
                                 dist.data_ptr(), min_d.data_ptr(),
                                 int(aligned), n, s, p, d, pl.cluster,
                                 pl.d_range, stream)
    if err != 0:
        raise RuntimeError("l2_min_cuda launch failed: "
                           + lib.l2_min_error_string(err).decode())
    l2_min_cuda.launches += 1
    return dist.reshape(*x.shape[:-1], p), min_d


l2_min_cuda.launches = 0
