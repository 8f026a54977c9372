"""Wrapper of the hand-written Hopper ROI-cosine head kernel, and its
autograd Function.

``csrc/roi_cosine.cu`` replaces the Pallas TPU kernel
``protoasnet_tpu/ops/pallas_roi.py::roi_cosine_pallas``; its header says
what bounds it and how it is laid out. The source is compiled for
``sm_90a`` at first use (``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel, once per call (the
prototype norms are computed inside it), or raises; on a CPU tensor it runs
the plain version (``ops/roi_cosine.py::roi_cosine_torch``) and its own
autograd. It counts its launches in ``roi_cosine_cuda.launches``. When an
input requires grad, the CUDA call goes through ``RoiCosineFunction``: its
forward launches the kernel and keeps (occ, feat, prototypes, roi), its
backward is ``roi_cosine_backward``, the closed form of the JAX package's
custom VJP (``pallas_roi.py::_bwd``, plain XLA there, so two ``torch.bmm``
in fp32 here); it counts its calls in ``roi_cosine_cuda.backward_calls``.
The prototypes' gradient comes only from that backward, never from the
detached fp32 copy the kernel reads.

``plan`` gives the launch the kernel takes (cluster size, blocks, shared
memory); it mirrors the source's constants, and a card test compares its
shared memory with the library's ``roi_cosine_smem_bytes``;
``active_clusters`` asks the card how many clusters it holds at once.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Tuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.roi_cosine import (roi_cosine_backward,
                                                 roi_cosine_torch)

__all__ = ["roi_cosine_cuda", "RoiCosineFunction", "plan", "staging_aligned",
           "smem_bytes",
           "active_clusters", "SOURCE", "REPLACES"]

_count_lock = threading.Lock()
SOURCE = "protoasnet_tpu_torch/csrc/roi_cosine.cu"
REPLACES = "protoasnet_tpu/ops/pallas_roi.py:58"
_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
# the source's constants: d per block, prototypes per block, row pitches
# (elements), ring stages, cluster size
D_BLOCK, P_BLOCK = 128, 40
_FEAT_PITCH, _OCC_PITCH = D_BLOCK + 8, P_BLOCK
_MAX_STAGES, MAX_CLUSTER = 4, 8


def smem_bytes(elem: int, s: int) -> int:
    """Dynamic shared memory of one block: the ring of stages of 64 (bf16)
    or 32 (fp32) positions, what S positions need, at least 1, at most
    4."""
    kc = 64 if elem == 2 else 32
    stages = min(max(-(-s // kc), 1), _MAX_STAGES)
    return stages * kc * (_FEAT_PITCH + _OCC_PITCH) * elem


class Plan(NamedTuple):
    cluster: int  # blocks per sample, one d tile of 128 each
    blocks: int
    smem: int  # dynamic shared memory per block, bytes


def plan(n: int, s: int, p: int, d: int, elem: int) -> Plan:
    """The launch for N samples of S positions, P prototypes and D
    channels of ``elem``-byte inputs: grid (C*N, ceil(P/40)) in clusters of
    C = ceil(D/128) (at most 8) blocks."""
    c = min(MAX_CLUSTER, max(1, -(-d // D_BLOCK)))
    return Plan(c, c * n * -(-p // P_BLOCK), smem_bytes(elem, s))


def staging_aligned(elem: int, p: int, d: int, *ptrs: int) -> bool:
    """Whether the kernel can stage through 16-byte ``cp.async``: rows of P
    and of D elements of ``elem`` bytes and fp32 rows of D (the
    prototypes) are 16-byte multiples and every pointer in ``ptrs`` (occ,
    feat and the prototypes) starts on a 16-byte boundary."""
    return (p * elem) % 16 == 0 and (d * elem) % 16 == 0 and d % 4 == 0 \
        and all(q % 16 == 0 for q in ptrs)


def active_clusters(elem: int, s: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks the current device holds at once for
    S positions of ``elem``-byte inputs (the CUDA occupancy query)."""
    n = _lib().roi_cosine_active_clusters(int(elem == 2), s, cluster)
    if n < 0:
        raise RuntimeError("roi_cosine_active_clusters failed: "
                           + _lib().roi_cosine_error_string(-n).decode())
    return n


def _lib() -> ctypes.CDLL:
    lib = load_library("roi_cosine.cu")
    fn = lib.roi_cosine_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.roi_cosine_smem_bytes.argtypes = [i, i]
        lib.roi_cosine_smem_bytes.restype = ctypes.c_int
        lib.roi_cosine_active_clusters.argtypes = [i, i, i]
        lib.roi_cosine_active_clusters.restype = ctypes.c_int
        lib.roi_cosine_error_string.argtypes = [ctypes.c_int]
        lib.roi_cosine_error_string.restype = ctypes.c_char_p
    return lib


def _launch(occ2: torch.Tensor, feat2: torch.Tensor,
            prototypes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on contiguous occ2 (N,S,P), feat2 (N,S,D)."""
    n, s, p = occ2.shape
    d = feat2.shape[-1]
    roi = torch.empty((n, p, d), dtype=torch.float32, device=occ2.device)
    sim = torch.empty((n, p), dtype=torch.float32, device=occ2.device)
    if n == 0 or p == 0:
        return roi, sim
    pl = plan(n, s, p, d, occ2.element_size())
    protos = prototypes.detach().to(torch.float32).contiguous()
    aligned = staging_aligned(occ2.element_size(), p, d, occ2.data_ptr(),
                              feat2.data_ptr(), protos.data_ptr())
    lib = _lib()
    with torch.cuda.device(occ2.device):
        stream = torch.cuda.current_stream(occ2.device).cuda_stream
        err = lib.roi_cosine_forward(
            occ2.data_ptr(), feat2.data_ptr(),
            int(occ2.dtype == torch.bfloat16), protos.data_ptr(),
            roi.data_ptr(), sim.data_ptr(), int(aligned), n, s, p, d,
            pl.cluster, stream)
    if err != 0:
        raise RuntimeError("roi_cosine_cuda launch failed: "
                           + lib.roi_cosine_error_string(err).decode())
    with _count_lock:  # a reload warms up on a second thread
        roi_cosine_cuda.launches += 1
    return roi, sim


class RoiCosineFunction(torch.autograd.Function):
    """The CUDA forward with the closed-form backward of ``pallas_roi``."""

    @staticmethod
    def forward(ctx, occ2, feat2, prototypes):
        roi, sim = _launch(occ2, feat2, prototypes)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(occ2, feat2, prototypes, roi)
        return roi, sim

    @staticmethod
    def backward(ctx, g_roi, g_sim):
        occ2, feat2, prototypes, roi = ctx.saved_tensors
        roi_cosine_cuda.backward_calls += 1
        return roi_cosine_backward(occ2, feat2, prototypes, roi, g_roi,
                                   g_sim)


def roi_cosine_cuda(occ: torch.Tensor, feat: torch.Tensor,
                    prototypes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """occ (N, ..., P) non-negative, feat (N, ..., D) of one dtype (fp32 or
    bf16), prototypes (P, D) -> (roi (N, P, D) fp32, sim01 (N, P) fp32);
    differentiable in all three."""
    if occ.device.type == "cpu":
        return roi_cosine_torch(occ, feat, prototypes)
    if occ.device.type != "cuda":
        raise ValueError(f"roi_cosine_cuda: unsupported device {occ.device}")
    for name, t in (("feat", feat), ("prototypes", prototypes)):
        if t.device != occ.device:
            raise ValueError(f"roi_cosine_cuda: {name} on {t.device}, occ on "
                             f"{occ.device}")
    if occ.dtype not in _DTYPES or feat.dtype != occ.dtype:
        raise TypeError(f"roi_cosine_cuda: occ {occ.dtype}, feat "
                        f"{feat.dtype}; the kernel takes both float32 or "
                        f"both bfloat16")
    n, p, d = occ.shape[0], occ.shape[-1], feat.shape[-1]
    if feat.shape[0] != n or tuple(prototypes.shape) != (p, d):
        raise ValueError(f"roi_cosine_cuda: shapes occ {tuple(occ.shape)}, "
                         f"feat {tuple(feat.shape)}, prototypes "
                         f"{tuple(prototypes.shape)} do not agree")
    s = math.prod(occ.shape[1:-1])  # positions (explicit: N may be 0)
    if math.prod(feat.shape[1:-1]) != s:
        raise ValueError(f"roi_cosine_cuda: occ has {s} positions, feat "
                         f"{math.prod(feat.shape[1:-1])}")
    pl = plan(n, s, p, d, occ.element_size())
    if max(pl.cluster * n, s, d) > _INT_MAX or -(-p // P_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"roi_cosine_cuda: (N, S, P, D) = {(n, s, p, d)} "
                         f"exceeds the kernel's grid")
    occ2 = occ.reshape(n, s, p).contiguous()
    feat2 = feat.reshape(n, s, d).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (occ, feat, prototypes)):
        return RoiCosineFunction.apply(occ2, feat2, prototypes)
    return _launch(occ2, feat2, prototypes)


roi_cosine_cuda.launches = 0
roi_cosine_cuda.backward_calls = 0
