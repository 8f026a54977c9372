"""Wrapper of the hand-written Hopper ROI-cosine head kernel (forward).

``csrc/roi_cosine.cu`` replaces the Pallas TPU kernel
``protoasnet_tpu/ops/pallas_roi.py::roi_cosine_pallas``; its header says
what bounds it and how it is laid out. The source is compiled for
``sm_90a`` at first use (``ops/cuda_build.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ops/roi_cosine.py::roi_cosine_torch``). It
counts its launches in ``roi_cosine_cuda.launches``. Forward only: the
gradient (``pallas_roi._bwd``) comes with the training slice, so an input
that requires grad is refused.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from protoasnet_tpu_torch.ops.cuda_build import load_library
from protoasnet_tpu_torch.ops.roi_cosine import _EPS, roi_cosine_torch

__all__ = ["roi_cosine_cuda", "SOURCE", "REPLACES"]

SOURCE = "protoasnet_tpu_torch/csrc/roi_cosine.cu"
REPLACES = "protoasnet_tpu/ops/pallas_roi.py:58"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535  # samples per launch (grid.y)


def _lib() -> ctypes.CDLL:
    lib = load_library("roi_cosine.cu")
    fn = lib.roi_cosine_forward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, vp, vp, vp, vp, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        lib.roi_cosine_error_string.argtypes = [ctypes.c_int]
        lib.roi_cosine_error_string.restype = ctypes.c_char_p
    return lib


def roi_cosine_cuda(occ: torch.Tensor, feat: torch.Tensor,
                    prototypes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """occ (N, ..., P) non-negative, feat (N, ..., D) of one dtype (fp32 or
    bf16), prototypes (P, D) -> (roi (N, P, D) fp32, sim01 (N, P) fp32)."""
    if occ.device.type == "cpu":
        return roi_cosine_torch(occ, feat, prototypes)
    if occ.device.type != "cuda":
        raise ValueError(f"roi_cosine_cuda: unsupported device {occ.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (occ, feat, prototypes)):
        raise RuntimeError(
            "roi_cosine_cuda is forward-only: an input requires grad. Run "
            "under torch.no_grad()/inference_mode(); the kernel's backward "
            "is ported with the training slice")
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
    occ2 = occ.reshape(n, -1, p).contiguous()
    feat2 = feat.reshape(n, -1, d).contiguous()
    s = occ2.shape[1]
    if feat2.shape[1] != s:
        raise ValueError(f"roi_cosine_cuda: occ has {s} positions, feat "
                         f"{feat2.shape[1]}")
    if n > _MAX_GRID_Y:
        raise ValueError(f"roi_cosine_cuda: batch {n} > {_MAX_GRID_Y}; "
                         f"split the batch")
    roi = torch.empty((n, p, d), dtype=torch.float32, device=occ.device)
    sim = torch.empty((n, p), dtype=torch.float32, device=occ.device)
    if n == 0 or p == 0:
        return roi, sim
    protos = prototypes.detach().to(torch.float32).contiguous()
    # computed outside the kernel, as pallas_roi._forward does
    pnorm = torch.linalg.vector_norm(protos, dim=1).clamp_min(_EPS)
    lib = _lib()
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        err = lib.roi_cosine_forward(
            occ2.data_ptr(), feat2.data_ptr(),
            int(occ2.dtype == torch.bfloat16), protos.data_ptr(),
            pnorm.data_ptr(), roi.data_ptr(), sim.data_ptr(), n, s, p, d,
            stream)
    if err != 0:
        raise RuntimeError("roi_cosine_cuda launch failed: "
                           + lib.roi_cosine_error_string(err).decode())
    roi_cosine_cuda.launches += 1
    return roi, sim


roi_cosine_cuda.launches = 0
