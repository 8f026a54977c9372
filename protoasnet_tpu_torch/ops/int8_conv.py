"""The int8 convolution of the w8a8 serving path (``quant.py``).

The JAX package's int8 conv is XLA's
``lax.conv_general_dilated(int8, int8, preferred_element_type=int32)``
(``protoasnet_tpu/quant.py:318-322``), not a Pallas kernel, so it goes to
PyTorch's own ops. PyTorch on CUDA has no int8 convolution; the card's
route is an implicit GEMM through ``torch._int_mm`` (cuBLASLt, int8 in,
int32 sums):

- the codes are read channels-last and zero-padded: spatially by the
  conv's padding, and the channels C to a multiple of 8, so that K =
  taps * C is one (``_int_mm`` wants K and N multiples of 8 and M > 16);
  the output channels are padded to a multiple of 8 with zero weights and
  M to 32 rows where it is 16 or fewer. Zeros keep the sums exact;
- im2col: the padded codes' windows (``Tensor.unfold``) copied into one
  (M, taps * C) int8 matrix, taps outer and channels inner, against the
  weights laid out the same way;
- the batch is cut into chunks whose transient (padded codes, columns,
  int32 sums and the epilogue's fp32) stays under ``CHUNK_BYTES`` (512
  MiB), so the int8 path holds at most that beyond its input and output:
  at the flagship's bucket of 128 layer1's spatial conv has M =
  12,845,056 rows and K = 576, a 7.40 GB im2col and 7.40 GB of int32 sums
  unchunked, and its int8 input is 0.82 GB smaller than the bf16 one;
- each chunk's sums go through the caller's epilogue (dequantisation, or
  the folded pair's int8 emit) into the output, channels-last.

The plain version (the CPU's, and the tests') is the conv in float64 on
the codes, rounded to int32: exact, since |sum| <= 127^2 * K < 2^53. On
either device the sums are exact while 127^2 * K < 2^31 (K <= 133,152); a
larger K raises. Nothing here falls back to a float convolution: a shape
the GEMM cannot take raises.

``LAUNCHES`` counts the ``_int_mm`` calls, one per chunk.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

__all__ = ["int8_conv", "int8_conv_torch", "int8_conv_cuda", "int_mm",
           "quantize", "plan", "Plan", "CHUNK_BYTES", "MAX_K", "LAUNCHES"]

LAUNCHES = 0  # torch._int_mm calls (one per chunk) on the card
CHUNK_BYTES = 1 << 29  # a chunk's transient on the card
MAX_K = (2 ** 31 - 1) // (127 * 127)  # int32 sums stay exact up to here

Epilogue = Callable[[torch.Tensor], torch.Tensor]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tuple(v, nd: int):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * nd


def _check(xq: torch.Tensor, wq: torch.Tensor) -> int:
    """Spatial rank of the conv; raises on what it cannot compute."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8 codes and weights, not "
                        f"{xq.dtype} and {wq.dtype}")
    nd = xq.dim() - 2
    if nd not in (1, 2, 3) or wq.dim() != xq.dim():
        raise ValueError(f"int8 conv: input {tuple(xq.shape)} and weight "
                         f"{tuple(wq.shape)} are not a 1-, 2- or 3-D conv")
    if xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8 conv: {xq.shape[1]} input channels against "
                         f"a weight of {wq.shape[1]} (groups are not taken)")
    k = wq[0].numel()
    if k > MAX_K:
        raise ValueError(f"int8 conv: K = {k} > {MAX_K}, int32 sums would "
                         f"not be exact")
    return nd


def quantize(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(float32(x) * inv_scale), -127, 127)`` as int8 (the
    JAX package's quantiser: a multiply by the reciprocal, round half to
    even), a batch chunk at a time so the fp32 temporary stays under
    ``CHUNK_BYTES``; the codes keep ``x``'s memory layout."""
    out = torch.empty_like(x, dtype=torch.int8)
    per = max(1, x[0].numel() * 4) if len(x) else 1
    step = max(1, CHUNK_BYTES // per)
    for b0 in range(0, len(x), step):
        t = x[b0:b0 + step].float() * inv_scale
        out[b0:b0 + step] = torch.clamp(torch.round(t), -127, 127)
    return out


def int8_conv_torch(xq: torch.Tensor, wq: torch.Tensor,
                    stride: Sequence[int], padding: Sequence[int]
                    ) -> torch.Tensor:
    """Plain version: int32 sums (N, O, *out) of the conv of the codes
    ``xq`` (N, C, *spatial) with ``wq`` (O, C, *kernel), zero padding."""
    nd = _check(xq, wq)
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    with torch.autocast(xq.device.type, enabled=False):
        y = conv(xq.double(), wq.double(), stride=_tuple(stride, nd),
                 padding=_tuple(padding, nd))
    return y.round().to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(a, b)`` (int8 (M, K) x (K, N) -> int32), counted;
    raises on a shape it cannot take (M <= 16, K or N not a multiple of
    8) instead of leaving that to cuBLASLt."""
    global LAUNCHES
    (m, k), (k2, n) = a.shape, b.shape
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"_int_mm takes int8, not {a.dtype} x {b.dtype}")
    if m <= 16 or k % 8 or n % 8 or k != k2:
        raise ValueError(f"_int_mm takes M > 16 and K, N multiples of 8, "
                         f"not ({m}, {k}) x ({k2}, {n})")
    LAUNCHES += 1
    return torch._int_mm(a, b)


def int8_conv_cuda(xq: torch.Tensor, wq: torch.Tensor,
                   stride: Sequence[int], padding: Sequence[int],
                   epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """Card version: the conv as chunked im2col GEMMs on ``_int_mm``.
    ``epilogue`` maps a chunk's int32 sums (rows, O) to the output's
    values (any dtype; default: the sums). Returns (N, O, *out), stored
    channels-last."""
    if xq.device.type != "cuda":
        raise RuntimeError("int8_conv_cuda takes CUDA tensors")
    return _gemm_conv(xq, wq, stride, padding, epilogue)


class Plan(NamedTuple):
    """The GEMM form of one conv: output and padded spatial sizes, C and
    O padded to multiples of 8, K = taps * Cp, output rows a sample, and
    samples a chunk."""
    out_sp: Tuple[int, ...]
    padded_sp: Tuple[int, ...]
    cp: int
    op: int
    kk: int
    rows: int
    step: int


def plan(x_shape: Sequence[int], w_shape: Sequence[int],
         stride: Sequence[int], padding: Sequence[int]) -> Plan:
    """The card version's GEMM shapes and chunks for an input of
    ``x_shape`` (N, C, *spatial) and weights of ``w_shape``."""
    nd = len(x_shape) - 2
    stride, padding = _tuple(stride, nd), _tuple(padding, nd)
    n, c, *sp = x_shape
    o, _, *ks = w_shape
    out_sp = tuple((s + 2 * p - k) // st + 1
                   for s, p, k, st in zip(sp, padding, ks, stride))
    padded_sp = tuple(s + 2 * p for s, p in zip(sp, padding))
    cp, op = _round_up(c, 8), _round_up(o, 8)
    kk = cp * math.prod(ks)
    rows = math.prod(out_sp)
    # padded codes, columns, and per output: int32 sums, the epilogue's
    # fp32 and the output
    per_sample = cp * math.prod(padded_sp) + rows * (kk + 10 * op)
    step = max(1, min(n, CHUNK_BYTES // per_sample))
    return Plan(out_sp, padded_sp, cp, op, kk, rows, step)


def _gemm_conv(xq, wq, stride, padding, epilogue):
    """The card version's algorithm on any device (the CPU's ``_int_mm``
    runs it in the tests)."""
    nd = _check(xq, wq)
    stride, padding = _tuple(stride, nd), _tuple(padding, nd)
    n, c, *sp = xq.shape
    o, _, *ks = wq.shape
    pl = plan(xq.shape, wq.shape, stride, padding)
    # weights (Op, taps * Cp): taps outer, channels inner, zero padded
    wp = wq.new_zeros((pl.op, pl.cp, *ks))
    wp[:o, :c] = wq
    w2 = wp.permute(0, *range(2, 2 + nd), 1).reshape(pl.op, pl.kk)
    out = None
    cl = xq.permute(0, *range(2, 2 + nd), 1)  # channels-last view
    inner = tuple(slice(p, p + s) for p, s in zip(padding, sp))
    for b0 in range(0, n, pl.step):
        bc = min(pl.step, n - b0)
        xp = xq.new_zeros((bc, *pl.padded_sp, pl.cp))
        xp[(slice(None), *inner, slice(0, c))] = cl[b0:b0 + bc]
        win = xp
        for d, (k, st) in enumerate(zip(ks, stride)):
            win = win.unfold(1 + d, k, st)
        # (bc, *out_sp, Cp, *ks) -> (bc, *out_sp, *ks, Cp) -> (M, K)
        win = win.permute(0, *range(1, 1 + nd),
                          *range(2 + nd, 2 + 2 * nd), 1 + nd)
        cols = win.reshape(bc * pl.rows, pl.kk)
        m = cols.shape[0]
        if m <= 16:
            cols = F.pad(cols, (0, 0, 0, 32 - m))
        y = int_mm(cols, w2.t())[:m, :o]
        y = y if epilogue is None else epilogue(y)
        if out is None:
            out = torch.empty((n, *pl.out_sp, o), dtype=y.dtype,
                              device=xq.device)
        out[b0:b0 + bc].view(m, o).copy_(y)
        del xp, win, cols, y
    return out.permute(0, nd + 1, *range(1, nd + 1))


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
              padding: Sequence[int],
              epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """The int8 conv on ``xq``'s device: the card version on a CUDA
    tensor, the plain version on a CPU one; ``epilogue`` as in
    ``int8_conv_cuda`` (applied over the channel axis)."""
    if xq.device.type == "cuda":
        return int8_conv_cuda(xq, wq, stride, padding, epilogue)
    if xq.device.type != "cpu":
        raise RuntimeError(f"int8 conv on {xq.device.type!r}")
    y = int8_conv_torch(xq, wq, stride, padding)
    if epilogue is None:
        return y
    return epilogue(y.movedim(1, -1)).movedim(-1, 1)
