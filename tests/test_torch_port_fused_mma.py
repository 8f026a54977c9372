"""The fused Conv2Plus1D kernel's arithmetic and tiling, on the CPU.

The kernel (``csrc/fused_c2p1d.cu``) runs only on the card
(tests/test_torch_port_cuda.py). Here its accumulation order is emulated in
plain torch and held against float64 at the longest sums of the flagship's
blocks, layer3's K = 9*256 (spatial) and 3*576 (temporal): fp32 x as 3xTF32
(x, or the mid, split into TF32 hi/lo in the kernel, the taps by
``split_tf32``), the three products of each k8 step summed from zero and
added to the running fp32 sums; bf16 x with fp32 taps as k_hi + k_lo, two
bf16 products per k16 step. Also the wrapper's choice of tile, mid-channel
split and shared memory (``tiling``) and of the staging path.
"""

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch.experiments.common import BATCH, TOL
from protoasnet_tpu_torch.experiments.fused_c2p1d import BLOCKS
from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import (H100_SMEM, H100_SMS,
                                                       smem_bytes,
                                                       staging_aligned,
                                                       tiling)
from protoasnet_tpu_torch.ops.temporal_conv import split_bf16, split_tf32

SPATIAL_K, TEMPORAL_K = 9 * 256, 3 * 576  # layer3's two GEMMs


def _data(k, seed):
    """A (64 positions, K) and B (K, 64 channels) as the blocks see them:
    unit-normal inputs (or a ReLU'd mid), taps of std 0.05."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((64, k), np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 64), np.float32) * 0.05)
    return a, b


def _rel(out, ref):
    return ((out.double() - ref).abs().max() / ref.abs().max()).item()


def _steps(a, b, step):
    """The K sum cut into k-steps: (K / step, M, N) float64 partial
    products, each exact."""
    m, k = a.shape
    pa = a.double().reshape(m, k // step, step).permute(1, 0, 2)
    pb = b.double().reshape(k // step, step, -1)
    return pa @ pb


def _running_fp32(parts):
    """Each step's partial rounded to fp32 (the tensor cores' sum of one
    step) and added to the running fp32 sums in order."""
    acc = torch.zeros(parts.shape[1:], dtype=torch.float32)
    for p in parts:
        acc = acc + p.float()
    return acc


@pytest.mark.parametrize("k", [SPATIAL_K, TEMPORAL_K])
@pytest.mark.parametrize("relu", [False, True])
def test_3xtf32_per_step_keeps_fp32_accuracy(k, relu):
    """fp32 x: lo*hi + hi*lo + hi*hi per k8 step, summed from zero and
    added with fp32 adds, stays within 1e-5 of max |ref| (the fp32 limit)
    against float64; the spatial A is x, the temporal A a ReLU'd mid."""
    a, b = _data(k, seed=k + relu)
    if relu:
        a = a.clamp_min(0)
    ref = a.double() @ b.double()
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    parts = _steps(al, bh, 8) + _steps(ah, bl, 8) + _steps(ah, bh, 8)
    out = _running_fp32(parts)
    assert _rel(out, ref) <= TOL[torch.float32] / 5
    # one TF32 product alone misses the limit: the split is what holds it
    assert _rel(_running_fp32(_steps(ah, bh, 8)), ref) > TOL[torch.float32]


@pytest.mark.parametrize("k", [SPATIAL_K, TEMPORAL_K])
def test_bf16_x_with_fp32_taps_two_products(k):
    """bf16 x, fp32 taps: x * k_hi + x * k_lo per k16 step (bf16 products
    exact in fp32) keeps the fp32 taps to within 1e-5 of max |ref| against
    float64 of the same bf16 x, where k_hi alone is off by ~1e-3."""
    a, b = _data(k, seed=2 * k)
    a = a.to(torch.bfloat16)
    ref = a.double() @ b.double()
    hi, lo = split_bf16(b)
    out = _running_fp32(_steps(a, hi, 16) + _steps(a, lo, 16))
    assert _rel(out, ref) <= TOL[torch.float32]
    assert _rel(_running_fp32(_steps(a, hi, 16)), ref) > TOL[torch.float32]


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("elem, two", [(2, False), (2, True), (4, True)])
def test_tiling_fills_the_card_at_the_flagship_blocks(block, elem, two):
    """B=8 at each flagship block: at least 132 blocks (an H100's SMs),
    slices of a multiple of 16 that cover Cm, a tile of at most 64 positions
    and shared memory within 227 KB."""
    t, h, w, c, cm, co = BLOCKS[block]
    tl = tiling(BATCH, h, w, cm, elem, two)
    assert tl.blocks >= H100_SMS
    assert tl.blocks == tl.tiles * tl.splits * BATCH
    assert tl.tiles == -(-h // tl.th) * -(-w // tl.tw)
    assert tl.th * tl.tw <= 64
    assert tl.slice % 16 == 0 and tl.splits == -(-cm // tl.slice)
    assert tl.smem == smem_bytes(elem, two, tl.th, tl.tw, tl.slice)
    assert tl.smem <= H100_SMEM


# (b, h, w, cm, elem, two): one tile and one split (no scratch); a Cm far
# past one block's ring; the test shapes of tests/test_torch_port_cuda.py
@pytest.mark.parametrize("shape", [(1, 5, 7, 10, 4, True),
                                   (1, 4, 4, 20000, 4, True),
                                   (1, 4, 4, 20000, 2, False),
                                   (2, 9, 70, 33, 2, False),
                                   (1, 14, 14, 576, 2, True)])
def test_tiling_covers_any_shape(shape):
    b, h, w, cm, elem, two = shape
    tl = tiling(b, h, w, cm, elem, two)
    assert tl.smem <= H100_SMEM
    assert tl.slice * tl.splits >= cm > tl.slice * (tl.splits - 1)
    assert tl.splits == 1 or tl.slice % 16 == 0
    assert tl.th <= h and tl.tw <= w


# (elem, c, cm, co, pointers, cp.async?): layer1's block in bf16 and fp32;
# C=3, 5 (the tests' odd widths) and the JAX script's 16 in bf16 (32-byte
# rows); an x view 2 bytes off a 16-byte boundary; Co=65
STAGING = [(2, 64, 144, 64, (0, 256, 512), True),
           (4, 64, 144, 64, (0, 256, 512, 768, 1024), True),
           (2, 3, 10, 4, (0, 256, 512), False),
           (4, 5, 33, 65, (0, 256, 512, 768, 1024), False),
           (2, 16, 24, 16, (0, 256, 512), True),
           (2, 64, 144, 64, (2, 256, 512), False),
           (2, 64, 144, 65, (0, 256, 512), False)]


@pytest.mark.parametrize("elem, c, cm, co, ptrs, aligned", STAGING)
def test_staging_path_choice(elem, c, cm, co, ptrs, aligned):
    assert staging_aligned(elem, c, cm, co, *ptrs) is aligned
