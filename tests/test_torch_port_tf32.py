"""The temporal-conv kernel's arithmetic, emulated in plain torch on the
CPU: the 3xTF32 split that carries its fp32 products on the tensor cores,
the bf16 hi + lo split of fp32 taps that its bf16 products take, and the
wrapper's choice between the two staging paths. The kernel itself runs
only on the card (tests/test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch.experiments.common import TOL
from protoasnet_tpu_torch.ops.temporal_conv import split_bf16, split_tf32
from protoasnet_tpu_torch.ops.temporal_conv_cuda import staging_aligned

K = 3 * 576  # the longest sum of the trunk's temporal convs (layer3)


def round_tf32(v: torch.Tensor, ties: str) -> torch.Tensor:
    """fp32 -> the nearest TF32 (10 mantissa bits), ties away from zero (the
    kernel's ``cvt.rna.tf32.f32``) or to even, on the bits."""
    bits = v.contiguous().view(torch.int32)
    if ties == "away":
        bits = bits + 0x1000
    else:
        bits = bits + 0xFFF + ((bits >> 13) & 1)
    return (bits & -0x2000).view(torch.float32)


def _product_data(seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((64, K), np.float32))
    b = torch.from_numpy(rng.standard_normal((K, 64), np.float32) * 0.05)
    return a, b


def _rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def test_round_tf32_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 + 2 ** -20],
                     dtype=torch.float32)
    away = round_tf32(v, "away")
    even = round_tf32(v, "even")
    assert away.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                             1.0 + 2 ** -9, -(1.0 + 2 ** -10),
                             1.0 + 2 ** -10]
    # ties to even: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    assert even.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                 -1.0]
    assert (round_tf32(v, "away").view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("ties", ["away", "even"])
def test_3xtf32_keeps_fp32_accuracy(ties):
    """hi = tf32(v), lo = tf32(v - hi); lo*hi + hi*lo + hi*hi summed in
    float64 stays within 1e-6 of max |ref| at K = 3*576, well inside the
    fp32 limit, where one TF32 product misses it."""
    a, b = _product_data()
    ref = a.double() @ b.double()

    def split(v):
        hi = round_tf32(v, ties)
        return hi.double(), round_tf32(v - hi, ties).double()

    (ah, al), (bh, bl) = split(a), split(b)
    three = al @ bh + ah @ bl + ah @ bh
    assert _rel(three, ref) <= 1e-6
    assert _rel(ah @ bh, ref) > TOL[torch.float32]


def test_split_tf32_is_the_kernels_rounding():
    """The wrapper's TF32 split of the taps rounds as cvt.rna does (ties
    away), and hi + lo equals k to 2^-21 of |k|."""
    k = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 576, 256), np.float32) * 0.05)
    hi, lo = split_tf32(k)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, round_tf32(k, "away"))
    assert torch.equal(lo, round_tf32(k - hi, "away"))
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (k.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * k.double().abs()).all()


def test_bf16_split_of_fp32_taps():
    """k_hi + k_lo equals an fp32 k to 2^-16 of |k|, and k_lo is not all
    zero, so the kernel runs the second product."""
    k = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 576, 256), np.float32) * 0.05)
    hi, lo = split_bf16(k)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, k.to(torch.bfloat16))
    err = (k.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -16 * k.double().abs()).all()
    assert lo.any()
    # one bf16 alone is off by up to 2^-9 of |k|
    assert ((k.double() - hi.double()).abs().max()
            > 2.0 ** -16 * k.double().abs().max())


def test_bf16_split_of_bf16_taps_is_exact():
    k = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 45, 64), np.float32)).to(torch.bfloat16)
    hi, lo = split_bf16(k)
    assert torch.equal(hi, k)
    assert not lo.any()


# (c, o, elem, pointers, cp.async?): layer1's C=144 in bf16 (288 B rows)
# and fp32; the stem's C=45 (90 B / 180 B rows); an x view 2 or 4 bytes off
# a 16-byte boundary; O=65 (tap rows 130 B); layer3's 576 -> 256
STAGING = [(144, 64, 2, (0, 256), True), (144, 64, 4, (512, 256), True),
           (45, 64, 2, (0, 256), False), (45, 64, 4, (0, 256), False),
           (144, 64, 2, (2, 256), False), (144, 64, 4, (4, 256), False),
           (144, 65, 2, (0, 256), False), (576, 256, 2, (0, 256, 512), True),
           (576, 256, 2, (0, 256, 520), False)]


@pytest.mark.parametrize("c, o, elem, ptrs, aligned", STAGING)
def test_staging_path_choice(c, o, elem, ptrs, aligned):
    assert staging_aligned(c, o, elem, *ptrs) is aligned
