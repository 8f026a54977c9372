"""The port's FLOP counter (``utils/flops.py``) against the JAX package's
jaxpr walk (``protoasnet_tpu/utils/flops.py``).

- The exact cases of ``tests/test_flops.py`` (matmul, batched matmul,
  2-D and 3-D convs, strided, depthwise/grouped, a backward's matmuls):
  the hand count and the JAX package's count on the same shapes.
- The three shipped models' forwards at batch 1 and full width, counted
  on the ``meta`` device (shapes only) with the plain heads. The flagship
  is pinned at 156,158,751,040 FLOP a clip: the JAX package's pin
  (156,565,176,640) less what its space-to-depth stem charges over the
  port's plain stem, worked out from the shapes. The image ProtoASNet and
  ProtoPNet, which have no stem rewrite, equal the JAX count.
- The hand kernels' FLOP reports (``kernel_flops``, called where the
  wrappers launch on the card) equal the counts of their plain versions
  on the CPU, so a count on the card equals one on the CPU.
- ``mfu`` arithmetic against the card's datasheet peaks; a card that is
  not in the table raises.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.utils.flops import count_flops as jax_count
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
from protoasnet_tpu_torch.utils.config import load_config
from protoasnet_tpu_torch.utils.flops import (PEAK_FLOPS, count_flops,
                                              flops_by_op, kernel_flops, mfu,
                                              peak_flops, summarize)

REPO = Path(__file__).resolve().parents[1]

H100 = "NVIDIA H100 80GB HBM3"
FLAGSHIP_PORT = 156_158_751_040
FLAGSHIP_JAX = 156_565_176_640  # tests/test_flops.py's pin


def _conv(x, w, stride, padding, groups=1):
    conv = F.conv3d if x.dim() == 5 else F.conv2d
    return conv(x, w, stride=stride, padding=padding, groups=groups)


def _jax_conv(stride, padding, groups=1):
    nd = len(stride)
    dn = (("NHWC", "HWIO", "NHWC") if nd == 2 else
          ("NDHWC", "DHWIO", "NDHWC"))
    return lambda x, w: jax.lax.conv_general_dilated(
        x, w, stride, padding, feature_group_count=groups,
        dimension_numbers=dn)


# (torch shapes NC..., weight O I k...; stride, torch padding, JAX padding,
#  groups; the hand count)
CONVS = {
    "conv2d_same": ((2, 3, 16, 16), (8, 3, 3, 3), (1, 1), 1, "SAME", 1,
                    2 * (2 * 16 * 16 * 8) * 3 * 9),
    "conv2d_strided_valid": ((1, 4, 17, 17), (6, 4, 3, 3), (2, 2), 0,
                             "VALID", 1, 2 * (1 * 8 * 8 * 6) * 4 * 9),
    "depthwise": ((1, 4, 8, 8), (4, 1, 3, 3), (1, 1), 1, "SAME", 4,
                  2 * (1 * 8 * 8 * 4) * 1 * 9),
    "grouped": ((1, 8, 8, 8), (6, 4, 3, 3), (1, 1), 1, "SAME", 2,
                2 * (1 * 8 * 8 * 6) * 4 * 9),
    "conv3d_same": ((1, 2, 4, 8, 8), (5, 2, 3, 3, 3), (1, 1, 1), 1, "SAME",
                    1, 2 * (1 * 4 * 8 * 8 * 5) * 2 * 27),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_exact(case):
    xs, ws, stride, pad, jpad, groups, want = CONVS[case]
    x, w = torch.zeros(xs), torch.zeros(ws)
    assert count_flops(_conv, x, w, stride, pad, groups) == want
    nd = len(ws) - 2
    jx = np.zeros((xs[0], *xs[2:], xs[1]), np.float32)
    jw = np.zeros((*ws[2:], ws[1], ws[0]), np.float32)
    assert jax_count(_jax_conv(stride, jpad, groups), jx, jw) == want, nd


@pytest.mark.parametrize("case", ["matmul", "batched", "backward"])
def test_matmul_exact(case):
    if case == "matmul":
        a, b = np.zeros((8, 64), np.float32), np.zeros((64, 32), np.float32)
        want = 2 * 8 * 64 * 32
        got = count_flops(torch.matmul, torch.from_numpy(a),
                          torch.from_numpy(b))
        ref = jax_count(lambda x, y: x @ y, a, b)
    elif case == "batched":
        a = np.zeros((4, 8, 16), np.float32)
        b = np.zeros((4, 16, 32), np.float32)
        want = 2 * 4 * 8 * 32 * 16
        got = count_flops(torch.einsum, "bij,bjk->bik", torch.from_numpy(a),
                          torch.from_numpy(b))
        ref = jax_count(lambda x, y: jnp.einsum("bij,bjk->bik", x, y), a, b)
    else:
        # the forward product and both of its backward products
        a, b = np.zeros((8, 16), np.float32), np.zeros((16, 8), np.float32)
        want = 3 * (2 * 8 * 16 * 8)
        ta = torch.zeros(8, 16, requires_grad=True)
        tb = torch.zeros(16, 8, requires_grad=True)
        got = count_flops(lambda: (ta @ tb).sum().backward())
        ref = jax_count(jax.grad(lambda x, y: (x @ y).sum(), argnums=(0, 1)),
                        a, b)
    assert got == want
    assert ref == want


def _cfg(name):
    return load_config(str(REPO / "protoasnet_tpu" / "configs"
                           / f"{name}.yml"))["model"]


def _port_forward_flops(cfg, shape):
    model = build_model(cfg, device="cpu").to("meta")
    model.head_impl = "torch"
    with torch.no_grad():
        return flops_by_op(lambda: model(torch.zeros(shape, device="meta")))


def _jax_forward_flops(cfg, shape):
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32), train=False))
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                       shapes)
    return jax_count(lambda v, x: model.apply(v, x, train=False)[0],
                     variables, jnp.zeros(shape, jnp.float32))


def test_flagship_forward_pinned_against_the_jax_count():
    cfg = dict(_cfg("ours_protoasnet_video"), img_size=112)
    by_op = _port_forward_flops(cfg, (1, 32, 112, 112, 3))
    assert sum(by_op.values()) == FLAGSHIP_PORT
    assert by_op == {"aten.convolution": 155_391_258_624,
                     "aten.addmm": 719_323_136, "aten.mm": 16_056_640,
                     "aten.bmm": 32_112_640}
    # the JAX stem: space-to-depth to 12 channels, a (1,4,4) conv over
    # them; the port's: the (1,7,7)/2 conv over 3 channels; the same
    # (1, 32, 56, 56, 45) output
    out = 1 * 32 * 56 * 56 * 45
    stem_diff = 2 * out * (12 * 4 * 4) - 2 * out * (3 * 7 * 7)
    assert stem_diff == 406_425_600
    jax_flops = _jax_forward_flops(cfg, (1, 32, 112, 112, 3))
    assert jax_flops == FLAGSHIP_JAX
    assert FLAGSHIP_PORT == jax_flops - stem_diff


@pytest.mark.parametrize("name", ["ours_protoasnet_image",
                                  "baseline_protopnet"])
def test_2d_forwards_equal_the_jax_count(name):
    cfg = dict(_cfg(name), img_size=224)
    port = sum(_port_forward_flops(cfg, (1, 224, 224, 3)).values())
    assert port == _jax_forward_flops(cfg, (1, 224, 224, 3))


@pytest.mark.parametrize("head", ["roi_cosine_cuda", "l2_min_cuda"])
def test_kernel_reports_equal_the_plain_heads(head):
    n, s, p, d = 3, 49, 8, 32
    g = torch.Generator().manual_seed(0)
    if head == "roi_cosine_cuda":
        args = (torch.rand(n, s, p, generator=g),
                torch.rand(n, s, d, generator=g), torch.rand(p, d,
                                                             generator=g))
        plain = count_flops(roi_cosine_torch, *args)
    else:
        args = (torch.rand(n, 7, 7, d, generator=g),
                torch.rand(p, 1, 1, d, generator=g))
        plain = count_flops(l2_min_torch, *args)
    # what the wrapper reports where it launches the kernel
    assert flops_by_op(kernel_flops, head, 2.0 * n * s * p * d) == \
        {head: plain}
    assert summarize(kernel_flops, head, 2.0 * n * s * p * d, per=n) == \
        {"flops": plain, "flops_per_item": plain / n}


def test_mfu_arithmetic_on_the_card_peaks():
    peaks = PEAK_FLOPS[H100]
    assert peaks == {"bf16": 989.4e12, "fp32": 494.7e12, "int8": 1979e12}
    assert peak_flops("bf16", H100) == 989.4e12
    assert mfu(1e12, 100.0, "bf16", H100) == pytest.approx(1e14 / 989.4e12)
    assert mfu(FLAGSHIP_PORT, 396.0, "bf16", H100) == pytest.approx(
        FLAGSHIP_PORT * 396.0 / 989.4e12)
    assert mfu(1e12, 100.0, "fp32", H100) == pytest.approx(
        2 * mfu(1e12, 100.0, "bf16", H100))


def test_a_card_not_in_the_table_raises():
    with pytest.raises(KeyError, match="no peak rate"):
        peak_flops("bf16", "TPU v5 lite")
    with pytest.raises(KeyError):
        mfu(1e12, 1.0, "bf16", "NVIDIA A100-SXM4-80GB")
