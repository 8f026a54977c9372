"""The port's CUDA kernels on the card, against their plain PyTorch
versions: ``roi_cosine_cuda`` (XProtoNet's head) and ``l2_min_cuda``
(ProtoPNet's head).

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

pytestmark = pytest.mark.cuda

# (n, s, p, d): tiny, ragged (S, P, D off the kernel's tiles), D > 256
# (several d tiles in one block), the flagship head at batch 4 and the
# image ProtoASNet head (7x7 positions, D=512) at batch 4
SHAPES = [(2, 18, 6, 16), (3, 35, 13, 40), (2, 70, 9, 300),
          (4, 8 * 14 * 14, 40, 256), (4, 7 * 7, 40, 512)]
# (n, s, p, d) for l2_min: ProtoPNet's head (S=49, P=30, D=512) at batch 8;
# S off the 64-row tile (49, 70, 130), P off the 32-prototype tile (30, 7,
# 33, 65), D = 1, 63 and 512, and N = 1
L2_SHAPES = [(8, 49, 30, 512), (1, 49, 30, 512), (3, 70, 7, 63),
             (2, 130, 33, 1), (2, 5, 65, 100), (1, 1, 1, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _data(shape, dev, seed=11):
    n, s, p, d = shape
    rng = np.random.default_rng(seed)
    occ = np.abs(rng.normal(size=(n, s, p))).astype(np.float32)
    feat = rng.normal(size=(n, s, d)).astype(np.float32)
    protos = rng.normal(size=(p, d)).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (occ, feat, protos))


def _check(occ, feat, protos):
    before = roi_cosine_cuda.launches
    roi, sim = roi_cosine_cuda(occ, feat, protos)
    torch.cuda.synchronize()
    assert roi_cosine_cuda.launches == before + 1
    assert roi.dtype == sim.dtype == torch.float32
    ref_roi, ref_sim = roi_cosine_torch(occ.double(), feat.double(),
                                        protos.double())
    # fp32 sums over S in another order than the float64 reference
    torch.testing.assert_close(roi.double(), ref_roi, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sim.double(), ref_sim, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(dev, shape, dtype):
    occ, feat, protos = _data(shape, dev)
    _check(occ.to(dtype), feat.to(dtype), protos)


def test_channels_last_maps_and_strided_inputs(dev):
    """(N, T, H, W, C) maps as the model gives them, and a non-contiguous
    feat that the wrapper must copy."""
    occ, feat, protos = _data((2, 2 * 3 * 5, 7, 24), dev)
    occ5 = occ.reshape(2, 2, 3, 5, 7)
    feat_t = feat.reshape(2, 2, 3, 5, 24).transpose(1, 2)
    assert not feat_t.is_contiguous()
    roi, sim = roi_cosine_cuda(occ5, feat_t, protos)
    ref_roi, ref_sim = roi_cosine_torch(occ5.double(), feat_t.double(),
                                        protos.double())
    torch.testing.assert_close(roi.double(), ref_roi, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sim.double(), ref_sim, rtol=1e-5, atol=1e-6)


def test_zero_occurrence_gives_half(dev):
    occ, feat, protos = _data((2, 18, 6, 16), dev)
    occ[0] = 0.0
    _, sim = roi_cosine_cuda(occ, feat, protos)
    torch.testing.assert_close(sim[0].cpu(), torch.full((6,), 0.5))


def test_kernel_refuses_bad_inputs(dev):
    occ, feat, protos = _data((2, 18, 6, 16), dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        roi_cosine_cuda(occ, feat, protos.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        roi_cosine_cuda(occ.half(), feat.half(), protos)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        roi_cosine_cuda(occ.bfloat16(), feat, protos)
    with pytest.raises(ValueError, match="do not agree"):
        roi_cosine_cuda(occ, feat, protos[:, :8])
    with pytest.raises(ValueError, match="feat on cpu"):
        roi_cosine_cuda(occ, feat.cpu(), protos)


def test_model_head_goes_through_the_kernel(dev):
    from protoasnet_tpu_torch.models.builder import build_model

    cfg = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4, "img_size": 32, "dtype": "float32"}
    model = build_model(cfg)  # CUDA by default
    assert next(model.parameters()).device.type == "cuda"
    x = torch.randn((2, 8, 32, 32, 3), device=dev)
    before = roi_cosine_cuda.launches
    with torch.inference_mode():
        logits, sim, _ = model(x)
        model.head_impl = "torch"
        logits_p, sim_p, _ = model(x)
    assert roi_cosine_cuda.launches == before + 1
    torch.testing.assert_close(sim, sim_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits, logits_p, rtol=1e-5, atol=1e-5)


def _l2_data(shape, dev, seed=12):
    """Sigmoid-range features and U(0,1) prototypes, as ProtoPNet's
    "regular" add-on and its init produce."""
    n, s, p, d = shape
    rng = np.random.default_rng(seed)
    x = 1.0 / (1.0 + np.exp(-rng.normal(size=(n, s, d))))
    w = rng.uniform(size=(p, 1, 1, d))
    return (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, w))


def _l2_check(x, w):
    before = l2_min_cuda.launches
    dist, min_d = l2_min_cuda(x, w)
    torch.cuda.synchronize()
    assert l2_min_cuda.launches == before + 1
    assert dist.dtype == min_d.dtype == torch.float32
    ref_dist, ref_min = l2_min_torch(x.double(), w.double())
    # fp32 cancellation error follows |x|^2 + |w|^2, not dist: sums of D
    # products are off by ~sqrt(D)*2^-24 of it (the smoke's tolerance)
    scale = float((x.double() ** 2).sum(-1).max()
                  + (w.double() ** 2).sum(-1).max())
    torch.testing.assert_close(dist.double(), ref_dist, rtol=0,
                               atol=1e-5 * scale)
    torch.testing.assert_close(min_d.double(), ref_min, rtol=0,
                               atol=1e-5 * scale)
    # the minimum of exactly the values the kernel wrote
    assert torch.equal(min_d, dist.reshape(len(x), -1, w.shape[0]).amin(1))


@pytest.mark.parametrize("shape", L2_SHAPES)
def test_l2_min_kernel_matches_plain(dev, shape):
    _l2_check(*_l2_data(shape, dev))


def test_l2_min_kernel_channels_last_and_bf16(dev):
    """(N, H, W, D) maps as PPNet gives them, a non-contiguous x, (P, D)
    prototypes, and bf16 features cast to fp32 by the wrapper."""
    x, w = _l2_data((2, 6 * 5, 9, 40), dev)
    x4 = x.reshape(2, 6, 5, 40).transpose(1, 2)
    assert not x4.is_contiguous()
    dist, min_d = l2_min_cuda(x4, w.reshape(9, 40))
    ref_dist, ref_min = l2_min_torch(x4.double(), w.double())
    assert tuple(dist.shape) == (2, 5, 6, 9)
    torch.testing.assert_close(dist.double(), ref_dist, rtol=0, atol=1e-4)
    torch.testing.assert_close(min_d.double(), ref_min, rtol=0, atol=1e-4)
    xb = x.to(torch.bfloat16)
    dist_b, _ = l2_min_cuda(xb, w)
    ref_b, _ = l2_min_torch(xb.double(), w.double())
    torch.testing.assert_close(dist_b.double(), ref_b, rtol=0, atol=1e-4)


def test_l2_min_kernel_empty_batch_and_nan(dev):
    x, w = _l2_data((2, 49, 30, 64), dev)
    before = l2_min_cuda.launches
    dist, min_d = l2_min_cuda(x[:0], w)
    assert tuple(dist.shape) == (0, 49, 30) and tuple(min_d.shape) == (0, 30)
    assert l2_min_cuda.launches == before  # nothing to launch
    x = x.clone()
    x[1, 7, 3] = float("nan")
    dist, min_d = l2_min_cuda(x, w)
    ref_dist, ref_min = l2_min_torch(x, w)
    assert torch.isnan(dist[1, 7]).all() and torch.isnan(min_d[1]).all()
    assert not torch.isnan(dist[0]).any()
    torch.testing.assert_close(min_d, ref_min, rtol=0, atol=1e-4,
                               equal_nan=True)


def test_l2_min_kernel_refuses_bad_inputs(dev):
    x, w = _l2_data((2, 49, 30, 64), dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        l2_min_cuda(x, w.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="forward-only"):
        l2_min_cuda(x.clone().requires_grad_(True), w)
    with pytest.raises(TypeError, match="computes in float32"):
        l2_min_cuda(x.double(), w)
    with pytest.raises(ValueError, match="must be"):
        l2_min_cuda(x, w.reshape(30, 64, 1, 1))
    with pytest.raises(ValueError, match="prototypes on cpu"):
        l2_min_cuda(x, w.cpu())
    with pytest.raises(ValueError, match="no positions"):
        l2_min_cuda(x[:, :0], w)


def test_ppnet_head_goes_through_the_kernel(dev):
    from protoasnet_tpu_torch.models.builder import build_model

    cfg = {"name": "ProtoPNet", "base_architecture": "resnet18",
           "prototype_shape": (6, 64, 1, 1), "num_classes": 3,
           "img_size": 64, "add_on_layers_type": "regular",
           "dtype": "float32"}
    model = build_model(cfg)  # CUDA by default
    assert next(model.parameters()).device.type == "cuda"
    x = torch.randn((2, 64, 64, 3), device=dev)
    before = l2_min_cuda.launches
    with torch.inference_mode():
        logits, min_d = model(x)
        _, dist = model.push_forward(x)
        model.head_impl = "torch"
        logits_p, min_p = model(x)
        _, dist_p = model.push_forward(x)
    assert l2_min_cuda.launches == before + 2
    assert tuple(dist.shape) == (2, 2, 2, 6)
    torch.testing.assert_close(min_d, min_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dist, dist_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(logits, logits_p, rtol=1e-5, atol=1e-4)


def test_image_xprotonet_head_goes_through_the_kernel(dev):
    from protoasnet_tpu_torch.models.builder import build_model

    cfg = {"name": "XProtoNet", "base_architecture": "resnet18",
           "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
           "img_size": 64, "dtype": "float32"}
    model = build_model(cfg)
    x = torch.randn((2, 64, 64, 3), device=dev)
    before = roi_cosine_cuda.launches
    with torch.inference_mode():
        logits, sim, occ = model(x)
        model.head_impl = "torch"
        logits_p, sim_p, _ = model(x)
    assert roi_cosine_cuda.launches == before + 1
    assert tuple(occ.shape) == (2, 2, 2, 8)
    torch.testing.assert_close(sim, sim_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits, logits_p, rtol=1e-5, atol=1e-5)
