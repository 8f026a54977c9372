"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

pytestmark = pytest.mark.cuda

# (n, s, p, d): tiny, ragged (S, P, D off the kernel's tiles), D > 256
# (several d tiles in one block), and the flagship head at batch 4
SHAPES = [(2, 18, 6, 16), (3, 35, 13, 40), (2, 70, 9, 300),
          (4, 8 * 14 * 14, 40, 256)]


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
