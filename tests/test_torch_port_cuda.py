"""The port's CUDA kernels on the card, against their plain PyTorch
versions: ``roi_cosine_cuda`` (XProtoNet's head), ``l2_min_cuda``
(ProtoPNet's head), ``temporal_conv_cuda`` and ``fused_c2p1d_cuda`` (the
R(2+1)D block kernels).

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch.experiments.common import (TOL, max_rel_err,
                                                     no_tf32)
from protoasnet_tpu_torch.experiments.fused_c2p1d import unfused_reference
from protoasnet_tpu_torch.ops.fused_c2p1d import (fold_conv2plus1d,
                                                  fused_c2p1d_torch)
from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import (_lib as fused_lib,
                                                       device_tiling,
                                                       fused_c2p1d_cuda,
                                                       smem_bytes,
                                                       staging_aligned as
                                                       fused_aligned)
from protoasnet_tpu_torch.ops import l2_min_cuda as l2_mod
from protoasnet_tpu_torch.ops import roi_cosine_cuda as roi_mod
from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
from protoasnet_tpu_torch.ops.temporal_conv import (split_bf16,
                                                    temporal_conv_torch)
from protoasnet_tpu_torch.ops.temporal_conv_cuda import (staging_aligned,
                                                         taps_resident,
                                                         temporal_conv_cuda,
                                                         tile_rows)

pytestmark = pytest.mark.cuda

# (n, s, p, d): tiny, ragged (S off the 64/32-position stage, P off the
# 40-prototype block and its n8 tiles, D off the 128-wide tile), D=300 (a
# cluster of 3), the flagship head at batch 4 and the image ProtoASNet head
# (7x7 positions, D=512: a cluster of 4) at batch 4; then P=1, the pruned
# P=6 with D=65 at N=133 (more blocks than SMs), P=45 (two prototype
# blocks) at D=512, D=1100 (a cluster of 8 walking 9 d tiles), and the
# card tests' model heads (P=8, D=64: 16-byte rows, a partial prototype
# block) at S=32 and 4
SHAPES = [(2, 18, 6, 16), (3, 35, 13, 40), (2, 70, 9, 300),
          (4, 8 * 14 * 14, 40, 256), (4, 7 * 7, 40, 512), (1, 70, 1, 64),
          (133, 33, 6, 65), (3, 100, 45, 512), (2, 130, 40, 1100),
          (2, 32, 8, 64), (2, 4, 8, 64)]
# (n, s, p, d) for l2_min: ProtoPNet's head (S=49, P=30, D=512: clusters
# of 2 blocks of 256 d) at batch 8, 1 and 133 (more clusters than SMs); S
# off the 56-position tile (49, 57, 60, 70, 130, 200: four tiles), P off
# the 32-prototype block (30, 7, 33, 65), D = 1, 63, 65 and 100 (one block,
# warps without d), 700 (a cluster of 3, the last block's range partial),
# 1000 (of 4), 1500 (of 6) and 1700 (of 7), 2100 (of 5 blocks of 512 d:
# each warp stages two 32-wide chunks) and 4000 (of 8 blocks of 512 d)
L2_SHAPES = [(8, 49, 30, 512), (1, 49, 30, 512), (3, 70, 7, 63),
             (2, 130, 33, 1), (2, 5, 65, 100), (1, 1, 1, 1),
             (133, 49, 30, 512), (2, 200, 6, 1000), (1, 57, 32, 65),
             (2, 49, 30, 700), (1, 9, 5, 1500), (1, 9, 5, 1700),
             (2, 60, 30, 2100), (1, 20, 33, 4000)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 18, 6, 16), (2, 49, 40, 512)])
def test_zero_occurrence_gives_half(dev, shape, dtype):
    occ, feat, protos = _data(shape, dev)
    occ[0] = 0.0
    _, sim = roi_cosine_cuda(occ.to(dtype), feat.to(dtype), protos)
    torch.testing.assert_close(sim[0].cpu(), torch.full((shape[2],), 0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8 * 14 * 14, 40, 256),
                                   (3, 7 * 7, 40, 512)])
def test_kernel_on_views_off_16_bytes(dev, shape, dtype):
    """Contiguous occ and feat whose data_ptr() is one element past a
    16-byte boundary: the wrapper must take the element-wise staging
    path."""
    occ, feat, protos = _data(shape, dev)
    views = []
    for t in (occ, feat):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        views.append(v)
    assert not roi_mod.staging_aligned(views[0].element_size(), shape[2],
                                       shape[3], *(v.data_ptr()
                                                   for v in views))
    _check(*views, protos)


def _device_kernels(fn):
    """Names and counts of the kernels one call of ``fn`` runs on the
    device, from ``utils/profiling.py::device_window`` (as chip_smoke.py's
    kernel_device_ms), which raises ``EmptyDeviceWindow`` when the
    profiler dropped every device record of the window (ROADMAP.md §3, F4)
    instead of returning an empty table."""
    from protoasnet_tpu_torch.utils.profiling import device_window

    window = device_window(fn)
    assert window.launch_calls >= 1
    return window.kernels()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 7 * 7, 40, 512), (2, 32, 8, 64)])
def test_kernel_launches_one_kernel_per_call(dev, shape, dtype):
    """The prototype norms are computed inside the launch: one call on
    contiguous inputs runs one kernel on the device."""
    occ, feat, protos = _data(shape, dev)
    o, f = occ.to(dtype), feat.to(dtype)
    kernels = _device_kernels(lambda: roi_cosine_cuda(o, f, protos))
    assert list(kernels.values()) == [1] and \
        "roi_cosine_kernel" in next(iter(kernels)), kernels


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("shape, waves", [((128, 8 * 14 * 14, 40, 256), 1),
                                          ((128, 7 * 7, 40, 512), 2)])
def test_roi_plan_waves_on_the_card(dev, shape, waves, elem):
    """At the video head every cluster of the launch is resident at once;
    at the image head (clusters of 4, of which the card places fewer than
    four an SM) within two waves (the occupancy query, on this card)."""
    n, s, p, d = shape
    pl = roi_mod.plan(n, s, p, d, elem)
    clusters = pl.blocks // pl.cluster
    assert roi_mod.active_clusters(elem, s, pl.cluster) * waves >= clusters


def test_l2_plan_is_one_wave_on_the_card(dev):
    pl = l2_mod.plan(128, 30, 512)
    assert l2_mod.active_clusters(pl.cluster) >= 128


def test_roi_plan_matches_the_source(dev):
    """The wrapper's shared-memory plan mirrors the source's ring."""
    lib = roi_mod._lib()
    for elem in (2, 4):
        for s in (1, 49, 64, 65, 130, 1568):
            assert roi_mod.smem_bytes(elem, s) == \
                lib.roi_cosine_smem_bytes(int(elem == 2), s)


@pytest.mark.parametrize("shape", [(2, 18, 6, 16), (5, 8 * 14 * 14, 40, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gradient_matches_plain_head(dev, shape, dtype):
    """Inputs that require grad go through the Function: the CUDA forward
    (one launch) and ``roi_cosine_backward`` (one call); its gradients
    against the plain head's autograd, fp32 inputs in float64 (TF32 off,
    1e-5 of max |ref|), bf16 inputs on the same bf16 values (1e-2), with
    the cotangents in the primals' dtypes."""
    occ32, feat32, protos = _data(shape, dev)
    occ32 = occ32 * 0.05
    g = torch.Generator(device=dev).manual_seed(3)
    g_roi = torch.randn((shape[0], shape[2], shape[3]), device=dev,
                        generator=g) * 1e-3
    g_sim = torch.randn((shape[0], shape[2]), device=dev, generator=g)
    ref_dt = torch.float64 if dtype == torch.float32 else torch.float32
    leaves = [occ32.to(dtype), feat32.to(dtype), protos]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    launches = roi_cosine_cuda.launches
    calls = roi_cosine_cuda.backward_calls
    with no_tf32():
        roi, sim = roi_cosine_cuda(*leaves)
        ((roi * g_roi).sum() + (sim * g_sim).sum()).backward()
        ref_in = [t.detach().to(ref_dt).requires_grad_(True) for t in leaves]
        r_roi, r_sim = roi_cosine_torch(*ref_in)
        ((r_roi * g_roi.to(ref_dt)).sum()
         + (r_sim * g_sim.to(ref_dt)).sum()).backward()
    torch.cuda.synchronize()
    assert roi_cosine_cuda.launches == launches + 1
    assert roi_cosine_cuda.backward_calls == calls + 1
    assert [t.grad.dtype for t in leaves] == [dtype, dtype, torch.float32]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, t, r in zip(("occ", "feat", "protos"), leaves, ref_in):
        _, rel = max_rel_err(t.grad, r.grad)
        assert rel < tol, (name, rel)


def test_kernel_refuses_bad_inputs(dev):
    occ, feat, protos = _data((2, 18, 6, 16), dev)
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


def test_train_step_goes_through_the_kernel_and_its_gradient(dev):
    """A train step of the model on the card launches the kernel once (the
    main forward's head; the affine(x) pass computes only the occurrence
    map) and runs its backward once."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    cfg = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4, "img_size": 32, "dtype": "bfloat16"}
    model = build_model(cfg)
    opt = GroupAdam(model, {g: 1e-3 for g in GROUPS})
    step, _, _ = make_xprotonet_steps(
        model, LossBundle({"ClusterRoiFeat": {"loss_weight": 0.8},
                           "trans_occurrence": {"loss_weight": 0.1}},
                          num_classes=4, abstain_class=True),
        opt, GradAccumulator(opt.params, 1))
    before = model.prototype_vectors.detach().clone()
    launches = roi_cosine_cuda.launches
    calls = roi_cosine_cuda.backward_calls
    m = step(torch.randn((2, 8, 32, 32, 3), device=dev),
             torch.tensor([0, 2], device=dev),
             torch.tensor([True, True], device=dev),
             {g: 1e-3 for g in GROUPS}, affine=(7.0, 1.2))
    torch.cuda.synchronize()
    assert m["applied"] and torch.isfinite(m["loss_all"])
    assert roi_cosine_cuda.launches == launches + 1
    assert roi_cosine_cuda.backward_calls == calls + 1
    assert not torch.equal(model.prototype_vectors, before)


def test_train_step_sync_counter_equals_the_profilers_syncs(dev):
    """The flagship's bf16 micro-step at batch 5, traced by
    ``device_window``: the ``syncs`` its ``train.step`` spans count (the
    sync debug mode's warnings, ``utils/profiling.py::counting_syncs``)
    equal the runtime's ``cudaStreamSynchronize`` and
    ``cudaDeviceSynchronize`` calls the profiler recorded over the same
    micro-steps, less the window's own (its closing synchronize and the
    profiler's, counted in a window of one small kernel a call). On a
    difference the message names every call site the counter saw."""
    from collections import Counter
    from pathlib import Path

    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
    from protoasnet_tpu_torch.utils import profiling
    from protoasnet_tpu_torch.utils.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parents[1] /
                          "protoasnet_tpu/configs/ours_protoasnet_video.yml"))
    model = build_model(dict(cfg["model"], pretrained=False), device=dev,
                        seed=0)
    opt = GroupAdam(model, {g: 1e-4 for g in GROUPS})
    step = make_xprotonet_steps(
        model, LossBundle(cfg["train"]["criterion"], num_classes=4,
                          abstain_class=True),
        opt, GradAccumulator(opt.params, 2))[0]
    x = torch.randn((5, 32, 112, 112, 3), device=dev)
    target = torch.tensor([0, 1, 2, 0, 1], device=dev)
    valid = torch.ones(5, dtype=torch.bool, device=dev)
    lrs = {g: 1e-4 for g in GROUPS}
    affine = (torch.tensor(7.0), torch.tensor(1.2))  # as the bench stages
    iters = 4  # two Adam updates

    def runtime_syncs(fn):
        window = profiling.device_window(fn, iters=iters, warmup=1)
        calls = window.host_counts(("cudaStreamSynchronize",
                                    "cudaDeviceSynchronize"))
        return round(sum(calls.values()) * iters), calls

    profiling.reset()
    try:
        own, _ = runtime_syncs(lambda: torch.ones(8, device=dev).add_(1))
        total, calls = runtime_syncs(
            lambda: step(x, target, valid, lrs, affine=affine))
        steps = [s for s in profiling.spans() if s["name"] == "train.step"]
    finally:
        profiling.reset()
    counted = sum(s["counts"].get("syncs", 0) for s in steps)
    sites = Counter(site for s in steps for site in s["sites"])
    assert len(steps) == iters
    assert counted == total - own, (
        f"the counter saw {counted} syncs in {iters} micro-steps, the "
        f"profiler {total} ({calls} per call) less the window's own {own}; "
        f"the counter's call sites: {dict(sites)}")
    print(f"syncs per micro-step {counted / iters:g}; call sites "
          f"{dict(sites)}")


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


@pytest.mark.parametrize("where", ["x", "w"])
def test_l2_min_kernel_nan_in_one_block_of_the_cluster(dev, where):
    """At ProtoPNet's head (clusters of 2 blocks of 256 d, 32 d a warp): a
    NaN in the second block's d range (its third warp's) reaches that
    position's (or prototype's) distances and minima, and nothing else."""
    x, w = _l2_data((2, 49, 30, 512), dev)
    x, w = x.clone(), w.clone()
    if where == "x":
        x[1, 20, 256 + 2 * 32 + 3] = float("nan")
    else:
        w[4, 0, 0, 256 + 2 * 32 + 3] = float("nan")
    dist, min_d = l2_min_cuda(x, w)
    nan = torch.isnan(dist)
    if where == "x":
        assert nan[1, 20].all() and nan.sum() == 30
        assert torch.isnan(min_d[1]).all() and not torch.isnan(min_d[0]).any()
    else:
        assert nan[:, :, 4].all() and nan.sum() == 2 * 49
        assert torch.isnan(min_d[:, 4]).all() and torch.isnan(min_d).sum() == 2
    assert torch.equal(min_d.nan_to_num(-1.0),
                       dist.amin(1).nan_to_num(-1.0))
    # as _l2_check: against float64 within 1e-5 of |x|^2 + |w|^2
    ref_dist, _ = l2_min_torch(x.double(), w.double())
    scale = float((x.double() ** 2).nansum(-1).max()
                  + (w.double() ** 2).nansum(-1).max())
    torch.testing.assert_close(dist.double(), ref_dist, rtol=0,
                               atol=1e-5 * scale, equal_nan=True)


def test_l2_min_kernel_on_a_view_off_16_bytes(dev):
    """A contiguous x one element past a 16-byte boundary: element-wise
    staging."""
    x, w = _l2_data((8, 49, 30, 512), dev)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0
    assert not l2_mod.staging_aligned(512, xv.data_ptr(), 0)
    _l2_check(xv, w)


def test_l2_min_kernel_launches_one_kernel_per_call(dev):
    """|w|^2 is computed inside the launch: one call on contiguous fp32
    inputs runs one kernel on the device."""
    x, w = _l2_data((8, 49, 30, 512), dev)
    kernels = _device_kernels(lambda: l2_min_cuda(x, w))
    assert list(kernels.values()) == [1] and \
        "l2_min_kernel" in next(iter(kernels)), kernels


def test_l2_plan_matches_the_source(dev):
    assert l2_mod.SMEM == l2_mod._lib().l2_min_smem_bytes()


@pytest.mark.parametrize("shape", [(20, 49, 30, 512), (3, 70, 7, 63)])
def test_l2_min_kernel_gradient_matches_backward(dev, shape):
    """Inputs that require grad go through ``L2MinFunction``: the CUDA
    forward (one launch) and ``l2_min_backward`` (one call). Its fp32
    cotangents against ``l2_min_backward`` in float64 on the same inputs
    and the kernel's distances (1e-5 of max |ref|), and, with no ties in
    these inputs, against the plain head's float64 autograd; the
    prototypes' gradient in their (P, 1, 1, D) shape."""
    from protoasnet_tpu_torch.ops.l2_min import l2_min_backward

    n, s, p, d = shape
    x, w = _l2_data(shape, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    g_dist = torch.randn((n, s, p), device=dev, generator=g)
    g_min = torch.randn((n, p), device=dev, generator=g)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    launches = l2_min_cuda.launches
    calls = l2_min_cuda.backward_calls
    with no_tf32():
        dist, min_d = l2_min_cuda(xr, wr)
        ((dist * g_dist).sum() + (min_d * g_min).sum()).backward()
        ref_x, ref_w = l2_min_backward(x.double(), w.double().reshape(p, d),
                                       dist.detach(), g_dist.double(),
                                       g_min.double())
        x64 = x.double().requires_grad_(True)
        w64 = w.double().requires_grad_(True)
        r_dist, r_min = l2_min_torch(x64, w64)
        ((r_dist * g_dist.double()).sum()
         + (r_min * g_min.double()).sum()).backward()
    torch.cuda.synchronize()
    assert l2_min_cuda.launches == launches + 1
    assert l2_min_cuda.backward_calls == calls + 1
    assert xr.grad.dtype == wr.grad.dtype == torch.float32
    assert wr.grad.shape == w.shape
    for got, ref in ((xr.grad, ref_x), (wr.grad, ref_w.reshape(w.shape)),
                     (xr.grad, x64.grad), (wr.grad, w64.grad)):
        _, rel = max_rel_err(got, ref)
        assert rel < 1e-5, rel


def test_ppnet_train_step_goes_through_the_kernel_and_its_gradient(dev):
    """A ProtoPNet train step on the card launches the kernel once and
    runs its backward once; the prototypes move."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_protopnet_steps

    cfg = {"name": "ProtoPNet", "base_architecture": "resnet18",
           "prototype_shape": (6, 64, 1, 1), "num_classes": 3,
           "img_size": 64, "add_on_layers_type": "regular",
           "dtype": "float32"}
    model = build_model(cfg)
    opt = GroupAdam(model, {g: 1e-3 for g in GROUPS})
    step, _, _ = make_protopnet_steps(
        model, LossBundle({"CeLoss": {"loss_weight": 1},
                           "ClusterPatch": {"loss_weight": 0.8},
                           "SeparationPatch": {"loss_weight": 0.08}},
                          num_classes=3, abstain_class=False),
        opt, GradAccumulator(opt.params, 1))
    before = model.prototype_vectors.detach().clone()
    launches = l2_min_cuda.launches
    calls = l2_min_cuda.backward_calls
    m = step(torch.randn((2, 64, 64, 3), device=dev),
             torch.tensor([0, 2], device=dev),
             torch.tensor([True, True], device=dev),
             {g: 1e-3 for g in GROUPS})
    torch.cuda.synchronize()
    assert m["applied"] and torch.isfinite(m["loss_all"])
    assert l2_min_cuda.launches == launches + 1
    assert l2_min_cuda.backward_calls == calls + 1
    assert not torch.equal(model.prototype_vectors, before)


def test_l2_min_kernel_refuses_bad_inputs(dev):
    x, w = _l2_data((2, 49, 30, 64), dev)
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


# (b, t, s, c, o) for temporal_conv: tiny; the stem's C=45 -> 64 (rows of
# 90 / 180 bytes: element-wise staging); T=1 with S off the position tile,
# C off the channel chunk and O off the 64-output tile; C = O = 1; layer1's
# C=144 -> 64 at S=130 (288 / 576-byte rows: cp.async staging); layer3's
# 576 -> 256 at S=20 (four output tiles). Then 136 blocks of 64 positions
# (the wide tile, on a card of up to 136 SMs, ``WIDE``): taps resident
# (C=48, 45, and 144 in bf16) and, at C=576 (and 144 in fp32), in chunks
TEMPORAL_SHAPES = [(2, 4, 16, 8, 8), (2, 5, 100, 45, 64), (3, 1, 70, 33, 65),
                   (1, 2, 3, 1, 1), (2, 3, 130, 144, 64),
                   (2, 3, 20, 576, 256), (8, 3, 1088, 48, 64),
                   (8, 3, 1085, 45, 64), (8, 2, 1088, 144, 64),
                   (8, 2, 1088, 576, 64)]
WIDE = {(8, 3, 1088, 48, 64): (True, True), (8, 3, 1085, 45, 64): (True, True),
        (8, 2, 1088, 144, 64): (True, False),
        (8, 2, 1088, 576, 64): (False, False)}  # resident in (bf16, fp32)
# (b, t, h, w, c, cm, co) for fused_c2p1d: the JAX script's small shape;
# T=1 on a 5x7 image; W > 64 (several column tiles), Cm and Co off the
# tiles; Cm=300 and 576 split across many blocks; layer1's block at B=1,
# T=4; layer2's and layer3's blocks at B=1 and full T (Cm split in 3 / 5+);
# Cm=200 split with a partial last slice, Co=48 (one partial output pass)
FUSED_SHAPES = [(2, 6, 8, 8, 16, 24, 16), (1, 1, 5, 7, 3, 10, 4),
                (2, 3, 9, 70, 5, 33, 65), (1, 3, 7, 7, 8, 300, 8),
                (1, 2, 14, 14, 16, 576, 16), (1, 4, 56, 56, 64, 144, 64),
                (1, 16, 28, 28, 128, 288, 128), (1, 8, 14, 14, 256, 576, 256),
                (2, 3, 10, 12, 32, 200, 48)]


def _temporal_data(shape, dev, dtype, seed=13):
    b, t, s, c, o = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, s, c)).astype(np.float32)
    k = (rng.normal(size=(3, c, o)) * 0.05).astype(np.float32)
    return (torch.from_numpy(a).to(dev, dtype) for a in (x, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TEMPORAL_SHAPES)
def test_temporal_kernel_matches_plain(dev, shape, dtype):
    x, k = _temporal_data(shape, dev, dtype)
    before = temporal_conv_cuda.launches
    y = temporal_conv_cuda(x, k)
    torch.cuda.synchronize()
    assert temporal_conv_cuda.launches == before + 1
    assert y.dtype == dtype and tuple(y.shape) == shape[:3] + (shape[4],)
    ref = (temporal_conv_torch(x.double(), k.double())
           if dtype == torch.float32 else temporal_conv_torch(x, k))
    _, rel = max_rel_err(y, ref)
    assert rel <= TOL[dtype], rel


def test_temporal_kernel_refuses_bad_inputs(dev):
    x, k = _temporal_data((2, 3, 10, 4, 6), dev, torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        temporal_conv_cuda(x, k.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        temporal_conv_cuda(x.double(), k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        temporal_conv_cuda(x.half(), k)
    with pytest.raises(ValueError, match="must be"):
        temporal_conv_cuda(x[0, 0], k)
    with pytest.raises(ValueError, match="must be"):
        temporal_conv_cuda(x, k[:, :3])
    with pytest.raises(ValueError, match="k on cpu"):
        temporal_conv_cuda(x, k.cpu())


def test_temporal_dispatcher_launches_the_kernel(dev):
    """The wrapper sends CUDA tensors to the kernel, (B, T, H, W, C) maps
    included; an fp32 tap with bf16 x is exact in the kernel's fp32 sums."""
    x, k = _temporal_data((2, 3, 20, 6, 5), dev, torch.float32)
    before = temporal_conv_cuda.launches
    y5 = temporal_conv_cuda(x.reshape(2, 3, 4, 5, 6), k)
    assert temporal_conv_cuda.launches == before + 1
    assert tuple(y5.shape) == (2, 3, 4, 5, 5)
    ref = temporal_conv_torch(x.double(), k.double())
    assert max_rel_err(y5.reshape(2, 3, 20, 5), ref)[1] <= 1e-5
    xb = x.bfloat16()
    assert split_bf16(k)[1].any()  # the kernel runs the k_lo product
    assert max_rel_err(temporal_conv_cuda(xb, k),
                       temporal_conv_torch(xb, k))[1] <= 1e-2


def _hold_temporal(x, k):
    """The kernel against float64 (fp32 x) or the plain version on the same
    inputs (bf16 x), at ``TOL``."""
    before = temporal_conv_cuda.launches
    y = temporal_conv_cuda(x, k)
    torch.cuda.synchronize()
    assert temporal_conv_cuda.launches == before + 1
    ref = (temporal_conv_torch(x.double(), k.double())
           if x.dtype == torch.float32 else temporal_conv_torch(x, k))
    _, rel = max_rel_err(y, ref)
    assert rel <= TOL[x.dtype], rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 130, 144, 64), (2, 5, 100, 45, 64),
                                   (8, 2, 1088, 144, 64)])
def test_temporal_kernel_on_a_view_off_16_bytes(dev, shape, dtype):
    """A contiguous x whose data_ptr() is one element past a 16-byte
    boundary: the wrapper must take the element-wise staging path."""
    x, k = _temporal_data(shape, dev, dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    assert not staging_aligned(shape[3], shape[4], xv.element_size(),
                               xv.data_ptr())
    _hold_temporal(xv, k)


@pytest.mark.parametrize("shape", [(2, 3, 20, 576, 256), (2, 5, 100, 45, 64),
                                   (2, 3, 130, 144, 64), (8, 2, 1088, 144, 64),
                                   (8, 2, 1088, 576, 64)])
def test_temporal_kernel_fp32_taps_with_bf16_x(dev, shape):
    """fp32 taps with bf16 x: k_hi + k_lo, two bf16 products, against the
    plain version's fp32 taps."""
    x, k = _temporal_data(shape, dev, torch.float32)
    assert split_bf16(k)[1].any()
    _hold_temporal(x.bfloat16(), k)


def test_temporal_tile_rows(dev):
    """64 positions per block unless that leaves SMs without a block."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tile_rows(8, 64 * sms, 64) == 64
    assert tile_rows(8, 64 * (sms // 8) - 64, 64) == 32
    assert tile_rows(8, 3136, 64) == 64  # layer1: 392 blocks


@pytest.mark.parametrize("shape", list(WIDE))
def test_temporal_taps_resident(dev, shape):
    """The taps stay in shared memory where they fit beside two x frames
    (the wide shapes above; at layer1's C=144 in bf16, not in fp32's two
    arrays), never at the narrow tile, and k_lo's second array counts."""
    b, _, s, c, o = shape
    assert tile_rows(b, s, o) == 64
    bf16, fp32 = WIDE[shape]
    assert taps_resident(torch.bfloat16, False, b, s, c, o) is bf16
    assert taps_resident(torch.float32, True, b, s, c, o) is fp32
    assert taps_resident(torch.bfloat16, True, b, s, 144, o)  # 163 KB
    assert not taps_resident(torch.bfloat16, False, 1, 20, c, o)


def _fused_data(shape, dev, dtype, seed=14):
    b, t, h, w, c, cm, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, w, c)).astype(np.float32)
    ks = (rng.normal(size=(3, 3, c, cm)) * 0.05).astype(np.float32)
    kt = (rng.normal(size=(3, cm, co)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=cm).astype(np.float32)
    shift = (rng.normal(size=cm) * 0.1).astype(np.float32)
    x, ks, kt = (torch.from_numpy(a).to(dev, dtype) for a in (x, ks, kt))
    return x, ks, torch.from_numpy(scale).to(dev), \
        torch.from_numpy(shift).to(dev), kt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_kernel_matches_plain(dev, shape, dtype):
    args = _fused_data(shape, dev, dtype)
    before = fused_c2p1d_cuda.launches
    out = fused_c2p1d_cuda(*args)
    torch.cuda.synchronize()
    assert fused_c2p1d_cuda.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == shape[:4] + (shape[6],)
    ref = (fused_c2p1d_torch(*(a.double() for a in args))
           if dtype == torch.float32 else fused_c2p1d_torch(*args))
    _, rel = max_rel_err(out, ref)
    assert rel <= TOL[dtype], rel


def test_fused_kernel_pads_mid_with_zeros(dev):
    """A positive shift makes relu(shift) != 0: the frames outside [0, T)
    must still add nothing (the unfused cuDNN sequence in float64)."""
    x, ks, scale, shift, kt = _fused_data((2, 2, 6, 5, 4, 12, 8), dev,
                                          torch.float32)
    shift = shift.abs() + 1.0
    out = fused_c2p1d_cuda(x, ks, scale, shift, kt)
    ref = unfused_reference(ks.double(), scale.double(), shift.double(),
                            kt.double(), torch.float64)(x.double())
    assert max_rel_err(out, ref)[1] <= 1e-5


def test_fused_tile_positions(dev):
    """The wrapper's tiling: its shared memory is the kernel's own count,
    and every flagship block shape at B=8 fills the card's SMs."""
    from protoasnet_tpu_torch.experiments.fused_c2p1d import BLOCKS

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t, h, w, c, cm, co in BLOCKS.values():
        for dtype, two in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, True)):
            x = torch.empty((8, 1, h, w, c), dtype=dtype, device=dev)
            tl = device_tiling(x, cm, two)
            assert tl.blocks >= sms, tl
            assert tl.smem == fused_lib().fused_c2p1d_smem_bytes(
                int(dtype == torch.bfloat16), int(two), tl.th, tl.tw,
                tl.slice)
            assert tl.smem == smem_bytes(x.element_size(), two, tl.th, tl.tw,
                                         tl.slice)


def test_fused_kernel_refuses_bad_inputs(dev):
    x, ks, scale, shift, kt = _fused_data((1, 2, 4, 4, 3, 6, 5), dev,
                                          torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_c2p1d_cuda(x, ks.clone().requires_grad_(True), scale, shift, kt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_c2p1d_cuda(x.double(), ks, scale, shift, kt)
    with pytest.raises(ValueError, match="must be"):
        fused_c2p1d_cuda(x[0], ks, scale, shift, kt)
    with pytest.raises(ValueError, match="do not agree"):
        fused_c2p1d_cuda(x, ks, scale[:4], shift, kt)
    with pytest.raises(ValueError, match="scale on cpu"):
        fused_c2p1d_cuda(x, ks, scale.cpu(), shift, kt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_c2p1d_cuda(x.half(), ks, scale, shift, kt)
    # a Cm far past one block's shared memory is split across blocks
    args = _fused_data((1, 2, 4, 4, 1, 20000, 2), dev, torch.float32)
    out = fused_c2p1d_cuda(*args)
    ref = fused_c2p1d_torch(*(a.double() for a in args))
    assert max_rel_err(out, ref)[1] <= TOL[torch.float32]


def test_fused_dispatcher_and_fold_on_the_card(dev):
    """A port Conv2Plus1D folded: the wrapper launches the kernel, which
    agrees with the module's own eval forward (fp32, TF32 off)."""
    from protoasnet_tpu_torch.models.backbones.r2plus1d import Conv2Plus1D

    torch.manual_seed(0)
    module = Conv2Plus1D(16, 16).to(dev).eval()
    with torch.no_grad():
        bn = module.bn_mid
        bn.running_mean.normal_(0.0, 0.2)
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0.0, 0.2)
    x = torch.randn((2, 5, 9, 11, 16), device=dev)
    before = fused_c2p1d_cuda.launches
    with no_tf32(), torch.inference_mode():
        out = fused_c2p1d_cuda(x, *fold_conv2plus1d(module))
        ref = module(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert fused_c2p1d_cuda.launches == before + 1
    assert max_rel_err(out, ref)[1] <= 1e-5


def _hold_fused(args):
    """The kernel against float64 (fp32 x) or the plain version on the same
    inputs (bf16 x), at ``TOL``."""
    x = args[0]
    before = fused_c2p1d_cuda.launches
    out = fused_c2p1d_cuda(*args)
    torch.cuda.synchronize()
    assert fused_c2p1d_cuda.launches == before + 1
    ref = (fused_c2p1d_torch(*(a.double() for a in args))
           if x.dtype == torch.float32 else fused_c2p1d_torch(*args))
    _, rel = max_rel_err(out, ref)
    assert rel <= TOL[x.dtype], rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 56, 56, 64, 144, 64),
                                   (2, 3, 9, 70, 16, 33, 64)])
def test_fused_kernel_on_a_view_off_16_bytes(dev, shape, dtype):
    """A contiguous x whose data_ptr() is one element past a 16-byte
    boundary: the wrapper must take the element-wise staging path."""
    x, *rest = _fused_data(shape, dev, dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    assert not fused_aligned(xv.element_size(), *shape[4:], xv.data_ptr())
    _hold_fused((xv, *rest))


@pytest.mark.parametrize("shape", [(1, 4, 56, 56, 64, 144, 64),
                                   (1, 8, 14, 14, 256, 576, 256),
                                   (1, 1, 5, 7, 3, 10, 4)])
def test_fused_kernel_fp32_taps_with_bf16_x(dev, shape):
    """fp32 taps with bf16 x: k_hi + k_lo in both GEMMs, against the plain
    version's fp32 taps."""
    x, ks, scale, shift, kt = _fused_data(shape, dev, torch.float32)
    assert split_bf16(ks)[1].any() and split_bf16(kt)[1].any()
    _hold_fused((x.bfloat16(), ks, scale, shift, kt))


def test_explain_sweep_goes_through_the_kernel(dev):
    """``collect_model_products`` on the card launches the ROI kernel once
    per batch, and its products equal the plain head's (fp32)."""
    from types import SimpleNamespace

    from protoasnet_tpu_torch.explain.local import collect_model_products
    from protoasnet_tpu_torch.models.builder import build_model

    cfg = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4, "img_size": 32, "dtype": "float32"}
    model = build_model(cfg).eval()
    rng = np.random.default_rng(21)
    batches = [{"cine": torch.from_numpy(rng.normal(
                    size=(3, 8, 32, 32, 3)).astype(np.float32)).to(dev),
                "valid": np.array([True, True, b == 0]),
                "target_AS": np.array([0, 1, 2]),
                "filename": [f"c{b}{i}" for i in range(3)]}
               for b in range(2)]
    agent = SimpleNamespace(model=model, push_step=model.push_forward,
                            data_loaders={"test": batches})
    before = roi_cosine_cuda.launches
    with no_tf32():
        got = collect_model_products(agent, "test")
        assert roi_cosine_cuda.launches == before + 2
        model.head_impl = "torch"
        plain = collect_model_products(agent, "test")
    assert got["similarities"].shape == (5, 8)
    for key in ("similarities", "logits", "occurrence_maps"):
        np.testing.assert_allclose(got[key], plain[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("config, kernel", [
    ("ours_protoasnet_video.yml", "roi_cosine_cuda"),
    ("baseline_protopnet.yml", "l2_min_cuda")])
def test_exported_bundle_served_with_each_head_kernel(dev, tmp_path, config,
                                                      kernel):
    """A tiny run trained on the card, exported by ``serve export`` and
    served by ``server.serve_forever``: the served logits equal the
    agent's eval step, and the head's kernel launched while serving."""
    import io
    import threading
    import urllib.request
    from pathlib import Path

    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from protoasnet_tpu_torch.main import main as train_main
    from protoasnet_tpu_torch.serve import export_run

    counter = {"roi_cosine_cuda": roi_cosine_cuda,
               "l2_min_cuda": l2_min_cuda}[kernel]
    video = kernel == "roi_cosine_cuda"
    csv = make_synthetic_dataset(str(tmp_path / "data"), num_videos=12,
                                 seed=3)
    size = (("--data.img_size=32", "--data.frames=8",
             "--model.prototype_shape=(8, 64, 1, 1, 1)") if video else
            ("--data.img_size=64", "--model.prototype_shape=(6, 32, 1, 1)"))
    repo = Path(__file__).resolve().parents[1]
    agent = train_main([
        f"--config_path={repo / 'protoasnet_tpu' / 'configs' / config}",
        f"--save_dir={tmp_path / 'runs'}", f"--data.data_info_file={csv}",
        *size, "--model.dtype=float32", "--model.pretrained=false",
        "--train.batch_size=4", "--data.eval_batch_size=8",
        "--train.num_train_epochs=1", "--train.num_warm_epochs=0",
        "--train.push_start=99", "--data.num_workers=1"])
    out = str(tmp_path / "b.zip")
    agent, shape = export_run(agent.save_dir, out)
    ready, stop = threading.Event(), threading.Event()
    counter.launches = 0
    t = threading.Thread(
        target=server.serve_forever, args=(out,),
        kwargs=dict(host="127.0.0.1", port=0, max_batch=4, max_delay_ms=5.0,
                    warmup=False, ready_event=ready, stop_event=stop,
                    device=dev), daemon=True)
    t.start()
    x = np.random.default_rng(22).normal(size=(4, *shape)).astype(np.float32)
    try:
        assert ready.wait(120), "server did not bind"
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(
            f"http://127.0.0.1:{ready.port}/v1/predict",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served = np.load(io.BytesIO(r.read()))
    finally:
        stop.set()
        t.join(60)
    assert counter.launches > 0
    eval_step = agent._steps_for("default")[1]  # staged: joint's
    m = eval_step(torch.from_numpy(x).to(dev),
                        torch.zeros(4, dtype=torch.long, device=dev),
                        torch.ones(4, dtype=torch.bool, device=dev))
    np.testing.assert_allclose(served, m["logits"].float().cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


LIVE_CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
            "backbone_last_layer_num": -3,
            "prototype_shape": (8, 64, 1, 1, 1), "num_classes": 4,
            "img_size": 32, "dtype": "float32"}
LIVE_SAMPLE = (8, 32, 32, 3)


def _live_bundles(tmp_path):
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import save_serving_bundle

    paths = []
    for seed in (1, 2):
        path = str(tmp_path / f"b{seed}.zip")
        save_serving_bundle(path, build_model(LIVE_CFG, device="cpu",
                                              seed=seed),
                            LIVE_CFG, LIVE_SAMPLE)
        paths.append(path)
    return paths


def test_reload_warms_up_on_a_side_stream(dev, tmp_path):
    """``server.Reloader`` on the card: the new weights load and every
    bucket runs once on the reloader thread on a stream of its own (the
    ROI kernel launching there), while the dispatch thread keeps the
    default stream; after the swap the batcher serves the new bundle's
    logits. A second reload warms up on the same stream."""
    import threading
    import time

    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.serve import load_serving_bundle

    paths = _live_bundles(tmp_path)
    calls = []
    default = torch.cuda.default_stream(dev).cuda_stream

    def build(target, int8):
        fn = load_serving_bundle(target, dev)

        def traced(x):
            calls.append((threading.current_thread().name, len(x),
                          torch.cuda.current_stream(dev).cuda_stream))
            return fn(x)

        return traced, LIVE_SAMPLE, np.float32

    def reload(r, path):
        assert r.request(path, None)[0] == 202
        deadline = time.time() + 300
        while r.status()["state"] not in ("serving", "error") and \
                time.time() < deadline:
            time.sleep(0.01)
        assert r.status()["state"] == "serving", r.status()

    b = server.DynamicBatcher(load_serving_bundle(paths[0], dev),
                              max_batch=2, max_delay_ms=1.0,
                              sample_shape=LIVE_SAMPLE)
    try:
        r = server.Reloader(b, build, root=str(tmp_path), device=dev)
        before = roi_cosine_cuda.launches
        reload(r, paths[1])
        side = calls[0][2]
        assert side != default
        assert calls == [("reloader", 1, side), ("reloader", 2, side)]
        assert roi_cosine_cuda.launches >= before + 2
        x = np.random.default_rng(30).normal(
            size=(2, *LIVE_SAMPLE)).astype(np.float32)
        got = b.submit(x, timeout=300)
        assert calls[-1] == ("batcher-dispatch", 2, default)
        reload(r, paths[0])
        assert calls[-2:] == [("reloader", 1, side), ("reloader", 2, side)]
    finally:
        b.close()
    np.testing.assert_array_equal(got, load_serving_bundle(paths[1], dev)(x))


def test_batcher_serves_from_pinned_host_buffers(dev, tmp_path):
    """A card's serving function offers pinned host memory
    (``host_buffer``), the batcher builds its buckets there, and the logits
    it serves from them equal a direct call on the same clips, exactly."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.serve import load_serving_bundle

    fn = load_serving_bundle(_live_bundles(tmp_path)[0], dev)
    buf = fn.host_buffer((3, *LIVE_SAMPLE), np.float32)
    assert buf.shape == (3, *LIVE_SAMPLE) and buf.dtype == np.float32
    assert torch.from_numpy(buf).is_pinned()
    seen = []

    def traced(x):
        seen.append(torch.from_numpy(x).is_pinned())
        return fn(x)

    traced.host_buffer = fn.host_buffer
    b = server.DynamicBatcher(traced, max_batch=2, max_delay_ms=1.0,
                              sample_shape=LIVE_SAMPLE)
    x = np.random.default_rng(31).normal(
        size=(4, *LIVE_SAMPLE)).astype(np.float32)
    try:
        got = b.submit_many(x, timeout=300)
    finally:
        b.close()
    assert seen == [True, True]
    np.testing.assert_array_equal(got, np.concatenate([fn(x[:2]),
                                                       fn(x[2:])]))


def test_batcher_serves_sharded_from_pinned_slices(dev, tmp_path):
    """Sharded over every local card (card 0 twice where it is the only
    one), each shard of an even split is a pinned row slice of the
    batcher's buffer; a bucket that does not split is padded; the logits
    equal a direct call of the sharded function on the same rows."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.serve import (load_bundle_model,
                                            make_sharded_serving_fn)

    n = torch.cuda.device_count()
    devices = [f"cuda:{i % n}" for i in range(max(2, n))]
    model = load_bundle_model(_live_bundles(tmp_path)[0], dev)[0]
    fn = make_sharded_serving_fn(model, devices)
    seen = []

    def traced(x):
        k = -(-len(x) // len(devices))
        seen.append((len(x), [torch.from_numpy(x[i:i + k]).is_pinned()
                              for i in range(0, len(x), k)]))
        return fn(x)

    traced.host_buffer = fn.host_buffer
    b = server.DynamicBatcher(traced, max_batch=8, buckets=(3, 8),
                              max_delay_ms=1.0, sample_shape=LIVE_SAMPLE)
    x = np.random.default_rng(32).normal(
        size=(11, *LIVE_SAMPLE)).astype(np.float32)
    try:
        got = b.submit_many(x, timeout=300)
    finally:
        b.close()
    assert [(m, all(p)) for m, p in seen] == [(8, True), (3, True)]
    np.testing.assert_array_equal(got, np.concatenate([fn(x[:8]),
                                                       fn(x[8:])]))


def test_tune_on_the_card_at_two_batches(dev, tmp_path):
    """``serve tune`` times the bundle's forward on the card at two batch
    sizes through the ROI kernel; both get a rate."""
    from protoasnet_tpu_torch.serve import tune_bundle

    path = _live_bundles(tmp_path)[0]
    before = roi_cosine_cuda.launches
    report = tune_bundle(path, [2, 4], points=(2, 18), device=dev)
    assert set(report["results"]) == {2, 4}
    for r in report["results"].values():
        assert set(r) == {"ms_per_batch", "samples_per_sec", "compile_s"}
        assert r["samples_per_sec"] > 0
    assert report["recommended_max_batch"] in (2, 4)
    assert roi_cosine_cuda.launches >= before + 2 * (1 + 2 + 18)


def test_flop_count_on_the_card_equals_the_cpu_count(dev):
    """The hand kernels report their products where they launch, so the
    forward and the train step count the same FLOPs on the card as on the
    CPU (where the plain heads' matmuls are counted)."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
    from protoasnet_tpu_torch.utils.flops import flops_by_op

    cfg = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4, "img_size": 32}
    crit = {"CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                              "ab_logitpath": "joined", "reduction": "mean"},
            "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
            "trans_occurrence": {"loss_weight": 0.05, "reduction": "mean"}}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 8, 32, 32, 3)).astype(np.float32))
    counts = []
    for device in (torch.device("cpu"), dev):
        model = build_model(cfg, device=device)
        opt = GroupAdam(model, {g: 1e-3 for g in GROUPS})
        step = make_xprotonet_steps(
            model, LossBundle(crit, num_classes=4, abstain_class=True), opt,
            GradAccumulator(opt.params, 2))[0]
        xd = x.to(device)
        with torch.no_grad():
            fwd = flops_by_op(lambda: model.eval()(xd))
        train = flops_by_op(lambda: step(
            xd, torch.tensor([0, 2], device=device),
            torch.tensor([True, True], device=device),
            {g: 1e-4 for g in GROUPS}, affine=(5.0, 1.1)))
        counts.append((sum(fwd.values()), sum(train.values())))
    assert counts[0] == counts[1], counts


# -- the int8 conv of the w8a8 path (ops/int8_conv.py) ----------------------

# (n, C, O, kernel, stride, padding, spatial): every int8 conv geometry of
# the trunks, with K = taps * C and N = O off multiples of 8 (padded with
# zeros), M <= 16 (padded rows) and the flagship's layer shapes at batch 2
INT8_GEOMETRIES = [
    (2, 45, 144, (1, 3, 3), (1, 1, 1), (0, 1, 1), (4, 9, 9)),
    (2, 13, 230, (1, 3, 3), (1, 2, 2), (0, 1, 1), (4, 9, 9)),
    (2, 45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0), (5, 6, 6)),
    (2, 230, 12, (3, 1, 1), (2, 1, 1), (1, 0, 0), (5, 6, 6)),
    (2, 16, 24, (1, 1, 1), (2, 2, 2), (0, 0, 0), (5, 6, 7)),
    (2, 9, 12, (3, 3, 3), (1, 1, 1), (1, 1, 1), (4, 6, 6)),
    (2, 9, 20, (3, 3, 3), (2, 2, 2), (1, 1, 1), (5, 7, 6)),
    (2, 3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), (4, 12, 12)),
    (2, 3, 64, (7, 7), (2, 2), (3, 3), (15, 15)),
    (2, 3, 27, (3, 3), (1, 1), (1, 1), (7, 7)),
    (2, 21, 32, (1, 1), (1, 1), (0, 0), (5, 5)),
    (1, 8, 8, (1, 1), (1, 1), (0, 0), (3, 3)),
    (2, 64, 144, (1, 3, 3), (1, 1, 1), (0, 1, 1), (32, 56, 56)),
    (2, 144, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0), (32, 56, 56)),
    (2, 460, 256, (3, 1, 1), (2, 1, 1), (1, 0, 0), (8, 14, 14)),
]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("geom", INT8_GEOMETRIES)
def test_int8_conv_card_is_the_plain_version(dev, geom, chunked,
                                             monkeypatch):
    from protoasnet_tpu_torch.ops import int8_conv as ic

    if chunked:
        monkeypatch.setattr(ic, "CHUNK_BYTES", 50_000)
    n, c, o, k, stride, pad, sp = geom
    g = torch.Generator(device=dev).manual_seed(31)
    xq = torch.randint(-127, 128, (n, c, *sp), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, c, *k), generator=g, device=dev,
                       dtype=torch.int8)
    before = ic.LAUNCHES
    got = ic.int8_conv(xq, wq, stride, pad)
    assert ic.LAUNCHES > before
    want = ic.int8_conv_torch(xq, wq, stride, pad)  # float64 on the card
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    cpu = ic.int8_conv_torch(xq.cpu(), wq.cpu(), stride, pad)
    assert torch.equal(got.cpu(), cpu)


def test_int8_conv_raises_and_never_falls_back_to_a_float_conv(
        dev, monkeypatch):
    """A shape ``_int_mm`` cannot take raises; a quantised model's forward
    on the card calls no float convolution of the trunk."""
    from torch import nn

    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops import int8_conv as ic
    from protoasnet_tpu_torch.quant import (build_qstate,
                                            calibrate_act_scales,
                                            quantized_model)

    with pytest.raises(ValueError, match="multiples of 8"):
        ic.int_mm(torch.zeros(32, 27, dtype=torch.int8, device=dev),
                  torch.zeros(27, 8, dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="M > 16"):
        ic.int_mm(torch.zeros(16, 32, dtype=torch.int8, device=dev),
                  torch.zeros(32, 8, dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="exact"):
        ic.int8_conv(torch.zeros(1, 20000, 3, 3, dtype=torch.int8,
                                 device=dev),
                     torch.zeros(8, 20000, 3, 3, dtype=torch.int8,
                                 device=dev), 1, 1)
    cfg = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4}
    model = build_model(cfg, device=dev)
    x = torch.randn(2, 8, 32, 32, 3, device=dev)
    qm = quantized_model(model, build_qstate(
        model, calibrate_act_scales(model, [x])))
    calls = []
    real = nn.Conv3d._conv_forward

    def counted(self, *args):
        calls.append(self)
        return real(self, *args)

    monkeypatch.setattr(nn.Conv3d, "_conv_forward", counted)
    before = ic.LAUNCHES
    with torch.inference_mode():
        out = qm(x)[0]
    assert torch.isfinite(out).all()
    assert ic.LAUNCHES - before == 27
    # only the stem's spatial conv (the JAX package's space-to-depth
    # stem, never quantised) runs as a float conv
    assert calls == [qm.cnn_backbone.stem_spatial]


def test_int8_chunked_peak_memory_at_layer1(dev):
    """layer1's spatial conv at the flagship's bucket of 128 (M =
    12,845,056 rows, K = 576): the int8 path holds its codes, its output
    and at most one chunk, not the 7.40 GB im2col and 7.40 GB of int32
    sums of one GEMM, and no more than bf16 cuDNN at the same shape."""
    from torch import nn

    from protoasnet_tpu_torch.ops import int8_conv as ic
    from protoasnet_tpu_torch.quant import QuantConv

    conv = nn.Conv3d(64, 144, (1, 3, 3), padding=(0, 1, 1), bias=False)
    entry = {"w_q": torch.randint(-127, 128, (1, 3, 3, 64, 144),
                                  dtype=torch.int8),
             "w_scale": torch.full((144,), 1e-3), "a_scale": torch.tensor(
                 0.02)}
    qconv = QuantConv(conv.to(dev), entry, [])
    x = torch.randn((128, 64, 32, 56, 56), device=dev, dtype=torch.bfloat16)
    peaks = {}
    for name, fn in (("int8", lambda: qconv(x)),
                     ("bf16", lambda: nn.functional.conv3d(
                         x, conv.weight.bfloat16(), padding=(0, 1, 1)))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            y = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        out_bytes = y.numel() * y.element_size()
        del y
        torch.cuda.empty_cache()
    print(f"layer1 spatial conv at 128: peak beyond the bf16 input "
          f"{peaks['int8'] / 2**30:.3f} GiB (int8), "
          f"{peaks['bf16'] / 2**30:.3f} GiB (bf16 cuDNN); output "
          f"{out_bytes / 2**30:.3f} GiB")
    assert peaks["int8"] <= out_bytes + x.numel() + 1.25 * ic.CHUNK_BYTES
    assert peaks["int8"] <= peaks["bf16"]
