"""The served R(2+1)D trunk laid out for cuDNN (``models/aligned.py``),
built by ``serve.py::_device_forward``.

On the CPU, at the small flagship (8 frames, P=8, D=64, K=4):
- the serving function's logits against the model's own forward, on the
  uint8-gray and the float wire, in fp32 (to 1e-5) and under bf16 autocast
  (the served-path tolerance of ``perfbench/tests/test_perfbench_
  reference.py``), at an even and an odd frame size;
- the copy's layout: every conv's channels a multiple of 8 with
  ``channels_last_3d`` weights, the temporal convs run as 2-D convs, and
  each padded channel exactly 0 after its folded conv and its epilogue;
- the copy holds no BatchNorm (each is folded into its conv) and leaves
  the model's state_dict as it was, keys, shapes and values;
- the model, its bundle and a bundle saved from a served model keep
  ``build_model``'s state_dict shapes;
- int8, image XProtoNet and ProtoPNet serving functions build no copy and
  serve what the model computes;
- the counters ``serve.aligned_trunk`` and ``serve.conv_epilogue.plain``:
  one and 26 per served batch while a profiler is open, nothing
  otherwise.
On the card (``cuda`` marker): a served forward at the flagship's size
launches no fp32 fallback convolution and no layout or dtype conversion.
"""

import io
import zipfile

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from protoasnet_tpu_torch import server
from protoasnet_tpu_torch.data.transforms import normalize
from protoasnet_tpu_torch.models import aligned
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.quant import (build_qstate, calibrate_act_scales,
                                        quantized_model)
from protoasnet_tpu_torch.serve import (load_bundle_model, make_serving_fn,
                                        save_serving_bundle)
from protoasnet_tpu_torch.utils import profiling
from torch_port_isolation import isolated

_isolated = isolated(1)

CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32, "head_impl": "xla"}
FLAGSHIP = dict(CFG, prototype_shape=(40, 256, 1, 1, 1), img_size=112,
                dtype="bfloat16")
IMAGE_CFGS = {
    "ProtoPNet": {"name": "ProtoPNet", "base_architecture": "resnet18",
                  "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
                  "prototype_activation_function": "log",
                  "add_on_layers_type": "regular"},
    "XProtoNet": {"name": "XProtoNet", "base_architecture": "resnet18",
                  "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
                  "head_impl": "xla"},
}
# what TAGS name in a kernel: cuDNN's fp32 FFMA fallback and the layout and
# dtype conversions it and an NCDHW trunk put around the convolutions
TAGS = ("ffma", "nchwToNhwc", "nhwcToNchw", "convertTensor")


def _model(cfg=CFG, dtype="float32", device="cpu"):
    """The model with non-trivial BatchNorm statistics and affines."""
    model = build_model(dict(cfg, dtype=dtype), device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm3d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model.to(device).eval()


def _wire(uint8, n, size, seed, frames=8):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, size=(n, frames, *size), dtype=np.uint8)
    return rng.normal(size=(n, frames, *size, 3)).astype(np.float32)


def _direct(model, x, uint8):
    """The model's own forward on the wire's batch (the eval transform of
    the uint8-gray wire written out)."""
    xt = torch.from_numpy(x)
    if uint8:
        xt = normalize(xt.float() / 255.0)[..., None].expand(*x.shape, 3)
    with torch.no_grad():
        return model(xt)[0].float().numpy()


MATCH = [(u, d, (32, 32)) for u in (True, False)
         for d in ("float32", "bfloat16")] + [(False, "float32", (31, 29))]


@pytest.mark.parametrize(
    "uint8, dtype, size", MATCH,
    ids=[f"{'uint8' if u else 'float'}-{d}-{s[0]}x{s[1]}"
         for u, d, s in MATCH])
def test_served_logits_match_the_model(uint8, dtype, size):
    model = _model(dict(CFG, img_size=size[0]), dtype)
    assert aligned.aligned_serving_model(model) is not None
    x = _wire(uint8, 2, size, seed=1)
    got = make_serving_fn(model, uint8_gray=uint8)(x)
    want = _direct(model, x, uint8)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.abs(got - want).max() < 0.05 * np.abs(want).max()


def _original(name):
    """The model's conv whose output channels the copy's module ``name``
    holds: an epilogue holds its conv's."""
    name = name.replace("stem.", "stem_")
    for held, conv in (("mid", "spatial"), ("out", "temporal")):
        if name.endswith(held):
            return name[:-len(held)] + conv
    return name


def test_copy_is_aligned_channels_last_and_padded_with_zeros():
    model = _model()
    served = aligned.aligned_serving_model(model)
    trunk, orig = served.cnn_backbone, dict(model.cnn_backbone.named_modules())
    convs = [(n, m) for n, m in trunk.named_modules()
             if isinstance(m, nn.Conv3d)]
    assert len(convs) == len([m for m in orig.values()
                              if isinstance(m, nn.Conv3d)])
    for name, m in convs:
        assert m.in_channels % 8 == 0 and m.out_channels % 8 == 0, name
        assert m.weight.is_contiguous(memory_format=torch.channels_last_3d)
        assert not m.weight.requires_grad
        temporal = m.kernel_size[1:] == (1, 1) and m.kernel_size[0] > 1
        assert isinstance(m, aligned._TemporalConv) == temporal, name
    # the stem is the space-to-depth conv over 12 channels padded to 16
    assert trunk.stem.spatial.in_channels == 16
    assert trunk.stem.spatial.kernel_size == (1, 4, 4)
    padded = {}

    def hook(name, real):
        def check(mod, inp, out):
            padded[name] = bool((out[:, real:] == 0).all())
        return check

    handles = []
    for name, m in trunk.named_modules():
        if not isinstance(m, (nn.Conv3d, aligned._Epilogue)):
            continue
        real = orig[_original(name)].out_channels
        channels = m.out_channels if isinstance(m, nn.Conv3d) \
            else len(m.bias)
        if channels > real:
            handles.append(m.register_forward_hook(hook(name, real)))
    x = _wire(False, 2, (32, 32), seed=2)
    make_serving_fn(model)  # the model itself is left as it was
    with torch.no_grad():
        served(aligned.aligned_input(torch.from_numpy(x), torch.float32))
    for h in handles:
        h.remove()
    # the stem's 45 mid-planes and layer2.0's and layer3.0's 230 and 460
    assert set(padded) == {
        "stem.spatial", "stem.mid", "layer2_0.conv1.spatial",
        "layer2_0.conv1.mid", "layer3_0.conv1.spatial",
        "layer3_0.conv1.mid"}
    assert all(padded.values()), padded


FOLDED = [-3, -2]


@pytest.mark.parametrize("last_layer_num", FOLDED,
                         ids=[f"last_layer_{n}" for n in FOLDED])
def test_copy_folds_every_batchnorm_and_leaves_the_model(last_layer_num):
    model = _model(dict(CFG, backbone_last_layer_num=last_layer_num))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    served = aligned.aligned_serving_model(model)
    make_serving_fn(model)(_wire(False, 1, (32, 32), seed=9))
    assert not any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                   for m in served.cnn_backbone.modules())
    epilogues = [m for m in served.cnn_backbone.modules()
                 if isinstance(m, aligned._Epilogue)]
    assert len(epilogues) == 2 + 4 * len(model.cnn_backbone.layer_names)
    assert all(m.bias.dtype == torch.float32 for m in epilogues)
    after = model.state_dict()
    assert _shapes(after) == _shapes(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_bundles_keep_the_upstream_shapes(tmp_path):
    built = _model()
    want = _shapes(build_model(CFG, device="cpu").state_dict())
    path = str(tmp_path / "b.zip")
    save_serving_bundle(path, built, CFG, (8, 32, 32, 3))
    loaded, *_ = load_bundle_model(path, "cpu")
    fn = make_serving_fn(loaded)
    fn(_wire(False, 1, (32, 32), seed=3))
    assert _shapes(loaded.state_dict()) == want
    assert _shapes(built.state_dict()) == want
    again = str(tmp_path / "again.zip")
    save_serving_bundle(again, loaded, CFG, (8, 32, 32, 3))
    with zipfile.ZipFile(again) as z:
        npz = np.load(io.BytesIO(z.read("weights.npz")))
        assert {k: tuple(npz[k].shape) for k in npz.files} == want


def _int8(model):
    calib = torch.from_numpy(_wire(False, 2, (32, 32), seed=4))
    with torch.no_grad():
        qstate = build_qstate(model, calibrate_act_scales(model, [calib]))
    return quantized_model(model, qstate), calib.numpy()


OTHERS = ["int8", "XProtoNet", "ProtoPNet"]


@pytest.mark.parametrize("kind", OTHERS)
def test_other_models_serve_without_a_copy(monkeypatch, kind):
    built = []
    real = aligned.aligned_trunk
    monkeypatch.setattr(aligned, "aligned_trunk",
                        lambda *a: built.append(1) or real(*a))
    if kind == "int8":
        model, x = _int8(_model())
    else:
        model = build_model(IMAGE_CFGS[kind], device="cpu", seed=3)
        x = np.random.default_rng(5).normal(
            size=(2, 64, 64, 3)).astype(np.float32)
    got = make_serving_fn(model)(x)
    assert built == [] and aligned.aligned_serving_model(model) is None
    with torch.no_grad():
        want = model(torch.from_numpy(x))[0].float().numpy()
    np.testing.assert_array_equal(got, want)
    make_serving_fn(_model())  # the float video model does build one
    assert built == [1]


def test_the_serving_copy_snapshots_the_trunk():
    """``make_serving_fn``'s rule: a float R(2+1)D model's trunk is copied
    when the function is made, its head is the model's own, so a later
    change reaches the served logits through the head only."""
    model = _model()
    fn = make_serving_fn(model)
    x = _wire(False, 2, (32, 32), seed=8)
    before = fn(x)
    with torch.no_grad():
        model.cnn_backbone.stem_spatial.weight.mul_(2.0)
    np.testing.assert_array_equal(fn(x), before)
    with torch.no_grad():
        model.last_layer.Dense_0.weight.mul_(2.0)
    np.testing.assert_allclose(fn(x), 2.0 * before, rtol=1e-6, atol=1e-6)


def test_counter_counts_one_per_served_batch_while_tracing():
    profiling.reset()
    b = server.DynamicBatcher(make_serving_fn(_model()), max_batch=2,
                              max_delay_ms=1, sample_shape=(8, 32, 32, 3))
    try:
        x = _wire(False, 2, (32, 32), seed=6)
        b.submit(x)  # off: no span to count on
        assert profiling.spans() == []
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(3):
                b.submit(x[i % 2:i % 2 + 1])
    finally:
        b.close()
    batches = [s for s in profiling.spans() if s["name"] == "batcher.batch"]
    profiling.reset()
    assert len(batches) == 3
    # each batch sealed after the one before it had returned
    assert [s["counts"] for s in batches] == [
        {"batcher.assembled_inline": 1, "serve.aligned_trunk": 1,
         "serve.conv_epilogue.plain": 26}] * 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layout is cuDNN's choice")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_forward_runs_no_fallback_and_no_conversion(dev):
    """The flagship at full size, 8 uint8 clips: cuDNN keeps every trunk
    conv on its bf16 NDHWC tensor-core kernels."""
    fn = make_serving_fn(_model(FLAGSHIP, "bfloat16", dev), uint8_gray=True)
    x = _wire(True, 8, (112, 112), seed=7, frames=32)
    fn(x)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize(dev)
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("nhwc" in k for k in kernels), sorted(kernels)
    bad = sorted(k for k in kernels if any(t in k for t in TAGS))
    assert not bad, bad
