"""The served R(2+1)D trunk's conv epilogue (``ops/conv_epilogue_cuda.py``,
``csrc/conv_epilogue.cu``): ``relu(x + b[c] (+ r))`` after a conv whose
eval BatchNorm is folded into it.

On the CPU:
- the plain route on the folded conv's output against ``bn -> relu`` and
  ``bn -> add -> relu`` written out on the unfolded one, in fp32 and bf16,
  channels-last and contiguous;
- the choice of route: every CPU tensor takes the plain route, and the
  kernel's wrapper refuses it; the bytes a call must move;
- the counters: one ``serve.conv_epilogue.plain`` per epilogue, 26 per
  served forward of the flagship's trunk, nothing while no profiler is
  open.
On the card (``cuda`` marker): the kernel against the plain route at each
distinct (C, T, H·W) of the served trunk, with and without a residual,
bf16 within one bf16 ulp of the plain route in fp32 and fp32 exactly; a
tensor on the card that the kernel does not take raises, through the
wrapper and through ``conv_epilogue``, and takes no plain route.
"""

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.ops import conv_epilogue_cuda as epi
from protoasnet_tpu_torch.serve import make_serving_fn
from protoasnet_tpu_torch.utils import profiling
from torch_port_isolation import isolated

_isolated = isolated(1)

CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32, "head_impl": "xla",
       "dtype": "float32"}
# each distinct (C, T, H·W) of the flagship's served trunk (32x112x112
# clips): the stem's, layer1's, layer2's and layer3's mid-planes and
# outputs
SERVED = [(48, 32, 3136), (64, 32, 3136), (144, 32, 3136), (232, 32, 784),
          (128, 16, 784), (288, 16, 784), (464, 16, 196), (256, 8, 196),
          (576, 8, 196)]


def _bn(c, seed):
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm3d(c).eval()
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.3, generator=g)
    return bn


def _scale_shift(bn):
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


def _layout(t, channels_last):
    return t.contiguous(memory_format=torch.channels_last_3d) \
        if channels_last else t.contiguous()


PLAIN = [(r, d, cl) for r in (False, True)
         for d in (torch.float32, torch.bfloat16) for cl in (True, False)]


@pytest.mark.parametrize(
    "residual, dtype, channels_last", PLAIN,
    ids=[f"{'add' if r else 'bn'}-{str(d)[6:]}-{'cl' if cl else 'ncdhw'}"
         for r, d, cl in PLAIN])
def test_plain_route_is_bn_add_relu_written_out(residual, dtype,
                                                channels_last):
    c = 16
    y = torch.randn(2, c, 3, 5, 6, generator=torch.Generator().manual_seed(1))
    r = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    bn = _bn(c, 3)
    with torch.no_grad():
        s, shift = _scale_shift(bn)
        # the folded conv's output: the conv's with the weight times s
        x = _layout((y * s.view(-1, 1, 1, 1)).to(dtype), channels_last)
        rr = _layout(r.to(dtype), channels_last) if residual else None
        got = epi.conv_epilogue_torch(x, shift, rr)
        want = bn(y) + (r.to(dtype).float() if residual else 0.0)
        want = torch.relu(want)
    assert got.dtype == dtype and got.shape == y.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        # x rounded to bf16 before the sum, the sum rounded once after
        ref = torch.relu(x.float() + shift.view(-1, 1, 1, 1)
                         + (rr.float() if residual else 0.0))
        assert torch.equal(got, ref.to(dtype))
        assert (got.float() - want).abs().max() <= 0.02 * want.abs().max()


def test_cpu_tensors_take_the_plain_route():
    x = torch.randn(2, 8, 2, 3, 3).contiguous(
        memory_format=torch.channels_last_3d)
    b = torch.randn(8)
    assert "not a card" in epi.unsupported(x, b)
    with pytest.raises(ValueError, match="not a card"):
        epi.conv_epilogue_cuda(x, b)
    launches = epi.conv_epilogue_cuda.launches
    torch.testing.assert_close(epi.conv_epilogue(x, b, x),
                               torch.relu(2 * x + b.view(-1, 1, 1, 1)))
    assert epi.conv_epilogue_cuda.launches == launches


def test_bytes_by_hand():
    # 10 bf16 elements read and written (40 bytes), 8 fp32 biases (32); the
    # residual adds one more read of 20
    assert epi.bytes_moved(10, 2, 8, False) == 40 + 32
    assert epi.bytes_moved(10, 2, 8, True) == 60 + 32


def _counts(fn):
    profiling.reset()
    fn()  # off: no span to count on
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("probe"):
            fn()
    spans = profiling.spans()
    profiling.reset()
    return [s["counts"] for s in spans if s["name"] == "probe"]


def test_counts_one_per_epilogue():
    x = torch.randn(2, 8, 2, 3, 3)
    b = torch.zeros(8)

    def three():
        epi.conv_epilogue(x, b)
        epi.conv_epilogue(x, b, x)
        epi.conv_epilogue(x, b)

    assert _counts(three) == [{"serve.conv_epilogue.plain": 3}]


def test_counts_26_per_served_forward():
    model = build_model(CFG, device="cpu", seed=3).eval()
    fn = make_serving_fn(model)
    x = np.random.default_rng(4).normal(size=(1, 8, 32, 32, 3)).astype(
        np.float32)
    assert _counts(lambda: fn(x)) == [
        {"serve.aligned_trunk": 1, "serve.conv_epilogue.plain": 26}]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++")
    return torch.device("cuda")


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (the spacing of its binade; 2^-133 at 0)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("c, t, hw", SERVED,
                         ids=[f"C{c}-T{t}-HW{hw}" for c, t, hw in SERVED])
def test_card_kernel_matches_the_plain_route(dev, c, t, hw):
    g = torch.Generator(device=dev).manual_seed(c)
    shape = (2, c, t, hw // 14, 14) if hw % 14 == 0 else (2, c, t, hw, 1)
    for dtype in (torch.bfloat16, torch.float32):
        for residual in (False, True):
            x = torch.randn(shape, device=dev, generator=g).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last_3d)
            b = torch.randn(c, device=dev, generator=g)
            r = torch.randn(shape, device=dev, generator=g).to(dtype) \
                .contiguous(memory_format=torch.channels_last_3d) \
                if residual else None
            ref = epi.conv_epilogue_torch(
                x.float(), b, None if r is None else r.float())
            launches = epi.conv_epilogue_cuda.launches
            got = epi.conv_epilogue(x.clone(memory_format=torch.
                                            channels_last_3d), b, r)
            torch.cuda.synchronize(dev)
            assert epi.conv_epilogue_cuda.launches == launches + 1
            if dtype == torch.float32:
                assert torch.equal(got, ref)
            else:
                assert ((got.float() - ref).abs() <= _bf16_ulp(ref)).all()
                assert torch.equal(got, epi.conv_epilogue_torch(x, b, r))


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(dev):
    ok = torch.randn(2, 16, 2, 3, 3, device=dev).contiguous(
        memory_format=torch.channels_last_3d)
    b = torch.randn(16, device=dev)
    bad = {"ncdhw": (ok.contiguous(), b, None),
           "C12": (ok[:, :12].contiguous(
               memory_format=torch.channels_last_3d), b[:12], None),
           "float64": (ok.double(), b, None),
           "bias_bf16": (ok, b.bfloat16(), None),
           "residual_ncdhw": (ok, b, ok.contiguous())}
    for name, (x, bias, r) in bad.items():
        assert epi.unsupported(x, bias, r) is not None, name
        launches = epi.conv_epilogue_cuda.launches
        for fn in (epi.conv_epilogue_cuda, epi.conv_epilogue):
            with pytest.raises(ValueError, match="conv_epilogue_cuda"):
                fn(x, bias, r)
        assert epi.conv_epilogue_cuda.launches == launches, name
    assert _counts(lambda: pytest.raises(
        ValueError, epi.conv_epilogue, ok.contiguous(), b)) == [{}]
