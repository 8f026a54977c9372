"""Port's fused Conv2Plus1D block against the JAX package's.

The same seeded numpy inputs go through
``protoasnet_tpu_torch.ops.fused_c2p1d.fused_c2p1d_torch`` and through
``experiments/pallas_fused_c2p1d.py`` (loaded by path): its Pallas
``fused_c2p1d(..., interpret=True)`` (variants ``taps`` and ``best``) and
its ``xla_reference``, at (2,6,8,8,16->24->16) in fp32 and bf16.
``fold_conv2plus1d`` is checked on a port ``Conv2Plus1D`` whose weights and
non-trivial BN statistics come from a JAX ``Conv2Plus1D`` through
``models/from_jax.py``: the plain fused output equals the port module's
eval forward and the JAX module's ``apply``. Also the kernel's wrapper on
CPU tensors and the entry point's FLOP count. The CUDA kernel itself runs
only on the card (tests/test_torch_port_cuda.py).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.models.backbones.r2plus1d import \
    Conv2Plus1D as JaxConv2Plus1D
from protoasnet_tpu_torch.models.backbones.r2plus1d import Conv2Plus1D
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.experiments.fused_c2p1d import SMALL, flops
from protoasnet_tpu_torch.ops.fused_c2p1d import (fold_conv2plus1d,
                                                  fused_c2p1d_torch)
from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import fused_c2p1d_cuda
from torch_port_isolation import isolated

_isolated = isolated(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def exp():
    spec = importlib.util.spec_from_file_location(
        "pallas_fused_c2p1d_experiment",
        REPO / "experiments" / "pallas_fused_c2p1d.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(b, t, h, w, c, cm, co, seed=0):
    """As the JAX script draws them: x, ks, kt, then the folded affine."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, w, c)).astype(np.float32)
    ks = (rng.normal(size=(3, 3, c, cm)) * 0.05).astype(np.float32)
    kt = (rng.normal(size=(3, cm, co)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=cm).astype(np.float32)
    shift = (rng.normal(size=cm) * 0.1).astype(np.float32)
    return x, ks, scale, shift, kt


def _port(args, dtype):
    x, ks, scale, shift, kt = (torch.from_numpy(a) for a in args)
    return fused_c2p1d_torch(x.to(dtype), ks.to(dtype), scale, shift,
                             kt.to(dtype))


def _jax_args(args, dtype):
    x, ks, scale, shift, kt = args
    return (jnp.asarray(x, dtype), jnp.asarray(ks, dtype),
            jnp.asarray(scale), jnp.asarray(shift), jnp.asarray(kt, dtype))


def _max_rel(out, ref):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("variant", ["taps", "best"])
def test_fp32_matches_pallas_and_xla(exp, variant):
    args = _data(*SMALL)
    jargs = _jax_args(args, jnp.float32)
    ref = np.asarray(exp.fused_c2p1d(*jargs, variant=variant, interpret=True))
    out = _port(args, torch.float32)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 6, 8, 8, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(exp.xla_reference(*jargs)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["taps", "best"])
def test_bf16_matches_pallas_and_xla(exp, variant):
    """The Pallas kernel rounds mid to bf16 where the port does (after the
    fp32 affine and ReLU): only the order of the fp32 sums differs, 1e-2
    of the largest output. ``xla_reference`` also rounds the spatial conv's
    output to bf16 before the affine; the JAX script accepts 2e-2."""
    args = _data(*SMALL, seed=1)
    jargs = _jax_args(args, jnp.bfloat16)
    out = _port(args, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = exp.fused_c2p1d(*jargs, variant=variant, interpret=True)
    assert _max_rel(out, ref) <= 1e-2
    assert _max_rel(out, exp.xla_reference(*jargs)) <= 2e-2


def test_one_frame_and_zero_mid_padding(exp):
    """T=1 and T=2 against xla_reference, whose temporal conv pads mid with
    zeros: a positive shift makes relu(shift) padding visibly wrong."""
    for t in (1, 2):
        x, ks, scale, shift, kt = _data(1, t, 5, 7, 3, 10, 4, seed=2)
        shift = np.abs(shift) + 0.5
        args = (x, ks, scale, shift, kt)
        ref = np.asarray(exp.xla_reference(*_jax_args(args, jnp.float32)))
        np.testing.assert_allclose(_port(args, torch.float32).numpy(), ref,
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def block_pair():
    """(jax module, variables, port module in eval mode, x (B,T,H,W,C))."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 6, 7, 16)).astype(np.float32)
    jm = JaxConv2Plus1D(inplanes=16, planes=12)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["bn_mid"] = {"scale": rng.uniform(0.5, 1.5, size=params["bn_mid"]
                                             ["scale"].shape).astype(np.float32),
                        "bias": (rng.normal(size=params["bn_mid"]["bias"].shape)
                                 * 0.2).astype(np.float32)}
    stats = {"bn_mid": {"mean": (rng.normal(size=params["bn_mid"]["bias"]
                                            .shape) * 0.2).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, size=params["bn_mid"]
                                           ["bias"].shape).astype(np.float32)}}
    tm = Conv2Plus1D(16, 12).eval()
    load_jax_variables(tm, params, stats)
    return jm, {"params": params, "batch_stats": stats}, tm, x


def test_fold_matches_port_module_and_jax(block_pair):
    jm, variables, tm, x = block_pair
    ks, scale, shift, kt = fold_conv2plus1d(tm)
    mid = tm.bn_mid.num_features
    assert tuple(ks.shape) == (3, 3, 16, mid) and tuple(kt.shape) == (3, mid, 12)
    assert scale.dtype == shift.dtype == torch.float32
    xt = torch.from_numpy(x)
    out = fused_c2p1d_torch(xt, ks, scale, shift, kt)
    with torch.no_grad():
        module_out = tm(xt.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    jax_out = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), module_out.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), jax_out, rtol=1e-5, atol=1e-5)


def test_fold_refuses_training_mode_and_stride_2():
    with pytest.raises(ValueError, match="training mode"):
        fold_conv2plus1d(Conv2Plus1D(8, 8).train())
    with pytest.raises(ValueError, match="stride 1 only"):
        fold_conv2plus1d(Conv2Plus1D(8, 16, stride=2).eval())


def test_dispatcher_on_cpu_is_the_plain_version():
    """The kernel's wrapper dispatches by device: on CPU tensors it runs the
    plain version and counts no launch; float64 stays float64."""
    args = [torch.from_numpy(a) for a in _data(1, 3, 4, 5, 6, 9, 7, seed=4)]
    before = fused_c2p1d_cuda.launches
    b = fused_c2p1d_torch(*args)
    c = fused_c2p1d_cuda(*args)
    assert fused_c2p1d_cuda.launches == before
    torch.testing.assert_close(c, b, rtol=0, atol=0)
    d = fused_c2p1d_torch(*(t.double() for t in args))
    assert d.dtype == torch.float64
    torch.testing.assert_close(b.double(), d, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [SMALL, (1, 1, 1, 1, 2, 3, 4),
                                   (2, 3, 5, 7, 3, 10, 4)])
def test_flops_count_taps_inside_the_clip(shape):
    """The bound's FLOPs: 2 per multiply-add of a spatial tap inside the
    image and of a temporal tap inside [0, T); SAME padding costs nothing."""
    b, t, h, w, c, cm, co = shape

    def inside(n):  # (position, tap) pairs of a 3-tap SAME conv over n
        return sum(0 <= i + d - 1 < n for i in range(n) for d in range(3))

    assert flops(*shape) == (2 * b * t * c * cm * inside(h) * inside(w)
                             + 2 * b * h * w * cm * co * inside(t))
