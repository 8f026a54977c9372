"""Port's temporal convolution against the JAX package's Pallas kernels.

The same seeded numpy inputs go through
``protoasnet_tpu_torch.ops.temporal_conv.temporal_conv_torch`` and through
``experiments/pallas_temporal.py``'s ``temporal_conv_pallas``, ``_v2`` and
``_v3`` (loaded by path; their ``pallas_call``s take no ``interpret``
argument, so ``pl.pallas_call`` is patched to run in interpret mode for the
test) and ``lax.conv_general_dilated``, at fp32 rtol 1e-5, atol 1e-6. Also
an unaligned C, T=1, the stem's C=45, bf16, the kernel's wrapper on CPU
tensors and the entry point's FLOP count. The CUDA kernel itself runs only
on the card
(tests/test_torch_port_cuda.py); on the CPU its wrapper takes the plain
version because the tensors lie on the CPU.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from protoasnet_tpu_torch.experiments.temporal_conv import flops
from protoasnet_tpu_torch.ops.temporal_conv import temporal_conv_torch
from protoasnet_tpu_torch.ops.temporal_conv_cuda import temporal_conv_cuda

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def exp():
    spec = importlib.util.spec_from_file_location(
        "pallas_temporal_experiment", REPO / "experiments" / "pallas_temporal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _data(b, t, s, c, o, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, s, c)).astype(np.float32)
    k = (rng.normal(size=(3, c, o)) * 0.05).astype(np.float32)
    return x, k


def _lax_ref(x, k):
    """The JAX scripts' reference: a (3,1,1) conv with SAME padding in T."""
    b, t, s, c = x.shape
    y = lax.conv_general_dilated(
        jnp.asarray(x).reshape(b, t, s, 1, c),
        jnp.asarray(k).reshape(3, 1, 1, c, -1), (1, 1, 1),
        [(1, 1), (0, 0), (0, 0)],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return np.asarray(y).reshape(b, t, s, -1)


def _port(x, k):
    return temporal_conv_torch(torch.from_numpy(x), torch.from_numpy(k))


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_matches_pallas_variants(exp, interpret, variant):
    x, k = _data(2, 8, 64, 16, 8)
    fn = {"v1": functools.partial(exp.temporal_conv_pallas, s_blk=32),
          "v2": functools.partial(exp.temporal_conv_pallas_v2, s_blk=32,
                                  t_blk=4),
          "v3": functools.partial(exp.temporal_conv_pallas_v3, s_blk=32)
          }[variant]
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(k)))
    out = _port(x, k)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 8, 64, 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), _lax_ref(x, k), rtol=RTOL,
                               atol=ATOL)


# (b, t, s, c, o): unaligned C, T=1, T=2, the stem's C=45 -> 64
@pytest.mark.parametrize("shape", [(2, 8, 64, 5, 8), (2, 1, 64, 16, 8),
                                   (1, 2, 32, 7, 3), (1, 3, 48, 45, 64)])
def test_odd_shapes_match_pallas_and_lax(exp, interpret, shape):
    x, k = _data(*shape, seed=1)
    ref = np.asarray(exp.temporal_conv_pallas(jnp.asarray(x), jnp.asarray(k),
                                              s_blk=16))
    out = _port(x, k).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _lax_ref(x, k), rtol=RTOL, atol=ATOL)


def test_bf16_matches_pallas(exp, interpret):
    """bf16 inputs, fp32 sums, one rounding to bf16 at the output in both:
    only the order of the fp32 sums differs, so at most one bf16 rounding
    step flips (1e-2 of the largest output)."""
    x, k = _data(2, 8, 64, 16, 8, seed=2)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    ref = np.asarray(exp.temporal_conv_pallas(xb, kb, s_blk=32), np.float32)
    out = temporal_conv_torch(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(k).bfloat16())
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err


def test_float64_stays_float64_and_ranks():
    x, k = _data(2, 4, 12, 6, 5, seed=3)
    y64 = temporal_conv_torch(torch.from_numpy(x).double(),
                              torch.from_numpy(k).double())
    assert y64.dtype == torch.float64
    y = _port(x, k)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), rtol=RTOL, atol=ATOL)
    # (B, T, H, W, C) maps give the same result as (B, T, S, C)
    y5 = temporal_conv_torch(torch.from_numpy(x).reshape(2, 4, 3, 4, 6),
                             torch.from_numpy(k))
    assert tuple(y5.shape) == (2, 4, 3, 4, 5)
    torch.testing.assert_close(y5.reshape(2, 4, 12, 5), y, rtol=0, atol=0)


def test_dispatcher_on_cpu_is_the_plain_version():
    """The kernel's wrapper dispatches by device: on CPU tensors, (B, T, H,
    W, C) maps included, it runs the plain version and counts no launch."""
    x, k = (torch.from_numpy(a) for a in _data(2, 3, 10, 4, 6, seed=4))
    before = temporal_conv_cuda.launches
    b = temporal_conv_torch(x, k)
    c = temporal_conv_cuda(x, k)
    c5 = temporal_conv_cuda(x.reshape(2, 3, 2, 5, 4), k)
    assert temporal_conv_cuda.launches == before
    torch.testing.assert_close(c, b, rtol=0, atol=0)
    torch.testing.assert_close(c5.reshape(2, 3, 10, 6), b, rtol=0, atol=0)


@pytest.mark.parametrize("t", [1, 2, 5, 32])
def test_flops_count_taps_inside_the_clip(t):
    """The bound's FLOPs: 2 per multiply-add of a tap whose frame lies in
    [0, T); the zero frames at t=-1 and t=T cost nothing."""
    b, s, c, o = 2, 7, 3, 5
    taps = sum(0 <= tt + dt - 1 < t for tt in range(t) for dt in range(3))
    assert flops(b, t, s, c, o) == 2 * b * s * c * o * taps
