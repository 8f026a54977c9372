"""Port's temporal convolution against the JAX package's Pallas kernels.

The same seeded numpy inputs go through
``protoasnet_tpu_torch.ops.temporal_conv.temporal_conv_torch`` and through
``experiments/pallas_temporal.py``'s ``temporal_conv_pallas``, ``_v2`` and
``_v3`` (loaded by path; their ``pallas_call``s take no ``interpret``
argument, so ``pl.pallas_call`` is patched to run in interpret mode for the
test) and ``lax.conv_general_dilated``, at fp32 rtol 1e-5, atol 1e-6. Also
an unaligned C, T=1, the stem's C=45, bf16, the kernel's wrapper on CPU
tensors and the entry point's shapes, FLOP and byte counts, bounds and
``--device cpu`` runs. The CUDA kernel itself runs only
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

from protoasnet_tpu_torch.experiments import temporal_conv as entry
from protoasnet_tpu_torch.experiments.common import bound_ms
from protoasnet_tpu_torch.experiments.fused_c2p1d import BLOCKS
from protoasnet_tpu_torch.experiments.temporal_conv import flops
from protoasnet_tpu_torch.ops.temporal_conv import temporal_conv_torch
from protoasnet_tpu_torch.ops.temporal_conv_cuda import temporal_conv_cuda
from torch_port_isolation import isolated

_isolated = isolated(1)

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


def test_shapes_are_the_trunks_temporal_convs():
    """The layer shapes are the blocks' Cm -> Co temporal convs; ``--shape``
    takes the four names and defaults to layer1."""
    assert entry.SHAPES["stem"] == (32, 56, 56, 45, 64)
    for name, (t, h, w, _, cm, co) in BLOCKS.items():
        assert entry.SHAPES[name] == (t, h, w, cm, co)
    assert list(entry.SHAPES) == ["stem", "layer1", "layer2", "layer3"]
    assert entry._parse([]).shape == "layer1"
    assert entry._parse(["--shape", "layer3", "--bf16"]).shape == "layer3"
    with pytest.raises(SystemExit):
        entry._parse(["--shape", "layer4"])
    assert entry.dims("layer2", "cuda") == (8, 16, 28, 28, 288, 128)
    assert entry.dims("layer3", "cpu") == (2, 4, 4, 4, 576, 256)


# (shape, GFLOP of the taps inside the clip, bf16 bytes of x + k + y) at B=8
TRUNK = [("stem", 13_583_646_720, 175_031_168),
         ("layer1", 43_467_669_504, 334_026_752),
         ("layer2", 21_271_412_736, 83_714_048),
         ("layer3", 10_173_284_352, 21_757_952)]


@pytest.mark.parametrize("name, nflop, nbytes_bf16", TRUNK)
def test_flops_and_bytes_at_the_trunk_shapes(name, nflop, nbytes_bf16):
    b, t, h, w, c, o = entry.dims(name, "cuda")
    assert flops(b, t, h * w, c, o) == nflop
    assert entry.nbytes(b, t, h * w, c, o, 2) == nbytes_bf16
    assert entry.nbytes(b, t, h * w, c, o, 4) == 2 * nbytes_bf16


def test_bounds_at_layer1():
    """bf16 is bound by bytes; fp32 by operations at the 3xTF32 rate (a
    third of 495 TFLOP/s), 0.263 ms against 0.199 ms of bytes."""
    b, t, h, w, c, o = entry.dims("layer1", "cuda")
    s = h * w
    ms, by = bound_ms(entry.nbytes(b, t, s, c, o, 2), flops(b, t, s, c, o),
                      torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(0.09971, abs=1e-5)
    ms, by = bound_ms(entry.nbytes(b, t, s, c, o, 4), flops(b, t, s, c, o),
                      torch.float32)
    assert by == "operations" and ms == pytest.approx(0.26344, abs=1e-5)


@pytest.mark.parametrize("name", list(entry.SHAPES))
def test_entry_point_runs_each_shape_on_cpu(name):
    """``--device cpu --shape s``: the plain version at the shape's widths
    on a small clip, against ``F.conv3d`` in float64."""
    res = entry.main(["--device", "cpu", "--shape", name])
    t, _, _, c, o = entry.SHAPES[name]
    assert res["shape_name"] == name and res["device"] == "cpu"
    assert res["shape"] == dict(b=2, t=min(t, 4), s=16, c=c, o=o)
    assert res["rel_err"] <= res["tol"] and "ms" not in res
