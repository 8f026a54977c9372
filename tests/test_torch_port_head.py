"""Port's prototype head against the JAX package's two head paths.

The same occurrence maps, features and prototypes (numpy, seeded) go
through ``protoasnet_tpu_torch.ops.roi_cosine`` and through the JAX
``roi_cosine_head(impl="xla")`` and ``roi_cosine_pallas(interpret=True)``,
at the tolerances of tests/test_pallas_roi.py. The CUDA kernel itself runs
only on the card (tests/test_torch_port_cuda.py); on the CPU its wrapper
takes the plain version because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.ops.pallas_roi import roi_cosine_pallas
from protoasnet_tpu.ops.roi_cosine import roi_cosine_head as jax_head
from protoasnet_tpu_torch.ops import roi_cosine as port
from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
from torch_port_isolation import isolated

_isolated = isolated(1)

# (n, t, h, w, d, p): a tiny odd shape, the port tests' model head
# (8 frames at 32x32 -> 2x4x4, D=64, P=8) and a ragged one (S, P, D not
# multiples of the kernel's tiles)
SHAPES = [(2, 2, 3, 3, 16, 6), (2, 2, 4, 4, 64, 8), (3, 1, 5, 7, 40, 13)]


def _data(shape, seed=0):
    n, t, h, w, d, p = shape
    rng = np.random.default_rng(seed)
    occ = np.abs(rng.normal(size=(n, t, h, w, p))).astype(np.float32)
    feat = rng.normal(size=(n, t, h, w, d)).astype(np.float32)
    protos = rng.normal(size=(p, d)).astype(np.float32)
    return occ, feat, protos


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_plain_head_matches_jax(shape, jax_impl):
    occ, feat, protos = _data(shape)
    if jax_impl == "xla":
        roi_j, sim_j = jax_head(jnp.asarray(occ), jnp.asarray(feat),
                                jnp.asarray(protos), impl="xla")
    else:
        roi_j, sim_j = roi_cosine_pallas(jnp.asarray(occ), jnp.asarray(feat),
                                         jnp.asarray(protos), interpret=True)
    roi_t, sim_t = port.roi_cosine_head(torch.from_numpy(occ),
                                        torch.from_numpy(feat),
                                        torch.from_numpy(protos),
                                        impl="torch")
    assert roi_t.dtype == sim_t.dtype == torch.float32
    np.testing.assert_allclose(roi_t.numpy(), np.asarray(roi_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sim_t.numpy(), np.asarray(sim_j),
                               rtol=1e-5, atol=1e-5)


def test_pieces_match_jax():
    occ, feat, protos = _data(SHAPES[1], seed=3)
    from protoasnet_tpu.ops.roi_cosine import (
        cosine_similarity_to_prototypes as jax_cos, roi_pool as jax_pool)

    roi_t = port.roi_pool(torch.from_numpy(occ), torch.from_numpy(feat))
    roi_j = jax_pool(jnp.asarray(occ), jnp.asarray(feat))
    np.testing.assert_allclose(roi_t.numpy(), np.asarray(roi_j),
                               rtol=1e-5, atol=1e-5)
    cos_t = port.cosine_similarity_to_prototypes(roi_t,
                                                 torch.from_numpy(protos))
    cos_j = jax_cos(roi_j, jnp.asarray(protos))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j),
                               rtol=1e-5, atol=1e-5)


def test_eps_clamp_on_each_norm():
    """A zero occurrence map gives roi = 0; the clamp keeps sim at 0.5
    (cos 0) instead of NaN, as torch.nn.CosineSimilarity does."""
    occ, feat, protos = _data(SHAPES[0])
    occ[0] = 0.0
    _, sim = port.roi_cosine_head(torch.from_numpy(occ),
                                  torch.from_numpy(feat),
                                  torch.from_numpy(protos), impl="torch")
    np.testing.assert_allclose(sim[0].numpy(), 0.5)
    assert torch.isfinite(sim).all()


def test_default_impl_on_cpu_is_the_plain_version():
    """impl=None sends CPU tensors through the kernel's wrapper, which runs
    the plain version there and counts no launch."""
    occ, feat, protos = _data(SHAPES[2], seed=5)
    before = roi_cosine_cuda.launches
    roi_a, sim_a = port.roi_cosine_head(torch.from_numpy(occ),
                                        torch.from_numpy(feat),
                                        torch.from_numpy(protos))
    roi_b, sim_b = port.roi_cosine_torch(torch.from_numpy(occ),
                                         torch.from_numpy(feat),
                                         torch.from_numpy(protos))
    assert roi_cosine_cuda.launches == before
    torch.testing.assert_close(roi_a, roi_b, rtol=0, atol=0)
    torch.testing.assert_close(sim_a, sim_b, rtol=0, atol=0)


def test_bf16_inputs_compute_in_fp32():
    occ, feat, protos = _data(SHAPES[1], seed=7)
    o16 = torch.from_numpy(occ).to(torch.bfloat16)
    f16 = torch.from_numpy(feat).to(torch.bfloat16)
    roi, sim = port.roi_cosine_head(o16, f16, torch.from_numpy(protos))
    assert roi.dtype == sim.dtype == torch.float32
    ref_roi, ref_sim = port.roi_cosine_torch(o16.double(), f16.double(),
                                             torch.from_numpy(protos).double())
    np.testing.assert_allclose(roi.numpy(), ref_roi.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(sim.numpy(), ref_sim.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_unknown_impl_raises():
    occ, feat, protos = (torch.from_numpy(a) for a in _data(SHAPES[0]))
    with pytest.raises(ValueError, match="unknown head impl"):
        port.roi_cosine_head(occ, feat, protos, impl="xla")
