"""The port's ProtoPNet patch push against the JAX package's.

- Receptive-field info: the port's ResNet-18/50 ``conv_info()`` chains and
  ``push/receptive_field.py`` against the JAX trunks' and the JAX module,
  at 224x224 and 64x64, for every patch of the map: equal.
- ``push_prototypes_patch`` on the same PPNet weights (ResNet-18, the
  "regular" add-on, 64x64, P=6, D=32, K=3, fp32) and the same loader
  (three batches of four images, the last one padded): the winners' global
  indices and patches, ``bb``, ``bb_rf`` (``bb.npy``,
  ``bb-receptive_field.npy``), the pickle and the replaced prototype
  vectors. The boxes and indices are equal; the distances and vectors
  within 1e-5 relative (fp32 convolutions of two frameworks). The JAX push
  is handed the JAX trunk's conv chain through a small model object, as
  its own tests do.
- The isfinite guard (a prototype whose class has no sample stays
  unmatched and keeps its vector) and the global sample index, with a stub
  push step, as the JAX package's regressions test them.
- The pictures: one PNG per matched prototype.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.models.backbones.resnet2d import resnet_features
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.push import push_protopnet as jax_push
from protoasnet_tpu.push import receptive_field as jax_rf
from protoasnet_tpu_torch.models.backbones.resnet2d import ResNetFeatures
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.push import receptive_field as rf
from protoasnet_tpu_torch.push.push_protopnet import (
    find_high_activation_crop, push_prototypes_patch)

torch.set_num_threads(1)

P, D, K, IMG = 6, 32, 3, 64
CFG = {"name": "ProtoPNet", "base_architecture": "resnet18",
       "prototype_shape": (P, D, 1, 1), "num_classes": K, "img_size": IMG,
       "add_on_layers_type": "regular"}


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("img", [224, 64])
def test_receptive_field_info_matches(arch, img):
    chain = ResNetFeatures(arch).conv_info()
    assert tuple(chain) == tuple(resnet_features(arch).conv_info())
    info = rf.compute_proto_layer_rf_info_v2(img, *chain, 1)
    assert info == jax_rf.compute_proto_layer_rf_info_v2(img, *chain, 1)
    assert info[0] == img // 32 and info[1] == 32
    n = int(info[0])
    for h in range(n):
        for w in range(n):
            box = rf.compute_rf_prototype(img, (5, h, w), info)
            assert box == jax_rf.compute_rf_prototype(img, (5, h, w), info)
            assert box[0] == 5 and 0 <= box[1] < box[2] <= img


def test_high_activation_crop_matches():
    act = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    assert find_high_activation_crop(act) == \
        jax_push.find_high_activation_crop(act)
    assert find_high_activation_crop(np.zeros((8, 8))) == (0, 8, 0, 8)


class _JaxModel:
    """What the JAX push reads of a model: the trunk's conv chain and the
    prototype shape."""
    features = resnet_features("resnet18")
    prototype_shape = (P, D, 1, 1)


@pytest.fixture(scope="module")
def pushed(tmp_path_factory):
    rng = np.random.default_rng(4)
    batches = []
    for b in range(3):
        batches.append({
            "cine": rng.normal(size=(4, IMG, IMG, 3)).astype(np.float32),
            "target_AS": np.array([(b + i) % K for i in range(4)],
                                  np.int32),
            "valid": np.array([True] * 4 if b < 2
                              else [True, True, True, False])})
    jm = jax_build_model(dict(CFG, head_impl="xla"))
    params, stats = init_model(jm, jnp.asarray(batches[0]["cine"][:1]),
                               seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(stats))
    ident = prototype_class_identity(P, K)
    push_fwd = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, train=False,
        method=jm.push_forward))
    root = tmp_path_factory.mktemp("push")
    j_params, j_info = jax_push.push_prototypes_patch(
        [dict(b, cine=jnp.asarray(b["cine"])) for b in batches], push_fwd,
        params, stats, _JaxModel(), class_identity=ident,
        root_dir_for_saving_prototypes=str(root / "jax"), epoch_number=0,
        replace_prototypes=True, img_size=IMG, render=False)

    tm = build_model(CFG, device="cpu")
    load_jax_variables(tm, params, stats)

    def push_step(cine):
        with torch.no_grad():
            return tm.eval().push_forward(cine)

    t_vectors, t_info = push_prototypes_patch(
        [dict(b, cine=torch.from_numpy(b["cine"])) for b in batches],
        push_step, tm, class_identity=ident,
        root_dir_for_saving_prototypes=str(root / "port"), epoch_number=0,
        replace_prototypes=True, img_size=IMG, render=True)
    return dict(j_vectors=np.asarray(j_params["prototype_vectors"]),
                j_info=j_info, t_vectors=t_vectors, t_info=t_info,
                root=root, before=params["prototype_vectors"])


def test_winners_and_boxes_match(pushed):
    j, t = pushed["j_info"], pushed["t_info"]
    assert set(t) == set(j)
    np.testing.assert_array_equal(t["bb"], j["bb"])
    np.testing.assert_array_equal(t["bb_rf"], j["bb_rf"])
    np.testing.assert_array_equal(t["prototypes_gts"], j["prototypes_gts"])
    np.testing.assert_allclose(t["prototypes_distances"],
                               j["prototypes_distances"], rtol=1e-5)
    # every prototype matched, some in the second and third batch (global
    # indices past the first batch's four)
    assert (t["prototypes_gts"] >= 0).all()
    assert t["bb"][:, 0].max() >= 4


def test_files_match(pushed):
    port = pushed["root"] / "port" / "epoch-0"
    ref = pushed["root"] / "jax" / "epoch-0"
    for name in ("bb.npy", "bb-receptive_field.npy"):
        np.testing.assert_array_equal(np.load(port / name),
                                      np.load(ref / name))
    with open(port / "prototypes_info.pickle", "rb") as f:
        got = pickle.load(f)
    with open(ref / "prototypes_info.pickle", "rb") as f:
        want = pickle.load(f)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert len(list(port.glob("prototype-img*.png"))) == P


def test_replaced_vectors_match(pushed):
    got = pushed["t_vectors"].numpy()
    np.testing.assert_allclose(got, pushed["j_vectors"], rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(got, pushed["before"])


class _StubFeatures:
    def conv_info(self):
        return [3], [1], [1]  # one 3x3 stride-1 conv


class _StubModel:
    prototype_shape = (2, 2, 1, 1)
    features = _StubFeatures()

    def __init__(self, vectors):
        self.prototype_vectors = torch.from_numpy(vectors)


def _stub_push(batches, vectors):
    """The port's push over batches that carry their own conv (B,1,1,D)
    and dist (B,1,1,P); the push step returns them."""
    by_key = {float(b["cine"][0, 0, 0, 0]): b for b in batches}

    def push_step(cine):
        b = by_key[float(cine[0, 0, 0, 0])]
        return torch.from_numpy(b["conv"]), torch.from_numpy(b["dist"])

    loader = [dict(b, cine=torch.from_numpy(b["cine"])) for b in batches]
    return push_prototypes_patch(loader, push_step, _StubModel(vectors),
                                 class_identity=np.eye(2, dtype=np.float32),
                                 render=False, img_size=8)


def _mk_batch(key, gts, dists, convs):
    b = len(gts)
    cine = np.zeros((b, 1, 1, 3), np.float32)
    cine[0, 0, 0, 0] = key  # the marker the stub push step dispatches on
    return {"cine": cine,
            "conv": np.asarray(convs, np.float32).reshape(b, 1, 1, -1),
            "dist": np.asarray(dists, np.float32).reshape(b, 1, 1, -1),
            "target_AS": np.asarray(gts, np.int32), "valid": np.ones(b, bool)}


def test_class_without_samples_stays_unmatched():
    """The isfinite guard: with no class-1 sample, prototype 1 is not
    'improved' by the all-masked argmin's inf; it keeps its vector."""
    vectors = np.arange(4, dtype=np.float32).reshape(2, 1, 1, 2)
    batches = [_mk_batch(1.0, [0, 0], [[0.4, 0.2], [0.3, 0.1]],
                         [[1, 1], [2, 2]])]
    new, info = _stub_push(batches, vectors)
    assert np.isinf(info["prototypes_distances"][1])
    assert info["prototypes_gts"][1] == -1
    np.testing.assert_array_equal(new.numpy()[1], vectors[1])
    assert np.isclose(info["prototypes_distances"][0], 0.3)
    np.testing.assert_allclose(new.numpy()[0, 0, 0], [2, 2])


def test_bb_holds_the_global_sample_index():
    """Column 0 of bb and bb_rf: the index in the loader's whole order."""
    batches = [
        _mk_batch(1.0, [0, 1], [[0.9, 0.9], [0.9, 0.9]], [[1, 1], [2, 2]]),
        _mk_batch(2.0, [1, 0], [[0.9, 0.2], [0.1, 0.9]], [[3, 3], [4, 4]]),
    ]
    _, info = _stub_push(batches, np.zeros((2, 1, 1, 2), np.float32))
    assert info["bb"][0, 0] == 3 and info["bb"][1, 0] == 2
    assert info["bb_rf"][0, 0] == 3 and info["bb_rf"][1, 0] == 2
