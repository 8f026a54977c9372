"""The last public names of the JAX package that the port lacked, each held
against the JAX package on the CPU:

- ``XProtoNet.occurrence_map_softmaxed`` on trunk features, image and
  video, at the JAX weights (as ``tests/test_models.py``'s test of it);
- ``explain/render.py``'s ``heatmap_clip`` (equal to the JAX function,
  and composed as ``tests/test_misc_utils.py`` holds it), ``write_video``,
  ``write_gif`` and ``remove_images``;
- ``serve.bundle_input_spec``: a bundle's input shape and dtype from its
  ``config.json`` with the model builder made to raise, equal to what
  ``load_serving_bundle_with_spec`` returns;
- ``BaseAgent.print_model_summary``: the parameter count of each
  top-level submodule equal to the JAX agent's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.explain import render as jax_render
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.train.agents import build_agent as jax_build_agent
from protoasnet_tpu_torch import serve
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.explain import render
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.train.agents import build_agent
from torch_port_isolation import isolated
from torch_port_jax_agents import agent_config

_isolated = isolated(2)

MODELS = {
    "image": ({"name": "XProtoNet", "base_architecture": "resnet18",
               "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
               "img_size": 32}, (2, 32, 32, 3)),
    "video": ({"name": "Video_XProtoNet",
               "base_architecture": "resnet2p1d_18",
               "backbone_last_layer_num": -3,
               "prototype_shape": (8, 64, 1, 1, 1), "num_classes": 4,
               "img_size": 32}, (2, 8, 32, 32, 3)),
}


@pytest.mark.parametrize("which", sorted(MODELS))
def test_occurrence_map_softmaxed_equals_jax(which):
    cfg, shape = MODELS[which]
    jm = jax_build_model(cfg)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    params, stats = init_model(jm, jnp.asarray(x), seed=0)
    variables = {"params": params, "batch_stats": stats}
    fmap = jm.apply(variables, jnp.asarray(x), train=False,
                    method=lambda m, a, train: m.cnn_backbone(a, train))
    ref = np.asarray(jm.apply(
        variables, fmap, method=lambda m, f: m.occurrence_map_softmaxed(f)))
    tm = build_model(cfg, device="cpu")
    load_jax_variables(tm, jax.device_get(params), jax.device_get(stats))
    with torch.no_grad():
        got = tm.occurrence_map_softmaxed(
            torch.from_numpy(np.array(fmap))).numpy()
        # and on the port's own trunk features
        own = tm.occurrence_map_softmaxed(
            tm._features(torch.from_numpy(x))).numpy()
    assert got.shape == ref.shape == (*fmap.shape[:-1], 8)
    n = got.shape[0]
    np.testing.assert_allclose(got.reshape(n, -1, 8).sum(axis=1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(own, ref, rtol=1e-3, atol=1e-5)


def test_heatmap_clip_equals_jax_and_composes_per_frame():
    rng = np.random.default_rng(7)
    t, h, w = 3, 40, 44
    img = rng.uniform(size=(t, h, w, 3)).astype(np.float32)
    up = rng.uniform(size=(t, h, w)).astype(np.float32)
    np.testing.assert_array_equal(render.heatmap_clip(up),
                                  jax_render.heatmap_clip(up))
    labels = ("input", "input overlay")
    fast = render.compose_panel_clip(
        [img, 0.5 * img + 0.3 * render.heatmap_clip(up)], "a title",
        labels=labels)
    for i in range(t):
        ref = render.compose_panel_frame(
            [img[i], 0.5 * img[i] + 0.3 * render.make_heatmap(up[i])],
            "a title", labels=labels)
        np.testing.assert_array_equal(fast[i], ref, err_msg=f"frame {i}")


def _frames(tmp_path, n=3):
    from PIL import Image

    rng = np.random.default_rng(1)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"f{i}.png")
        arr = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
        if i == 1:  # a grayscale frame: write_video makes it RGB
            arr = arr[..., 0]
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def test_write_video_gif_and_remove_images_as_jax(tmp_path):
    import imageio.v2 as imageio

    paths = _frames(tmp_path)
    ok = render.write_video(paths, str(tmp_path / "port.mp4"))
    assert ok == jax_render.write_video(paths, str(tmp_path / "jax.mp4"))
    assert ok and (tmp_path / "port.mp4").stat().st_size > 0
    same = [p for i, p in enumerate(paths) if i != 1]  # RGB frames
    render.write_gif(same, str(tmp_path / "port.gif"), fps=4)
    jax_render.write_gif(same, str(tmp_path / "jax.gif"), fps=4)
    got = imageio.mimread(str(tmp_path / "port.gif"))
    ref = imageio.mimread(str(tmp_path / "jax.gif"))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    render.remove_images(paths + [str(tmp_path / "missing.png")])
    assert not any((tmp_path / f"f{i}.png").exists() for i in range(3))


@pytest.mark.parametrize("uint8_gray", [False, True])
def test_bundle_input_spec_builds_no_model(tmp_path, monkeypatch,
                                           uint8_gray):
    cfg, shape = MODELS["image"]
    model = build_model(cfg, device="cpu")
    path = str(tmp_path / "b.zip")
    serve.save_serving_bundle(path, model, cfg, shape[1:],
                              uint8_gray=uint8_gray)
    _, want_shape, want_dtype = serve.load_serving_bundle_with_spec(
        path, device="cpu")

    def no_build(*a, **kw):
        raise AssertionError("bundle_input_spec built a model")

    monkeypatch.setattr(serve, "build_model", no_build)
    got = serve.bundle_input_spec(path)
    assert got == (want_shape, want_dtype)
    assert got == (((None, 32, 32) if uint8_gray else (None, 32, 32, 3)),
                   np.dtype(np.uint8 if uint8_gray else np.float32))


@pytest.mark.parametrize("name", ["Video_XProtoNet_e2e", "XProtoNet_Base",
                                  "ProtoPNet_Base"])
def test_print_model_summary_counts_equal_the_jax_agent(name, tmp_path,
                                                        caplog):
    csv = make_synthetic_dataset(str(tmp_path / "data"), num_videos=6,
                                 seed=3)
    cfg = agent_config(name, csv, str(tmp_path / "run"))
    jax_agent = jax_build_agent(cfg)
    ref = {top: sum(int(np.size(a)) for a in jax.tree_util.tree_leaves(sub))
           for top, sub in jax_agent.params.items()}
    agent = build_agent(agent_config(name, csv, str(tmp_path / "run2")))
    with caplog.at_level("INFO"):
        got = agent.print_model_summary()
    assert got == ref
    for top, n in ref.items():
        assert f"  {top}: {n / 1e6:.3f}M params" in caplog.text
