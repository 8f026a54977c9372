"""The port's data pipeline against the JAX package's: the synthetic
fixture, the manifest and interval tables, the packed store, the loader's
uint8 windows and their order, and the device transforms.

The host side (numpy RNGs seeded ``SeedSequence([seed, epoch(,
batch)])``) is the same code in both packages, so the windows, their order
and their metadata must be equal, and with augmentation off the model
input too (within 1e-6: fp32 resampling in another order). With
augmentation on, the draws are JAX's, passed to the port; the transform
then agrees within 1e-5 (fp32 products of up to five banded weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.data import dataset as jds
from protoasnet_tpu.data import transforms as jtr
from protoasnet_tpu.data.intervals import compute_intervals as j_intervals
from protoasnet_tpu.data.manifest import Manifest as JManifest
from protoasnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from protoasnet_tpu_torch.data import dataset as tds
from protoasnet_tpu_torch.data import transforms as ttr
from protoasnet_tpu_torch.data.intervals import compute_intervals
from protoasnet_tpu_torch.data.manifest import Manifest
from protoasnet_tpu_torch.data.native import native_available
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from torch_port_isolation import isolated

_isolated = isolated(1)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return (make_synthetic_dataset(str(root / "port"), num_videos=15,
                                   seed=5),
            j_synth(str(root / "jax"), num_videos=15, seed=5))


def _cfg(csv, store_dir, augment=False, **kw):
    cfg = {"data_info_file": csv, "view": "all", "sample_size": None,
           "sampler": "AS", "augmentation": augment,
           "transform_rotate_degrees": 10, "transform_min_crop_ratio": 0.7,
           "transform_time_dilation": 0.2, "normalize": True, "img_size": 32,
           "frames": 8, "batch_size": 3, "iterate_intervals": True,
           "interval_unit": "cycle", "interval_quant": 1.0,
           "store_cache_dir": str(store_dir), "num_workers": 1}
    cfg.update(kw)
    return cfg


def test_synthetic_fixture_matches_jax(csvs):
    port_csv, jax_csv = csvs
    p = Manifest.from_csv(port_csv, view="all", split="all")
    j = JManifest.from_csv(jax_csv, view="all", split="all")
    for col in ("view", "split", "as_label", "frames"):
        np.testing.assert_array_equal(p.columns[col], j.df[col].to_numpy(),
                                      err_msg=col)
    # pandas' default float parser is not round-trip exact (1 ulp off on
    # some values); the port reads the written repr exactly
    for col in ("frame_time", "heart_rate"):
        np.testing.assert_allclose(p.columns[col], j.df[col].to_numpy(),
                                   rtol=1e-15, atol=0, err_msg=col)
    for a, b in zip(p.paths, j.df["path"]):
        np.testing.assert_array_equal(np.load(a), np.load(b))


@pytest.mark.parametrize("view,split,sample", [
    ("all", "all", None), ("plax", "train", None), ("psax", "val", None),
    ("all", "train", 4), ("plax", "test", None)])
def test_manifest_and_intervals_match_jax(csvs, view, split, sample):
    csv = csvs[1]
    p = Manifest.from_csv(csv, view=view, split=split, sample_size=sample,
                          seed=3)
    j = JManifest.from_csv(csv, view=view, split=split, sample_size=sample,
                           seed=3)
    assert len(p) == len(j)
    np.testing.assert_array_equal(p.paths, j.paths)
    np.testing.assert_array_equal(p.labels, j.labels)
    np.testing.assert_array_equal(p.filenames, j.filenames)
    np.testing.assert_array_equal(p.window_size, j.window_size)
    np.testing.assert_array_equal(p.num_intervals, j.num_intervals)
    for f in ("video_idx", "interval_idx", "start_frame", "end_frame"):
        np.testing.assert_array_equal(getattr(p.intervals, f),
                                      getattr(j.intervals, f), err_msg=f)
    np.testing.assert_allclose(p.class_sample_weights(),
                               j.class_sample_weights())


@pytest.mark.parametrize("unit,quant", [("image", 5), ("second", 0.5),
                                        ("cycle", 1.0)])
def test_intervals_match_jax_including_empty(unit, quant):
    rng = np.random.default_rng(0)
    frames = rng.integers(3, 90, size=9)
    ft = rng.uniform(18, 35, size=9)
    hr = rng.uniform(55, 100, size=9)
    for sl in (slice(None), slice(0, 0)):  # slice(0, 0): the empty manifest
        pw, pn, pt = compute_intervals(frames[sl], ft[sl], hr[sl], unit,
                                       quant)
        jw, jn, jt = j_intervals(frames[sl], ft[sl], hr[sl], unit, quant)
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_array_equal(pn, jn)
        for f in ("video_idx", "interval_idx", "start_frame", "end_frame"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f))
        assert len(pt) == len(jt)


def test_packed_store_matches_jax(csvs, tmp_path):
    paths = list(JManifest.from_csv(csvs[1], view="all", split="all").paths)
    assert native_available()
    p = tds.CineStore.build(paths, 32, cache_dir=str(tmp_path / "p"))
    j = jds.CineStore.build(paths, 32, cache_dir=str(tmp_path / "j"))
    np.testing.assert_array_equal(p.offsets, j.offsets)
    np.testing.assert_array_equal(np.asarray(p._data), np.asarray(j._data))


META = ("video_idx", "target_AS", "interval_idx", "window_start",
        "window_end", "original_length", "t_len", "valid")


@pytest.mark.parametrize("split,mode", [("train", "train"), ("val", "val"),
                                        ("train", "push"), ("test", "test")])
def test_loader_windows_and_order_match_jax(csvs, tmp_path, split, mode):
    """One epoch (epoch 1, the per-epoch seeds in play), augmentation off:
    the same windows in the same order, the same model input."""
    csv = csvs[1]
    jl = jds.get_as_dataloader(_cfg(csv, tmp_path / "j"), split, mode,
                               seed=11)
    pl = tds.get_as_dataloader(_cfg(csv, tmp_path / "p", num_workers=2),
                               split, mode, seed=11, device="cpu")
    assert len(pl) == len(jl)
    jl.set_epoch(1)
    pl.set_epoch(1)
    batches = 0
    for jb, pb in zip(jl, pl):
        for k in META:
            np.testing.assert_array_equal(np.asarray(pb[k]),
                                          np.asarray(jb[k]), err_msg=k)
        assert list(pb["filename"]) == list(jb["filename"])
        np.testing.assert_allclose(pb["cine"].numpy(), np.asarray(jb["cine"]),
                                   rtol=0, atol=1e-6)
        assert pb["target_dev"].dtype == torch.int64
        assert pb["valid_dev"].dtype == torch.bool
        batches += 1
    assert batches == len(pl)


def test_train_windows_match_jax_with_augmentation(csvs, tmp_path):
    """Augmentation on: the host windows are still the JAX package's (only
    the device draws differ)."""
    csv = csvs[1]
    jl = jds.get_as_dataloader(_cfg(csv, tmp_path / "j", augment=True),
                               "train", "train", seed=4)
    pl = tds.get_as_dataloader(_cfg(csv, tmp_path / "p", augment=True),
                               "train", "train", seed=4, device="cpu")
    for jb, pb in zip(jl, pl):
        for k in META:
            np.testing.assert_array_equal(np.asarray(pb[k]),
                                          np.asarray(jb[k]), err_msg=k)
        assert pb["cine"].shape == tuple(np.asarray(jb["cine"]).shape)


@pytest.mark.parametrize("frames", [8, 1])
def test_preprocess_matches_jax(frames):
    """uint8 -> model input: identical with augmentation off; with JAX's
    draws injected, the same crop and rotation."""
    rng = np.random.default_rng(2)
    b, t_max, s = 4, 13, 24
    clips = rng.integers(0, 256, size=(b, t_max, s, s), dtype=np.uint8)
    t_len = np.array([13, 7, 1, 10], np.int32)
    key = jax.random.PRNGKey(9)
    for augment in (False, True):
        kw = dict(frames_out=frames, img_size=s, augment=augment,
                  rotate_degrees=12.0, min_crop_ratio=0.6)
        ref = np.asarray(jtr.make_preprocess_fn(**kw)(
            jnp.asarray(clips), jnp.asarray(t_len), key if augment else None))
        params = None
        if augment:
            draws = [jtr.sample_augment_params(k, s, 0.6, 12.0)
                     for k in jax.random.split(key, b)]
            params = tuple(torch.tensor([float(d[i]) for d in draws])
                           for i in range(5))
        got = ttr.make_preprocess_fn(**kw)(
            torch.from_numpy(clips), torch.from_numpy(t_len), params=params)
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 if augment else 1e-6)


def test_augment_draw_ranges():
    g = torch.Generator().manual_seed(0)
    top, left, h, w, angle = ttr.sample_augment_params(g, 2000, 32, 0.7, 15.0)
    area = h * w
    assert area.min() >= 0.7 * 32 * 32 * 0.99 and area.max() <= 32 * 32 + 1e-3
    assert (top >= 0).all() and (top + h <= 32 + 1e-4).all()
    assert (left >= 0).all() and (left + w <= 32 + 1e-4).all()
    assert angle.min() >= -15 and angle.max() <= 15 and angle.std() > 7
    ratio = w / h
    assert ratio.min() >= 0.75 - 1e-4 and ratio.max() <= 4 / 3 + 1e-4


def test_loader_is_deterministic_and_epoch_seeded(csvs, tmp_path):
    """Two loaders of one seed give the same augmented epoch; another epoch
    gives other windows."""
    cfg = _cfg(csvs[0], tmp_path / "p", augment=True)
    a = tds.get_as_dataloader(cfg, "train", "train", seed=1, device="cpu")
    b = tds.get_as_dataloader(cfg, "train", "train", seed=1, device="cpu")
    ea = [x["cine"] for x in a]
    assert all(torch.equal(x, y["cine"]) for x, y in zip(ea, b))
    b.set_epoch(1)
    assert not all(torch.equal(x, y["cine"]) for x, y in zip(ea, b))
