"""The port's data path against the JAX package's, on the CPU: KITTI
dataset items and loader batches on the same tree with the same seed
(train with augmentation and flips, val), the nearest-neighbour depth-map
resize and the during-training Garg metrics written without OpenCV against
the JAX package's OpenCV versions."""

import cv2
import numpy as np
import pytest
from PIL import Image

from movedepth_tpu.data import kitti as JK
from movedepth_tpu.data.loader import Loader as JaxLoader
from movedepth_tpu.train.trainer import (
    garg_depth_metrics as jax_garg_depth_metrics,
)
from movedepth_tpu_torch.data import kitti as K
from movedepth_tpu_torch.data.loader import Loader, ShardedIndexSampler
from movedepth_tpu_torch.train.trainer import garg_depth_metrics

DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
SEED = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 JPEG frames of 160x48 (a texture panned 4 pixels a frame), 5 train
    lines and 2 val lines."""
    root = tmp_path_factory.mktemp("kitti_port")
    img_dir = root / DRIVE / "image_02" / "data"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    pan = Image.fromarray(rng.uniform(0, 255, (12, 48, 3)).astype(np.uint8))
    pan = pan.resize((160 + 32, 48), Image.BICUBIC)
    for i in range(8):
        pan.crop((4 * i, 0, 4 * i + 160, 48)).save(img_dir / f"{i:010d}.jpg")
    return str(root)


def _datasets(tree, is_train, lines):
    files = [f"{DRIVE} {i} l" for i in lines]
    kw = dict(height=32, width=64, frame_ids=(0, -1, 1), is_train=is_train,
              seed=SEED)
    return (K.KITTIRawDataset(tree, files, **kw),
            JK.KITTIRawDataset(tree, files, native=False, **kw))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("is_train", [True, False])
def test_dataset_items_match_jax(tree, is_train):
    port, jax_ds = _datasets(tree, is_train, range(1, 7))
    flips = augs = 0
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            _assert_same(port[i], jax_ds[i])
            rng = port._rng(i)
            aug, flip = rng.random() > 0.5, rng.random() > 0.5
            augs += aug and is_train
            flips += flip and is_train
    if is_train:  # the samples above include jittered and flipped ones
        assert augs and flips


def test_loader_batches_match_jax(tree):
    port, jax_ds = _datasets(tree, True, range(1, 6))
    got_loader = Loader(port, 2, num_workers=2, seed=SEED)
    want_loader = JaxLoader(jax_ds, 2, num_workers=2, seed=SEED)
    assert len(got_loader) == len(want_loader) == 2
    for epoch in (0, 1):
        got = list(got_loader.epoch(epoch))
        want = list(want_loader.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)


def test_sampler_shards_and_drops_last():
    s = ShardedIndexSampler(11, 2, rank=1, world_size=2, seed=4)
    idx = s.epoch_indices(0)
    assert len(s) == 2 and len(idx) == 4
    assert sorted(np.random.default_rng(np.random.SeedSequence(
        [4, 0])).permutation(11)[1::2][:4]) == sorted(idx)


def test_loader_raises_a_failed_sample(tree):
    port, _ = _datasets(tree, False, [1, 99])  # frame 99 does not exist
    with pytest.raises(FileNotFoundError):
        list(Loader(port, 2, shuffle=False, drop_last=False,
                    num_workers=2).epoch(0))


@pytest.mark.parametrize("shape", [(375, 1242), (376, 1241), (370, 1226),
                                   (48, 160)])
def test_resize_nearest_matches_opencv(shape):
    depth = np.random.default_rng(1).uniform(0, 80, shape)
    want = cv2.resize(depth, K.FULL_RES, interpolation=cv2.INTER_NEAREST)
    got = K.resize_nearest(depth, K.FULL_RES)
    assert got.shape == want.shape == (375, 1242)
    np.testing.assert_array_equal(got, want)


def test_garg_depth_metrics_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.uniform(2, 60, (2, 48, 160)).astype(np.float32)
    gt = np.zeros((2, 375, 1242), np.float32)
    hit = rng.random(gt.shape) < 0.05
    gt[hit] = rng.uniform(1, 90, hit.sum()).astype(np.float32)
    got = garg_depth_metrics(pred, gt)
    want = jax_garg_depth_metrics(pred, gt)
    assert sorted(got) == sorted(want) and len(got) == 7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert garg_depth_metrics(pred, np.zeros_like(gt)) == {}
