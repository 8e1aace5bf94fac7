"""The port's trainer and train CLI on the CPU, on a tiny KITTI-layout tree
(64x96, batch 2, 8 bins): epochs, checkpoints in the reference layout, the
step-derived resume, the mono warm start with its BatchNorm statistics,
ImageNet init from a torchvision-layout ``.pth``, the data loader the
trainer picks from ``native_loader``, and the CLI. The same checks as
tests/test_trainer.py makes of the JAX package's trainer."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from movedepth_tpu_torch import Config
from movedepth_tpu_torch import weights as W
from movedepth_tpu_torch.cli import train as cli_train
from movedepth_tpu_torch.data import native_loader as NL
from movedepth_tpu_torch.models import ResNetEncoder, build_models
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.train.logging import MetricsLogger
from movedepth_tpu_torch.train.trainer import Trainer

DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread here: the suite runs several test processes at
    once, and each one's intra-op threads competing with the loader's
    threads and the other processes made these runs ~15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_trainer")
    img_dir = root / DRIVE / "image_02" / "data"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        small = rng.uniform(0, 255, (8, 12, 3))
        arr = np.repeat(np.repeat(small, 8, 0), 8, 1).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{i:010d}.jpg")
    splits = root / "splits" / "tiny"
    splits.mkdir(parents=True)
    (splits / "train_files.txt").write_text(
        "\n".join(f"{DRIVE} {i} l" for i in range(1, 6)))
    (splits / "val_files.txt").write_text(f"{DRIVE} 6 l")
    return root, str(splits)


def make_cfg(root, **kw):
    base = dict(data_path=str(root), log_dir=str(root / "log"),
                model_name="t", split="tiny", height=64, width=96,
                batch_size=2, num_depth_bins=8, num_epochs=2, num_workers=2,
                log_frequency=2, compute_dtype="float32", seed=0,
                weights_init="scratch", kernel_l1=True)
    return Config(**dict(base, **kw))


def _models_dir(root, name):
    return os.path.join(str(root / "log"), name, "models")


@pytest.fixture(scope="module")
def trained(kitti_tree):
    root, splits = kitti_tree
    trainer = Trainer(make_cfg(root, save_intermediate_models=True),
                      split_dir=splits, device="cpu", profile_steps=1)
    assert len(trainer.train_loader) == 2  # 5 samples, batch 2, drop_last
    trainer.train()
    return trainer


def test_trainer_two_epochs_and_checkpoints(kitti_tree, trained):
    root, _ = kitti_tree
    assert trained.step == 4 and trained.epoch == 1
    models_dir = _models_dir(root, "t")
    with open(os.path.join(models_dir, "opt.json")) as f:
        assert Config.from_json(f.read()) == trained.cfg
    want = sorted([f"{m}.pth" for m in trained.models] + ["adam.pth"])
    # per-epoch folders, last, and the per-step snapshot of step 0
    for name in ("weights_0", "weights_1", "last", "weights_0_0"):
        assert sorted(os.listdir(os.path.join(models_dir, name))) == want
    saved = torch.load(os.path.join(models_dir, "last", "adam.pth"),
                       weights_only=False)
    assert saved["step"] == 4
    # --profile_steps 1: a torch.profiler trace of step 2
    with open(os.path.join(root / "log", "t", "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    # a checkpoint folder is a reference .pth folder
    fresh = build_models(trained.cfg, "cpu")
    assert sorted(W.load_reference_folder(
        os.path.join(models_dir, "last"), fresh)) == sorted(fresh)
    for name, model in fresh.items():
        for k, v in model.state_dict().items():
            assert torch.equal(v, trained.models[name].state_dict()[k]), k


def test_logger_writes_jsonl_without_tensorboardx(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logger = MetricsLogger(str(tmp_path), batch_size=2, num_total_steps=4)
    logger.log_scalars("train", {"loss": torch.tensor(0.5),
                                 "de/abs_rel": np.float64(0.1)}, 3)
    logger.log_images("train", {}, {}, 3)  # no writer: nothing to draw
    logger.close()
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(ln) for ln in f] == [
            {"mode": "train", "step": 3, "loss": 0.5, "de/abs_rel": 0.1}]


def test_trainer_resume_continues_the_step_clock(kitti_tree, trained,
                                                 monkeypatch):
    """A folder with adam.pth resumes at step 4 of a 4-epoch run: epochs 2
    and 3 only, use_z from the epoch clock, checkpoints numbered on."""
    root, splits = kitti_tree
    last = os.path.join(_models_dir(root, "t"), "last")
    cfg = make_cfg(root, load_weights_folder=last, model_name="t2",
                   num_epochs=4, ztrans_start_epc=2)
    trainer = Trainer(cfg, split_dir=splits, device="cpu")
    assert trainer.step == 4
    assert len(trainer.optimizer.state) > 0  # Adam's moments came back
    seen_use_z = []
    step = S.train_step

    def spy(models, opt, sched, batch, cfg, use_z, draws, group=None):
        seen_use_z.append(use_z)
        return step(models, opt, sched, batch, cfg, use_z, draws, group)

    monkeypatch.setattr(S, "train_step", spy)
    trainer.train()
    assert trainer.step == 8 and trainer.epoch == 3
    assert seen_use_z == [False, False, True, True]
    models_dir = _models_dir(root, "t2")
    assert os.path.isdir(os.path.join(models_dir, "weights_2"))
    assert os.path.isdir(os.path.join(models_dir, "weights_3"))
    assert not os.path.isdir(os.path.join(models_dir, "weights_0"))


@pytest.mark.parametrize("adam", ["none", "reference"])
def test_reference_folder_without_adam_starts_at_step_zero(kitti_tree,
                                                           trained,
                                                           tmp_path, adam):
    """No adam.pth, or the reference's (the optimizer's state_dict alone):
    the weights load and the run starts at step 0."""
    root, splits = kitti_tree
    folder = tmp_path / "ref"
    shutil.copytree(os.path.join(_models_dir(root, "t"), "last"), folder)
    os.remove(folder / "adam.pth")
    if adam == "reference":
        torch.save(trained.optimizer.state_dict(), folder / "adam.pth")
    trainer = Trainer(make_cfg(root, load_weights_folder=str(folder),
                               model_name="t_ref"), split_dir=splits,
                      device="cpu")
    assert trainer.step == 0 and len(trainer.optimizer.state) == 0
    w = trainer.models["reg3d"].state_dict()
    for k, v in trained.models["reg3d"].state_dict().items():
        assert torch.equal(w[k], v), k


def test_orbax_checkpoints_are_refused(kitti_tree, tmp_path):
    root, splits = kitti_tree
    orbax = tmp_path / "orbax_last"
    (orbax / "params").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        Trainer(make_cfg(root, load_weights_folder=str(orbax),
                         model_name="t_orbax"), split_dir=splits,
                device="cpu")


def test_trainer_mono_warm_start(kitti_tree):
    """The mono and pose models come from the donor with their BatchNorm
    statistics; the MVS models and the step stay fresh."""
    root, splits = kitti_tree
    donor = Trainer(make_cfg(root, model_name="t_donor", seed=123),
                    split_dir=splits, device="cpu")
    with torch.no_grad():
        donor.models["mono_encoder"].encoder.bn1.running_mean.fill_(0.3)
        donor.models["mono_encoder"].encoder.bn1.running_var.fill_(2.0)
    last = donor.save(last=True)
    trainer = Trainer(make_cfg(root, mono_weights_folder=last,
                               model_name="t3"), split_dir=splits,
                      device="cpu")
    for name in ("mono_encoder", "mono_depth", "pose_encoder", "pose"):
        got = trainer.models[name].state_dict()
        for k, v in donor.models[name].state_dict().items():
            assert torch.equal(got[k], v), (name, k)
    assert not torch.equal(
        trainer.models["reg3d"].conv0.conv.weight,
        donor.models["reg3d"].conv0.conv.weight)
    assert trainer.step == 0


def test_trainer_imagenet_init(kitti_tree, tmp_path, monkeypatch):
    """weights_init='pretrained' loads a torchvision-layout .pth into the
    mono and pose encoders, the pose conv1 tiled over 2 frames and
    halved."""
    enc = ResNetEncoder(18)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(3))
        enc.encoder.bn1.running_mean.fill_(0.25)
    sd = {k[len("encoder."):]: v for k, v in enc.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    pdir = tmp_path / "pretrain_resnet"
    pdir.mkdir()
    torch.save(sd, pdir / "resnet18-synthetic.pth")
    monkeypatch.setenv("PRETRAIN_RESNET_DIR", str(pdir))
    root, splits = kitti_tree
    trainer = Trainer(make_cfg(root, model_name="t_imagenet",
                               weights_init="pretrained"),
                      split_dir=splits, device="cpu")
    mono = trainer.models["mono_encoder"].state_dict()
    for k, v in enc.state_dict().items():
        assert torch.equal(mono[k], v), k
    pose = trainer.models["pose_encoder"].encoder.conv1.weight
    assert pose.shape[1] == 6
    torch.testing.assert_close(pose[:, :3], sd["conv1.weight"] / 2)
    torch.testing.assert_close(pose[:, 3:], sd["conv1.weight"] / 2)
    assert torch.equal(
        trainer.models["pose_encoder"].encoder.layer1[0].conv1.weight,
        sd["layer1.0.conv1.weight"])


def test_trainer_scratch_init_does_not_search(kitti_tree, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("scratch init must not look for weights")

    monkeypatch.setattr(W, "find_imagenet_weights", boom)
    monkeypatch.setattr(W, "load_imagenet_encoders", boom)
    root, splits = kitti_tree
    Trainer(make_cfg(root, model_name="t_scratch"), split_dir=splits,
            device="cpu")


def test_trainer_refuses_what_is_not_ported(kitti_tree):
    root, splits = kitti_tree
    trainer = Trainer(make_cfg(root, steps_per_dispatch=2,
                               model_name="t_multi"), split_dir=splits,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="steps_per_dispatch"):
        trainer.train()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(make_cfg(root), split_dir=splits)


@pytest.mark.parametrize("native_loader", [True, False])
def test_trainer_datasets_follow_native_loader(kitti_tree, capsys,
                                               native_loader):
    """Train and val datasets both read with the C++ loader unless
    native_loader is off, and the trainer says which at start-up."""
    root, splits = kitti_tree
    trainer = Trainer(make_cfg(root, native_loader=native_loader,
                               model_name=f"t_native_{native_loader}"),
                      split_dir=splits, device="cpu")
    out = capsys.readouterr().out
    if native_loader:
        loader = NL.get()
        assert trainer.train_dataset.native is loader
        assert trainer.val_dataset.native is loader
        assert f"data: native loader, route {loader.route} (" in out
    else:
        assert trainer.train_dataset.native is None
        assert trainer.val_dataset.native is None
        assert "data: PIL loader (--no-native_loader)" in out


def test_cli_train_one_epoch(kitti_tree, capsys):
    root, _ = kitti_tree
    trainer = cli_train.main([
        "--data_path", str(root), "--log_dir", str(root / "log"),
        "--model_name", "t_cli", "--split", "tiny", "--splits_dir",
        str(root / "splits"), "--height", "64", "--width", "96",
        "--batch_size", "2", "--num_depth_bins", "8", "--num_epochs", "1",
        "--num_workers", "2", "--log_frequency", "2", "--compute_dtype",
        "float32", "--weights_init", "scratch", "--kernel_l1",
        "--device", "cpu"])
    assert trainer.step == 2 and trainer.cfg.kernel_l1
    out = capsys.readouterr().out
    assert "epoch 0: 2 steps" in out
    assert "data: native loader, route " in out  # the default
    launches = json.loads(out.split("kernel launches: ")[1].splitlines()[0])
    assert launches and set(launches.values()) == {0}  # CPU: plain versions
    assert os.path.isdir(os.path.join(_models_dir(root, "t_cli"), "last"))
