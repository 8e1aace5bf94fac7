"""The port's trainer and train CLI at 2 data-parallel ranks on the CPU:
real gloo processes started through tests/test_torch_port_ddp.py's
``run_ranks`` (a ``file://`` rendezvous, one torch thread and 300 s a
rank), on a tiny KITTI-layout tree of 5 train lines (an odd count: the
ranks' shards give 3 and 2 batches) and 3 val lines at 64x96, batch 1 a
rank. One pair of rank processes trains an epoch, restores ``last`` and
trains a second, meets a val list of one line, and last runs the train CLI
as torchrun starts it (RANK, WORLD_SIZE and LOCAL_RANK set)."""

import json
import os

import numpy as np
import pytest

from movedepth_tpu_torch import Config
from test_torch_port_ddp import DRIVE, run_ranks


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    """A tiny KITTI tree with 5 train lines and 3 val lines (a one-line
    val list beside them), trained at 2 ranks x 1 row."""
    from PIL import Image
    root = tmp_path_factory.mktemp("ddp_trainer")
    img_dir = root / DRIVE / "image_02" / "data"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        small = rng.uniform(0, 255, (8, 12, 3))
        arr = np.repeat(np.repeat(small, 8, 0), 8, 1).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{i:010d}.jpg")
    for split, train, val in (("tiny", range(1, 6), range(5, 8)),
                              ("oneval", range(1, 6), range(6, 7))):
        d = root / "splits" / split
        d.mkdir(parents=True)
        (d / "train_files.txt").write_text(
            "\n".join(f"{DRIVE} {i} l" for i in train))
        (d / "val_files.txt").write_text(
            "\n".join(f"{DRIVE} {i} l" for i in val))
    cfg = Config(data_path=str(root), log_dir=str(root / "log"),
                 model_name="t", split="tiny", height=64, width=96,
                 batch_size=1, num_depth_bins=8, num_epochs=1,
                 num_workers=1, log_frequency=2, compute_dtype="float32",
                 seed=0, weights_init="scratch", kernel_l1=True)
    cli_argv = ["--data_path", str(root), "--log_dir", str(root / "cli"),
                "--model_name", "cli", "--split", "tiny", "--splits_dir",
                str(root / "splits"), "--height", "64", "--width", "96",
                "--batch_size", "1", "--num_depth_bins", "8",
                "--num_epochs", "1", "--num_workers", "1",
                "--log_frequency", "2", "--compute_dtype", "float32",
                "--weights_init", "scratch", "--kernel_l1", "--device",
                "cpu"]
    spec = {"cfg": cfg.to_json(), "splits": str(root / "splits"),
            "cli_argv": cli_argv}
    return root, run_ranks(root, "trainer", spec)


def test_ddp_trainer_shards_and_min_steps(trainer_ranks):
    """Disjoint rank-strided shards of 5 train and 3 val lines; 3 and 2
    batches of 1, and both ranks stop at 2 steps an epoch."""
    _, ranks = trainer_ranks
    train = [set(res["train_shard"].tolist()) for res in ranks]
    val = [set(res["val_shard"].tolist()) for res in ranks]
    assert not train[0] & train[1] and train[0] | train[1] == set(range(5))
    assert not val[0] & val[1] and val[0] | val[1] == set(range(3))
    assert [res["loader_len"] for res in ranks] == [3, 2]
    assert [res["steps_per_epoch"] for res in ranks] == [2, 2]
    assert [res["step"] for res in ranks] == [2, 2]


def test_ddp_trainer_logs_equal_losses(trainer_ranks):
    """Every logged loss dict (train and val, each step: the cadence is
    log_frequency // world) is the same on both ranks and finite."""
    _, ranks = trainer_ranks
    a, b = ranks[0]["logged"], ranks[1]["logged"]
    assert len(a) == len(b) == 4
    assert a == b
    assert all(np.isfinite(v) for d in a for v in d.values())


def test_ddp_trainer_rank0_writes(trainer_ranks):
    """Rank 0 alone saves (weights_0 and last, once each) and writes one
    jsonl of metrics, each (mode, step) once; rank 1 prints nothing of the
    trainer's (its lines are the CLI's own three: under a group every
    step of the process, 2 in each of its three trainings, is eager)."""
    root, ranks = trainer_ranks
    assert [len(res["saves"]) for res in ranks] == [2, 0]
    models_dir = root / "log" / "t" / "models"
    assert sorted(os.listdir(models_dir)) == ["last", "opt.json",
                                              "weights_0"]
    with open(root / "log" / "t" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert sorted((r["mode"], r["step"]) for r in rows) == [
        ("train", 0), ("train", 1), ("val", 0), ("val", 1)]
    assert "epoch 0: 2 steps" in ranks[0]["stdout"]
    lines = ranks[1]["stdout"].splitlines()
    assert [ln.split(":")[0] for ln in lines] \
        == ["dist", "kernel launches", "train steps"]
    assert json.loads(lines[2].split(": ", 1)[1]) == {
        "train.step_graph_captures": 0, "train.step_graph_replays": 0,
        "train.step_eager": 6}


def test_ddp_trainer_restores_on_every_rank(trainer_ranks):
    """Both ranks restore ``last``: the step clock resumes at 2, the
    weights, BatchNorm statistics and Adam's state are the trained ones
    and equal across ranks, and after the second epoch (step 4) they are
    still equal (each rank's largest difference from rank 0 is 0)."""
    _, ranks = trainer_ranks
    assert [res["resumed_step"] for res in ranks] == [2, 2]
    assert [res["final_step"] for res in ranks] == [4, 4]
    for res in ranks:
        count, trained = res["restored_count"]
        assert count == trained and res["adam_states"] > 0
        assert res["restored_diff"] == 0.0
        assert res["trained_gap"] == res["resumed_gap"] == 0.0
        assert res["final_gap"] == 0.0


def test_ddp_trainer_refuses_an_empty_val_shard(trainer_ranks):
    root, ranks = trainer_ranks
    for res in ranks:
        msg = res["oneval_error"]
        assert "rank 1 of 2" in msg, msg
        assert str(root / "splits" / "oneval" / "val_files.txt") in msg


# ------------------------------------------------------------ CLI

def test_cli_train_under_a_process_group(trainer_ranks, tmp_path):
    """The train CLI as torchrun starts it (RANK, WORLD_SIZE, LOCAL_RANK
    set; the group formed through a file:// rendezvous): each rank says
    its backend, rank and device, trains 2 steps, and rank 0 writes the
    checkpoints."""
    root, _ = trainer_ranks
    argv = ["--data_path", str(root), "--log_dir", str(tmp_path / "log"),
            "--model_name", "cli", "--split", "tiny", "--splits_dir",
            str(root / "splits"), "--height", "64", "--width", "96",
            "--batch_size", "1", "--num_depth_bins", "8", "--num_epochs",
            "1", "--num_workers", "1", "--log_frequency", "2",
            "--compute_dtype", "float32", "--weights_init", "scratch",
            "--kernel_l1", "--device", "cpu"]
    ranks = run_ranks(tmp_path, "cli", {"argv": argv})
    for r, res in enumerate(ranks):
        assert (f"dist: backend gloo, rank {r} of 2, device cpu"
                in res["stdout"]), res["stdout"]
        assert res["step"] == 2 and res["rank"] == r
        assert "kernel launches: " in res["stdout"]
    assert sorted(os.listdir(tmp_path / "log" / "cli" / "models")) == [
        "last", "opt.json", "weights_0"]


def test_cli_train_under_a_process_group(trainer_ranks):
    """The train CLI as torchrun starts it (the group formed through a
    file:// rendezvous): each rank says its backend, rank and device and
    trains 2 steps, and rank 0 writes the checkpoints."""
    root, ranks = trainer_ranks
    for r, res in enumerate(ranks):
        assert (f"dist: backend gloo, rank {r} of 2, device cpu"
                in res["stdout"]), res["stdout"]
        assert res["cli"] == {"step": 2, "rank": r}
        assert "kernel launches: " in res["stdout"]
    assert sorted(os.listdir(root / "cli" / "cli" / "models")) == [
        "last", "opt.json", "weights_0"]
