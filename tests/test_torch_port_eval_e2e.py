"""The port's evaluation end to end against the JAX package's: the
predicted disparities of ``predict_disparities`` and the metric tables of
the two evaluation CLIs, on a synthetic KITTI tree (64x96, 8 bins,
float32) and the same weights.

The weights are the port's seeded models, carried to the JAX side by its
own converter (``train/torch_import``), as tests/test_torch_port_pipeline.py
does; the JAX side runs as its own tests run it on the CPU (its XLA path).
Tolerances are test_torch_port_pipeline's ``test_forward_infer_fused``:
``disp_mono`` atol 2e-5, ``disp_fused`` rtol 1e-4 / atol 1e-6,
``disp_mvs`` atol 1e-4; the printed tables (3 decimals) within 0.001.
"""

import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from movedepth_tpu.cli import evaluate as jax_cli_evaluate
from movedepth_tpu.config import Config as JaxConfig
from movedepth_tpu.eval import evaluate as JE
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch import Config
from movedepth_tpu_torch.cli import evaluate as port_cli_evaluate
from movedepth_tpu_torch.eval import evaluate as E
from movedepth_tpu_torch.models import build_models
from test_torch_port_pipeline import _state_dicts

H, W = 64, 96
KW = dict(height=H, width=W, num_depth_bins=8, compute_dtype="float32",
          num_workers=2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 frames of one drive, 3 eigen test lines (frames 1-3, each with its
    previous frame), GT maps at a GT-native 96x320, and the weights as a
    reference .pth folder."""
    root = tmp_path_factory.mktemp("evalkitti")
    drive = "2011_09_26/2011_09_26_drive_0002_sync"
    img_dir = root / drive / "image_02" / "data"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(4):
        small = rng.uniform(0, 255, (8, 12, 3))
        arr = np.repeat(np.repeat(small, 8, 0), 8, 1).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{i:010d}.jpg")
    split_dir = root / "splits" / "eigen"
    split_dir.mkdir(parents=True)
    (split_dir / "test_files.txt").write_text(
        "\n".join(f"{drive} {i} l" for i in (1, 2, 3)))
    gt = np.empty(3, dtype=object)
    for i in range(3):
        gt[i] = rng.uniform(5, 60, (96, 320)).astype(np.float32)
    np.savez_compressed(split_dir / "gt_depths.npz", data=gt)

    states = _state_dicts(Config(**KW))
    weights = root / "weights"
    weights.mkdir()
    for name, sd in states.items():
        torch.save(sd, weights / f"{name}.pth")
    return root, split_dir, weights, states


def _port_models(states, cfg):
    models = build_models(cfg, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
    return models


def _jax_variables(states):
    return {name: TI.convert_state_dict(
        name, {k: v.numpy() for k, v in sd.items()})
        for name, sd in states.items()}


@pytest.mark.parametrize("batch_size,post_process", [(1, False), (2, True)])
def test_predict_disparities_matches_jax(tree, batch_size, post_process):
    """Batch 1, and batch 2 with the flipped second pass: 3 lines make a
    partial last batch, so the forward sees two batch sizes."""
    root, split_dir, _, states = tree
    cfg = Config(**KW, post_process=post_process)
    got = E.predict_disparities(_port_models(states, cfg), cfg, str(root),
                                str(split_dir), batch_size, num_workers=2,
                                device="cpu")
    want = JE.predict_disparities(
        _jax_variables(states), JaxConfig(**KW, post_process=post_process),
        str(root), str(split_dir), batch_size, num_workers=2)
    for g, w, tol, name in zip(got, want, (dict(atol=2e-5), dict(atol=1e-4),
                                           dict(rtol=1e-4, atol=1e-6)),
                               ("mono", "mvs", "fused")):
        assert g.shape == w.shape == (3, H, W), name
        assert g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _tables(text):
    """{name: [7 floats]} from print_tables' text."""
    return {m.group(1): [float(v) for v in re.findall(r"-?\d+\.\d+",
                                                      m.group(2))]
            for m in re.finditer(r"(\w+) results:\n.*\n(&.*)\n", text)}


def test_cli_evaluate_matches_jax_cli(tree, capsys, monkeypatch):
    """Both evaluation CLIs on the same tree and .pth folder print the
    same four tables within the printed precision; the port's also prints
    its kernel launches (none on the CPU: the plain version runs)."""
    root, _, weights, _ = tree
    args = ["--data_path", str(root), "--load_weights_folder", str(weights),
            "--splits_dir", str(root / "splits"), "--height", str(H),
            "--width", str(W), "--num_depth_bins", "8", "--compute_dtype",
            "float32", "--num_workers", "2", "--batch_size", "2"]
    port_cli_evaluate.main(args + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    # the JAX package's tables go to the stdout of its import time
    jax_text = io.StringIO()
    jax_print = JE.print_tables
    monkeypatch.setattr(JE, "print_tables",
                        lambda results: jax_print(results, file=jax_text))
    jax_cli_evaluate.main(args)
    jax_out = jax_text.getvalue()
    got, want = _tables(port_out), _tables(jax_out)
    assert list(got) == list(want) == ["mono", "mvs", "fused", "upbound"]
    for name in want:
        assert len(got[name]) == 7 and all(np.isfinite(got[name]))
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=1e-3 + 1e-9, err_msg=name)
    assert got["upbound"][0] <= min(got["mono"][0], got["mvs"][0])
    assert 'kernel launches: {"sweep_warp_corr": 0}' in port_out


def test_evaluate_limit_and_gt_path(tree, capsys, tmp_path):
    """``limit`` truncates the lines and the GT alike; ``gt_path`` replaces
    the split's GT file."""
    root, split_dir, _, states = tree
    cfg = Config(**KW)
    gt = np.load(split_dir / "gt_depths.npz", allow_pickle=True)["data"]
    np.savez_compressed(tmp_path / "gt.npz", data=gt)
    results = E.evaluate(_port_models(states, cfg), cfg, str(root),
                         str(split_dir), gt_path=str(tmp_path / "gt.npz"),
                         batch_size=1, limit=2, device="cpu", num_workers=2)
    mono, mvs, fused = E.predict_disparities(
        _port_models(states, cfg), cfg, str(root), str(split_dir), 1,
        num_workers=2, limit=2, device="cpu")
    want = E.evaluate_disparities(mono, mvs, gt[:2],
                                  pred_disps_fused=fused)
    assert sorted(results) == ["fused", "mono", "mvs", "upbound"]
    for k in want:
        np.testing.assert_array_equal(results[k], want[k])
    assert capsys.readouterr().out.count(" results:") == 4
    assert os.path.isfile(split_dir / "gt_depths.npz")
