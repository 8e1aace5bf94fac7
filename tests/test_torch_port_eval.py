"""The port's evaluation protocol against the JAX package's: metrics, the
eigen mask, post-processing, the metric tables, GT export, split lists,
the colormap and ``--save_png``.

Tolerances: ``ops/metrics`` rtol 1e-6 against the jnp metrics; the
``evaluate_disparities`` rows rtol 1e-5, atol 1e-5 (the JAX package
resizes with OpenCV, the port with torch's half-pixel bilinear rule: the
same in float64, a few 1e-4 apart in float32 (test_resize_depth_against_
opencv), so a pixel whose ratio to the GT lies that close to 1.25^k counts
on one side of a threshold in one package and on the other in the other;
the predictions are therefore those of a depth network, near the scene's
depth, not noise);
``batch_post_process_disparity``, ``eigen_mask``, ``print_tables``, the
colormap, the exported GT and the PNG bit for bit.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from movedepth_tpu.cli import import_splits as jax_import_splits
from movedepth_tpu.cli import infer as jax_infer
from movedepth_tpu.eval import evaluate as JE
from movedepth_tpu.eval.export_gt import export_gt_depths as jax_export_gt
from movedepth_tpu.ops import metrics as JM
from movedepth_tpu.train.logging import colormap as jax_colormap
from movedepth_tpu_torch import Config
from movedepth_tpu_torch.cli import evaluate as port_cli_evaluate
from movedepth_tpu_torch.cli import export_gt as port_cli_export_gt
from movedepth_tpu_torch.cli import import_splits as port_import_splits
from movedepth_tpu_torch.cli import infer as port_infer
from movedepth_tpu_torch.data import splits as SP
from movedepth_tpu_torch.eval import evaluate as E
from movedepth_tpu_torch.eval.export_gt import export_gt_depths
from movedepth_tpu_torch.ops import metrics as M
from movedepth_tpu_torch.ops.colormap import colormap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = os.path.join(REPO, "movedepth_tpu")

# KITTI's published calibration of the 2011_09_26 drives: 1242x375 images
CALIB_CAM = """S_rect_02: 1.242000e+03 3.750000e+02
R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 \
9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 \
0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 \
0.000000e+00 1.000000e+00 2.745884e-03
"""
CALIB_VELO = """R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 \
7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02
T: -4.069766e-03 -7.631618e-02 -2.717806e-01
"""
DRIVE = "2011_09_26/2011_09_26_drive_0002_sync"


def _tree_listing(root):
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.path.getmtime(os.path.join(d, f)))
                  for d, _, files in os.walk(root) for f in files
                  if "__pycache__" not in d)


# ------------------------------------------------------------- metrics

@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(rng, masked):
    gt = rng.uniform(1.0, 80.0, (6, 40, 50)).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    mask = (rng.uniform(size=gt.shape) > 0.4) if masked else None
    got = M.compute_depth_errors(
        torch.from_numpy(gt), torch.from_numpy(pred),
        None if mask is None else torch.from_numpy(mask))
    want = JM.compute_depth_errors(
        jnp.asarray(gt), jnp.asarray(pred),
        None if mask is None else jnp.asarray(mask))
    assert list(got) == list(M.METRIC_NAMES) == list(JM.METRIC_NAMES)
    for k in M.METRIC_NAMES:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_oracle_fuse_errors_match_jax(rng):
    gt = rng.uniform(1.0, 80.0, (3, 30, 40)).astype(np.float32)
    mono = (gt * rng.uniform(0.8, 1.3, gt.shape)).astype(np.float32)
    mvs = (gt * rng.uniform(0.7, 1.2, gt.shape)).astype(np.float32)
    got = M.oracle_fuse_errors(*(torch.from_numpy(a) for a in (gt, mono,
                                                               mvs)))
    want = JM.oracle_fuse_errors(*(jnp.asarray(a) for a in (gt, mono, mvs)))
    for k in M.METRIC_NAMES:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------ protocol

def _smooth(rng, shape, lo, hi):
    """A smooth random field in [lo, hi]: bilinear upsampling of a coarse
    grid of 1/16 the size."""
    coarse = torch.from_numpy(rng.uniform(lo, hi, (1, 1, shape[0] // 16 + 1,
                                                   shape[1] // 16 + 1)))
    return torch.nn.functional.interpolate(
        coarse, size=shape, mode="bicubic", align_corners=True)[0, 0] \
        .clamp(lo, hi).numpy()


def _scenes(rng, n, dtype=np.float32):
    """Sparse velodyne-like GTs at 375x1242 (~6% of pixels, some beyond the
    80 m cap) of smooth scenes, and predicted (192, 640) disparities of the
    same scenes as a depth network gives them: within ~15% of the scene's
    depth, up to a global scale (which median scaling removes)."""
    gts, preds = [], {"mono": [], "mvs": [], "fused": []}
    for _ in range(n):
        scene = _smooth(rng, (375, 1242), 3.0, 90.0)
        gt = np.zeros((375, 1242), np.float32)
        hit = rng.uniform(size=gt.shape) < 0.06
        gt[hit] = scene[hit] * rng.normal(1.0, 0.02, hit.sum())
        gts.append(gt)
        low = E.resize_depth(scene, (192, 640))
        for k, scale in (("mono", 0.031), ("mvs", 0.9), ("fused", 1.0)):
            err = _smooth(rng, (192, 640), 0.85, 1.15)
            preds[k].append((scale / (low * err)).astype(dtype))
    return gts, [np.stack(preds[k]) for k in ("mono", "mvs", "fused")]


@pytest.mark.parametrize("split,median,scale,fused,dtype", [
    ("eigen", True, 1.0, True, np.float32),
    ("eigen", False, 5.4, False, np.float32),
    ("eigen", True, 2.5, True, np.float64),  # post-processed predictions
    ("eigen_benchmark", True, 1.0, False, np.float32),
    ("eigen_benchmark", False, 3.0, True, np.float32),
])
def test_evaluate_disparities_matches_jax(rng, split, median, scale, fused,
                                          dtype):
    gts, (mono, mvs, fus) = _scenes(rng, 4, dtype)
    kw = dict(eval_split=split, disable_median_scaling=not median,
              pred_depth_scale_factor=scale,
              pred_disps_fused=fus if fused else None)
    got = E.evaluate_disparities(mono, mvs, gts, **kw)
    want = JE.evaluate_disparities(mono, mvs, gts, **kw)
    assert sorted(got) == sorted(want)
    assert ("fused" in got) == fused
    for k in want:
        assert got[k].shape == (7,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert got["upbound"][0] <= min(got["mono"][0], got["mvs"][0]) + 1e-9


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 5e-4)])
def test_resize_depth_against_opencv(rng, dtype, rtol):
    """The port's resize follows OpenCV's INTER_LINEAR rule: to rounding
    in float64; in float32 OpenCV's own arithmetic moves values by up to a
    few 1e-4 relative."""
    import cv2
    x = rng.uniform(0.02, 0.5, (192, 640)).astype(dtype)
    got = E.resize_depth(x, (375, 1242))
    want = cv2.resize(x, (1242, 375))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_batch_post_process_disparity_exact(rng):
    l = rng.uniform(0.01, 1.0, (3, 48, 160)).astype(np.float32)
    r = rng.uniform(0.01, 1.0, (3, 48, 160)).astype(np.float32)
    got = E.batch_post_process_disparity(l, r)
    want = JE.batch_post_process_disparity(l, r)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(375, 1242), (370, 1226), (96, 320)])
def test_eigen_mask_exact(rng, shape):
    gt = rng.uniform(-1.0, 90.0, shape).astype(np.float32)
    gt[rng.uniform(size=shape) < 0.3] = 0.0
    np.testing.assert_array_equal(E.eigen_mask(gt), JE.eigen_mask(gt))
    assert (E.MIN_DEPTH, E.MAX_DEPTH) == (JE.MIN_DEPTH, JE.MAX_DEPTH)


def test_print_tables_exact(rng):
    results = {k: rng.uniform(0, 10, 7) for k in ("mono", "mvs", "fused",
                                                   "upbound")}
    for subset in (results, {k: results[k] for k in ("mono", "mvs",
                                                      "upbound")}):
        got, want = io.StringIO(), io.StringIO()
        E.print_tables(subset, file=got)
        JE.print_tables(subset, file=want)
        assert got.getvalue() == want.getvalue()
    assert got.getvalue().count(" results:") == 3


# ------------------------------------------------------------ colormap

@pytest.mark.parametrize("case", ["random", "constant", "ends", "outside"])
@pytest.mark.parametrize("normalize", [True, False])
def test_colormap_matches_jax(rng, case, normalize):
    x = {"random": rng.uniform(0, 5, (13, 17)),
         "constant": np.full((4, 6), 2.5),
         "ends": np.array([[0.0, 1.0, 0.5], [1.0, 0.0, 255 / 256]]),
         "outside": np.array([[-0.5, 1.5, np.nan, 0.999]])}[case]
    got, want = colormap(x, normalize), jax_colormap(x, normalize)
    assert got.shape == want.shape == (3,) + x.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_colormap_needs_no_matplotlib():
    """The port's logging and serving CLI colour a map with matplotlib
    made unimportable."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import numpy as np\n"
            "from movedepth_tpu_torch.train.logging import colormap\n"
            "import movedepth_tpu_torch.cli.infer\n"
            "print(colormap(np.arange(12.0).reshape(3, 4)).shape)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "(3, 3, 4)"


def test_save_png_matches_jax(tmp_path):
    """``--save_png`` writes ``<name>_disp.png`` (H, W, 3) uint8 per frame,
    the JAX CLI's PNG of the same depth map bit for bit."""
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        Image.fromarray(rng.uniform(0, 255, (32, 48, 3)).astype(np.uint8)) \
            .save(frames / f"{i:04d}.png")
    weights = tmp_path / "weights"
    weights.mkdir()
    from movedepth_tpu_torch.models import build_models
    cfg = Config(height=64, width=96, compute_dtype="float32")
    for name, m in build_models(cfg, "cpu").items():
        torch.save(m.state_dict(), weights / f"{name}.pth")
    out = tmp_path / "out"
    port_infer.main(["--image_path", str(frames), "--load_weights_folder",
                     str(weights), "--out_dir", str(out), "--height", "64",
                     "--width", "96", "--compute_dtype", "float32",
                     "--mono_only", "--save_png", "--device", "cpu"])
    jax_out = tmp_path / "jax_out"
    jax_out.mkdir()
    for i in range(2):
        depth = np.load(out / f"{i:04d}_depth.npy")
        png = np.asarray(Image.open(out / f"{i:04d}_disp.png"))
        assert png.shape == (64, 96, 3) and png.dtype == np.uint8
        jax_infer._save_outputs(str(jax_out), f"{i:04d}", depth, True)
        np.testing.assert_array_equal(
            png, np.asarray(Image.open(jax_out / f"{i:04d}_disp.png")))


# -------------------------------------------------------------- splits

def test_split_file_order(tmp_path, monkeypatch):
    """An explicit split directory, then the port's splits (plain or
    gzipped), then the bundled lists."""
    port, bundled = tmp_path / "port", tmp_path / "bundled"
    monkeypatch.setattr(SP, "PORT_SPLITS", port)
    monkeypatch.setattr(SP, "BUNDLED_SPLITS", bundled)
    assert SP.split_file("eigen", "test_files.txt", "/x/eigen") == \
        os.path.join("/x/eigen", "test_files.txt")
    assert SP.split_file("eigen", "test_files.txt") == \
        str(bundled / "eigen" / "test_files.txt")
    (port / "eigen").mkdir(parents=True)
    (port / "eigen" / "gt_depths.npz").write_bytes(b"")
    # the port's directory holds the GT only: the list stays bundled
    assert SP.split_file("eigen", "test_files.txt") == \
        str(bundled / "eigen" / "test_files.txt")
    assert SP.split_file("eigen", "gt_depths.npz") == \
        str(port / "eigen" / "gt_depths.npz")
    (port / "eigen" / "test_files.txt.gz").write_bytes(b"")
    assert SP.split_file("eigen", "test_files.txt") == \
        str(port / "eigen" / "test_files.txt")


def test_bundled_eigen_split_resolves():
    from movedepth_tpu_torch.data.kitti import readlines
    path = SP.split_file("eigen", "test_files.txt")
    lines = readlines(path)
    assert len(lines) == 697 and len(lines[0].split()) == 3
    assert str(SP.BUNDLED_SPLITS) == os.path.join(JAX_PACKAGE, "splits")
    assert SP.PORT_SPLITS.parent.name == "movedepth_tpu_torch"


def test_import_splits_matches_jax(tmp_path):
    src = tmp_path / "src"
    for split, names in (("eigen", ("test_files.txt", "gt_depths.npz")),
                         ("eigen_zhou", ("train_files.txt", "val_files.txt",
                                         "notes.md"))):
        (src / split).mkdir(parents=True)
        for name in names:
            (src / split / name).write_text(f"{split}/{name}\n")
    (src / "README").write_text("not a split")
    got = port_import_splits.main([str(src), "--dst", str(tmp_path / "p")])
    want = jax_import_splits.import_splits(str(src), str(tmp_path / "j"))
    assert port_import_splits.WANTED == jax_import_splits.WANTED
    assert got == want == 4
    rel = lambda root: sorted(  # noqa: E731
        (os.path.relpath(os.path.join(d, f), root),
         open(os.path.join(d, f)).read())
        for d, _, fs in os.walk(root) for f in fs)
    assert rel(tmp_path / "p") == rel(tmp_path / "j")


def test_import_splits_default_destination(tmp_path, monkeypatch):
    """Without --dst the lists go to the port's own split directory."""
    (tmp_path / "src" / "eigen").mkdir(parents=True)
    (tmp_path / "src" / "eigen" / "test_files.txt").write_text("a 1 l")
    monkeypatch.setattr(SP, "PORT_SPLITS", tmp_path / "port")
    assert port_import_splits.main([str(tmp_path / "src")]) == 1
    assert (tmp_path / "port" / "eigen" / "test_files.txt").read_text() == \
        "a 1 l"
    assert SP.split_file("eigen", "test_files.txt") == \
        str(tmp_path / "port" / "eigen" / "test_files.txt")


# ----------------------------------------------------------- GT export

def _velodyne_tree(root, frames, rng):
    """KITTI-raw calibration and one velodyne scan per frame: points 5-60 m
    ahead, some behind the camera (dropped by the projection)."""
    (root / "2011_09_26").mkdir(parents=True, exist_ok=True)
    (root / "2011_09_26" / "calib_cam_to_cam.txt").write_text(CALIB_CAM)
    (root / "2011_09_26" / "calib_velo_to_cam.txt").write_text(CALIB_VELO)
    velo = root / DRIVE / "velodyne_points" / "data"
    velo.mkdir(parents=True)
    for i in frames:
        n = 6000
        pts = np.stack([rng.uniform(-5.0, 60.0, n), rng.uniform(-20, 20, n),
                        rng.uniform(-1.8, 1.5, n), rng.uniform(0, 1, n)],
                       1).astype(np.float32)
        pts.tofile(velo / f"{i:010d}.bin")


def _split(root, split, frames):
    d = root / "splits" / split
    d.mkdir(parents=True)
    (d / "test_files.txt").write_text(
        "\n".join(f"{DRIVE} {i} l" for i in frames))
    return d


def _load(path):
    return np.load(path, allow_pickle=True, encoding="latin1")["data"]


def _assert_same_gt(got, want):
    assert got.dtype == want.dtype == object and got.ndim == want.ndim == 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_export_gt_eigen_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    frames = (3, 5, 8)
    _velodyne_tree(tmp_path, frames, rng)
    split_dir = _split(tmp_path, "eigen", frames)
    before = _tree_listing(JAX_PACKAGE)
    out = export_gt_depths(str(tmp_path), "eigen",
                           str(tmp_path / "port" / "gt.npz"), str(split_dir))
    want = jax_export_gt(str(tmp_path), str(split_dir), "eigen")
    got = _load(out)
    _assert_same_gt(got, _load(want))
    assert got[0].shape == (375, 1242)
    for g in got:
        inside = E.eigen_mask(g).sum()
        assert inside > 100, inside
    assert _tree_listing(JAX_PACKAGE) == before


def test_export_gt_benchmark_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    frames = (1, 2)
    d = tmp_path / DRIVE / "proj_depth" / "groundtruth" / "image_02"
    d.mkdir(parents=True)
    for i in frames:
        depth = rng.integers(0, 80 * 256, (375, 1242)).astype(np.uint16)
        depth[rng.uniform(size=depth.shape) < 0.8] = 0
        Image.fromarray(depth).save(d / f"{i:010d}.png")
    split_dir = _split(tmp_path, "eigen_benchmark", frames)
    out = export_gt_depths(str(tmp_path), "eigen_benchmark",
                           str(tmp_path / "gt.npz"), str(split_dir))
    want = jax_export_gt(str(tmp_path), str(split_dir), "eigen_benchmark")
    _assert_same_gt(_load(out), _load(want))
    with pytest.raises(ValueError, match="eigen"):
        export_gt_depths(str(tmp_path), "benchmark", str(tmp_path / "x"),
                         str(split_dir))


def test_export_gt_cli_output_location(tmp_path, monkeypatch):
    """With --splits_dir the GT goes beside the list; without it into the
    port's own split directory, never under the JAX package."""
    rng = np.random.default_rng(9)
    frames = (1, 2)
    _velodyne_tree(tmp_path, frames, rng)
    _split(tmp_path, "eigen", frames)
    before = _tree_listing(JAX_PACKAGE)
    out = port_cli_export_gt.main(["--data_path", str(tmp_path),
                                   "--splits_dir", str(tmp_path / "splits"),
                                   "--split", "eigen"])
    assert out == str(tmp_path / "splits" / "eigen" / "gt_depths.npz")
    port = tmp_path / "port_splits"
    monkeypatch.setattr(SP, "PORT_SPLITS", port)
    monkeypatch.setattr(SP, "BUNDLED_SPLITS", tmp_path / "splits")
    out2 = port_cli_export_gt.main(["--data_path", str(tmp_path), "--split",
                                    "eigen"])
    assert out2 == str(port / "eigen" / "gt_depths.npz")
    _assert_same_gt(_load(out2), _load(out))
    assert _tree_listing(JAX_PACKAGE) == before


# ---------------------------------------------------------------- CLI

def test_cli_evaluate_refuses_without_a_card(tmp_path):
    """The default device is the card: without one the CLI raises before
    it loads anything, and never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli_evaluate.main(["--data_path", str(tmp_path),
                                "--load_weights_folder", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.predict_disparities({}, Config(), str(tmp_path), str(tmp_path))


def test_cli_evaluate_refuses_orbax(tmp_path):
    (tmp_path / "checkpoint").write_text("")
    with pytest.raises(SystemExit, match="no .pth files"):
        port_cli_evaluate.main(["--data_path", str(tmp_path),
                                "--load_weights_folder", str(tmp_path),
                                "--device", "cpu"])
