"""The port's inference pipeline and serving CLI against the JAX package.

Both sides run the same weights: the port's seeded models, with perturbed
BatchNorm statistics, go through the JAX package's own converter
(``train/torch_import``), the path a reference ``.pth`` folder takes. Both
see the same ``make_batch`` frames. The JAX side runs its XLA path
(``pallas_warp=False``), as tests/test_e2e_parity.py does, in float32;
the tolerances are that file's.

Pinned divergence points of a straightforward port: ``frame_ids`` is
replaced by ``matching_ids`` (the third make_batch frame is ignored), the
eval z-translation is per sample (batch element 1 has its own bins), eval
fuses frames over the depth axis, warps use align_corners=True and the
mono disparity upsampling align_corners=False, Reg3D's ConvTranspose3d
keeps output_padding 1, and BatchNorm runs on running statistics.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from movedepth_tpu import pipeline as JP
from movedepth_tpu.cli import infer as jax_infer
from movedepth_tpu.config import Config
from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu.models import build_models as jax_build_models
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.cli import infer as port_infer
from movedepth_tpu_torch.models import build_models

B, H, W = 2, 64, 96
CFG = Config(height=H, width=W, batch_size=B, compute_dtype="float32",
             pallas_warp=False)


def _state_dicts(cfg=CFG, seed=42):
    """Seeded port weights, BN statistics perturbed, pose head conditioned
    as in test_e2e_parity (x40 on net.3: a few-pixel motion, so the
    z-scaled depth bins are not degenerate)."""
    rng = np.random.default_rng(seed)
    models = build_models(cfg, "cpu", torch.Generator().manual_seed(seed))
    states = {}
    for name, m in models.items():
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        for k in sd:
            shape = sd[k].shape
            if k.endswith("running_mean"):
                sd[k] = torch.from_numpy(rng.uniform(-0.5, 0.5, shape))
            elif k.endswith("running_var"):
                sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape))
            elif name == "pose" and k.startswith("net.3."):
                sd[k] = sd[k] * 40.0
            sd[k] = sd[k].to(m.state_dict()[k].dtype)
        states[name] = sd
    return states


def _setup(cfg):
    """Both packages' models on the same converted weights, the batch, and
    the JAX package's forward_infer_fused on it."""
    states = _state_dicts(cfg)
    models = build_models(cfg, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
    variables = {name: TI.convert_state_dict(
        name, {k: v.numpy() for k, v in sd.items()})
        for name, sd in states.items()}
    jmodels = jax_build_models(cfg)
    batch = make_batch(cfg, B, seed=11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, b: JP.forward_infer_fused(jmodels, v, b, cfg))(
        variables, jbatch)
    want = {k: np.asarray(v) for k, v in want.items()}
    return states, models, variables, jmodels, batch, want


@pytest.fixture(scope="module")
def setup():
    return _setup(CFG)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_forward_infer(setup):
    _, models, _, _, batch, want = setup
    got = P.forward_infer(models, P.as_batch(batch, "cpu"), CFG)
    assert sorted(got) == ["cost_prob", "depth_mvs", "disp_mono", "disp_mvs"]
    assert got["depth_mvs"].shape == (B, H, W)
    assert got["cost_prob"].shape == (B, 16, H // 4, W // 4)
    _close(got["disp_mono"], want["disp_mono"], atol=2e-5)
    _close(got["cost_prob"], want["cost_prob"], atol=1e-4)
    _close(got["disp_mvs"], want["disp_mvs"], atol=1e-4)


def test_forward_infer_fused(setup):
    _, models, _, _, batch, want = setup
    got = P.forward_infer_fused(models, P.as_batch(batch, "cpu"), CFG)
    _close(got["trust_mono"], want["trust_mono"], atol=1e-4)
    _close(got["depth_fused"], want["depth_fused"], rtol=1e-4, atol=1e-3)
    _close(got["disp_fused"], want["disp_fused"], rtol=1e-4, atol=1e-6)


def test_forward_infer_fused_two_groups():
    """reg3d_c = 2: a cost volume of two groups, fewer than a 16-byte vector
    holds (the kernel's in-lane group sum on the card), under the same
    tolerances."""
    cfg = CFG.replace(reg3d_c=2)
    _, models, _, _, batch, want = _setup(cfg)
    got = P.forward_infer_fused(models, P.as_batch(batch, "cpu"), cfg)
    _close(got["cost_prob"], want["cost_prob"], atol=1e-4)
    _close(got["trust_mono"], want["trust_mono"], atol=1e-4)
    _close(got["depth_fused"], want["depth_fused"], rtol=1e-4, atol=1e-3)
    _close(got["disp_fused"], want["disp_fused"], rtol=1e-4, atol=1e-6)


def test_forward_infer_fused_resnet50():
    """res_arch = 50: the bottleneck encoders (x4 widths into the depth and
    pose decoders) end to end, under the same tolerances."""
    cfg = CFG.replace(res_arch=50)
    states, models, _, _, batch, want = _setup(cfg)
    assert states["mono_encoder"]["encoder.layer4.2.conv3.weight"].shape == (
        2048, 512, 1, 1)
    got = P.forward_infer_fused(models, P.as_batch(batch, "cpu"), cfg)
    _close(got["disp_mono"], want["disp_mono"], atol=2e-5)
    _close(got["cost_prob"], want["cost_prob"], atol=1e-4)
    _close(got["disp_mvs"], want["disp_mvs"], atol=1e-4)
    _close(got["trust_mono"], want["trust_mono"], atol=1e-4)
    _close(got["depth_fused"], want["depth_fused"], rtol=1e-4, atol=1e-3)
    _close(got["disp_fused"], want["disp_fused"], rtol=1e-4, atol=1e-6)


def test_forward_mono_infer(setup):
    _, models, variables, jmodels, batch, _ = setup
    want = JP.forward_mono_infer(jmodels, variables,
                                 {"color": jnp.asarray(batch["color"])}, CFG)
    got = P.forward_mono_infer(models, P.as_batch(batch, "cpu"), CFG)
    _close(got["disp_mono"], want["disp_mono"], atol=2e-5)
    _close(got["depth_mono"], want["depth_mono"], rtol=1e-5)


def test_forward_infer_load_pose(setup):
    """Poses from the batch instead of PoseNet: near-identity forward
    motion, injected identically on both sides."""
    _, models, variables, jmodels, batch, _ = setup
    rng = np.random.default_rng(21)
    aa = rng.normal(0, 5e-3, (B, 3)).astype(np.float32)
    tr = rng.normal(0, 3e-2, (B, 3)).astype(np.float32)
    tr[:, 2] -= 0.1
    from movedepth_tpu.ops.geometry import transformation_from_parameters
    rel = np.asarray(transformation_from_parameters(aa, tr))[:, None]
    batch = dict(batch, relative_pose=rel)
    cfg = CFG.replace(load_pose=True)
    want = jax.jit(lambda v, b: JP.forward_infer(jmodels, v, b, cfg))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    got = P.forward_infer(models, P.as_batch(batch, "cpu"), cfg)
    _close(got["disp_mono"], want["disp_mono"], atol=2e-5)
    _close(got["cost_prob"], want["cost_prob"], atol=1e-4)
    _close(got["disp_mvs"], want["disp_mvs"], rtol=1e-5, atol=1e-4)


def test_cli_infer_matches_jax_cli(setup, tmp_path):
    """Both serving CLIs on the same 3 frames and the same reference .pth
    folder: frame 0 gets the mono depth, frames 1-2 the fused MVS depth."""
    states = setup[0]
    weights = tmp_path / "weights"
    weights.mkdir()
    for name, sd in states.items():
        if name.endswith("encoder") and name != "mvs_encoder":
            # a reference encoder file also carries its input size
            sd = dict(sd, height=H, width=W)
        torch.save(sd, weights / f"{name}.pth")
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        img = rng.uniform(0, 255, (H // 8, W // 8, 3)).astype(np.uint8)
        Image.fromarray(img).resize((W, H), Image.NEAREST).save(
            frames / f"frame_{i:03d}.png")
    args = ["--image_path", str(frames), "--load_weights_folder",
            str(weights), "--height", str(H), "--width", str(W),
            "--compute_dtype", "float32", "--fused"]
    jax_infer.main(args + ["--out_dir", str(tmp_path / "jax"),
                           "--no-pallas_warp"])
    port_infer.main(args + ["--out_dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    for i in range(3):
        name = f"frame_{i:03d}_depth.npy"
        got = np.load(tmp_path / "port" / name)
        want = np.load(tmp_path / "jax" / name)
        assert got.shape == (H, W) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
