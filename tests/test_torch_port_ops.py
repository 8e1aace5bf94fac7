"""The PyTorch port's tensor ops against the JAX package's, on the CPU.

Each test feeds the same numpy inputs (seeded) to a JAX function and its
port and holds the port to atol 1e-5 unless a test says otherwise. Layouts
follow each function's own convention; where the port works in NCHW the
test transposes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from movedepth_tpu.ops import costvolume as JC
from movedepth_tpu.ops import geometry as JG
from movedepth_tpu.ops import losses as JL
from movedepth_tpu.ops import sampling as JS
from movedepth_tpu.ops import upsample as JU
from movedepth_tpu_torch.ops import costvolume as TC
from movedepth_tpu_torch.ops import geometry as TG
from movedepth_tpu_torch.ops import losses as TL
from movedepth_tpu_torch.ops import sampling as TS
from movedepth_tpu_torch.ops import upsample as TU

ATOL = 1e-5


def close(port, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def kitti_K(b, h, w):
    K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    return np.tile(K, (b, 1, 1))


def small_motion(rng, b):
    aa = rng.normal(0, 5e-3, (b, 3)).astype(np.float32)
    tr = rng.normal(0, 3e-2, (b, 3)).astype(np.float32)
    tr[:, 2] -= 0.1
    return np.asarray(JG.transformation_from_parameters(aa, tr))


# ------------------------------------------------------------------ geometry

def test_disp_to_depth(rng):
    disp = rng.uniform(0, 1, (2, 8, 12)).astype(np.float32)
    for p, j in zip(TG.disp_to_depth(t(disp), 0.1, 100.0),
                    JG.disp_to_depth(disp, 0.1, 100.0)):
        close(p, j, rtol=1e-6)


def test_rot_from_axisangle(rng):
    vec = rng.normal(0, 0.3, (4, 3)).astype(np.float32)
    close(TG.rot_from_axisangle(t(vec)), JG.rot_from_axisangle(vec))


def test_get_translation_matrix(rng):
    tr = rng.normal(0, 1, (2, 3, 3)).astype(np.float32)
    close(TG.get_translation_matrix(t(tr)), JG.get_translation_matrix(tr))


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(rng, invert):
    aa = rng.normal(0, 0.1, (4, 3)).astype(np.float32)
    tr = rng.normal(0, 0.5, (4, 3)).astype(np.float32)
    close(TG.transformation_from_parameters(t(aa), t(tr), invert),
          JG.transformation_from_parameters(aa, tr, invert))


def test_pixel_grid():
    close(TG.pixel_grid(5, 7), JG.pixel_grid(5, 7), atol=0)


def test_backproject_project(rng):
    b, h, w = 2, 8, 12
    depth = rng.uniform(1, 50, (b, h, w)).astype(np.float32)
    K = kitti_K(b, h, w)
    invK = np.linalg.inv(K).astype(np.float32)
    T = small_motion(rng, b)
    pts_t = TG.backproject(t(depth), t(invK))
    pts_j = JG.backproject(depth, invK)
    close(pts_t, pts_j, rtol=1e-6, atol=1e-4)  # points are O(50)
    close(TG.project(t(np.asarray(pts_j)), t(K), t(T), h, w),
          JG.project(pts_j, K, T, h, w))


# ---------------------------------------------------------------- cost volume

@pytest.mark.parametrize("schedule", ["inverse", "linear", "log"])
def test_schedule_depth_bins(rng, schedule):
    prior = rng.uniform(1, 60, (2, 6, 8)).astype(np.float32)
    z = rng.uniform(0.5, 3, (2, 1, 1)).astype(np.float32)
    close(TC.schedule_depth_bins(t(prior), 16, 0.3, schedule),
          JC.schedule_depth_bins(prior, 16, 0.3, schedule), rtol=1e-6)
    close(TC.schedule_depth_bins_z(t(prior), 16, 0.3, t(z), schedule),
          JC.schedule_depth_bins_z(prior, 16, 0.3, z, schedule), rtol=1e-6)


def _sweep_inputs(rng, b=2, d=8, h=12, w=20, c=8):
    K = kitti_K(b, h, w)
    invK = np.linalg.inv(K).astype(np.float32)
    prior = rng.uniform(5, 60, (b, h, w)).astype(np.float32)
    bins = np.asarray(JC.schedule_depth_bins(prior, d, 0.3))
    T = small_motion(rng, b) @ JG.transformation_from_parameters(
        np.zeros((b, 3), np.float32),
        np.tile(np.float32([[0.3, 0.05, 0.0]]), (b, 1)))  # few-px shift
    feats = [rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
             for _ in range(2)]
    return feats, K, invK, bins, np.asarray(T)


def test_sweep_grid(rng):
    _, K, invK, bins, T = _sweep_inputs(rng)
    close(TC.sweep_grid(t(bins), t(K), t(invK), t(T)),
          JC.sweep_grid(bins, K, invK, T))


def test_plane_sweep_warp_and_costvol(rng):
    """atol 5e-5: each side projects its own grid, and the two projections
    round differently by ~1e-6 of the normalized range (~1e-5 px here),
    which moves an O(1) feature by ~1e-5 (measured 1.5e-5). The JAX
    package's own torch golden for this op uses 2e-4."""
    (src, ref), K, invK, bins, T = _sweep_inputs(rng)
    args_t = (t(K), t(invK), t(bins), t(T))
    args_j = (K, invK, bins, T)
    close(TC.plane_sweep_warp(t(src), *args_t),
          JC.plane_sweep_warp(src, *args_j), atol=5e-5)
    close(TC.plane_sweep_costvol(t(ref), t(src), *args_t),
          JC.plane_sweep_costvol(ref, src, *args_j), atol=5e-5)


@pytest.mark.parametrize("groups", [2, 4, 8])
def test_reduce_cost_groups(rng, groups):
    cost = rng.normal(0, 1, (2, 4, 5, 6, 8)).astype(np.float32)
    close(TC.reduce_cost_groups(t(cost), groups),
          JC.reduce_cost_groups(cost, groups))


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("axis", ["group", "depth"])
def test_fuse_frames(rng, frames, axis):
    costs = [rng.normal(0, 1, (2, 8, 5, 6, 4)).astype(np.float32)
             for _ in range(frames)]
    close(TC.fuse_frames([t(c) for c in costs], weight_axis=axis),
          JC.fuse_frames([jnp.asarray(c) for c in costs], weight_axis=axis))


def test_fuse_frames_single_bf16_frame_is_identity(rng):
    """One bf16 frame skips the arithmetic on both sides (costvolume.py
    :200-208): the volume comes back bit for bit."""
    cost = rng.normal(0, 1, (2, 8, 5, 6, 4)).astype(np.float32)
    c_t = t(cost).bfloat16()
    out = TC.fuse_frames([c_t], weight_axis="depth")
    assert out is c_t
    j = JC.fuse_frames([jnp.asarray(cost, jnp.bfloat16)], weight_axis="depth")
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_localmax(rng, radius):
    logits = rng.normal(0, 2, (2, 16, 6, 7)).astype(np.float32)
    prob = np.asarray(jnp.exp(logits) / jnp.sum(jnp.exp(logits), 1,
                                                keepdims=True))
    bins = np.sort(rng.uniform(1, 60, (2, 16, 6, 7)), axis=1)[:, ::-1]
    bins = np.ascontiguousarray(bins, dtype=np.float32)
    lo, hi = 1.0 / bins[:, -1], 1.0 / bins[:, 0]
    close(TC.localmax(t(prob), radius, 16, t(lo), t(hi)),
          JC.localmax(prob, radius, 16, lo, hi), rtol=1e-6)


def test_localmax_flipped_decode():
    """Index 0 decodes to the NEAREST depth (1/inv_depth_min) although bin
    0 holds the farthest hypothesis -- the reference's decode."""
    bins = torch.linspace(50.0, 5.0, 16)[None, :, None, None].expand(
        1, 16, 2, 2).contiguous()
    prob = torch.zeros(1, 16, 2, 2)
    prob[:, 0] = 1.0
    depth = TC.localmax(prob, 1, 16, 1.0 / bins[:, -1], 1.0 / bins[:, 0])
    np.testing.assert_allclose(depth.numpy(), 5.0, rtol=1e-5)


# ------------------------------------------------- sampling, upsample, losses

@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_hw", [(24, 40), (5, 7)])
def test_resize_bilinear(rng, align_corners, out_hw):
    img = rng.normal(0, 1, (2, 12, 20, 3)).astype(np.float32)
    want = JS.resize_bilinear(img, out_hw, align_corners=align_corners)
    got = TS.resize_bilinear(t(img.transpose(0, 3, 1, 2)), out_hw,
                             align_corners)
    close(got.permute(0, 2, 3, 1), want)
    close(TS.resize_bilinear(t(img[..., 0]), out_hw, align_corners),
          JS.resize_bilinear(img[..., 0], out_hw, align_corners))


@pytest.mark.parametrize("scale", [1, 2])
def test_convex_upsample(rng, scale):
    s = 2 ** scale
    depth = rng.uniform(1, 50, (2, 6, 8)).astype(np.float32)
    mask = rng.normal(0, 2, (2, 6, 8, 9 * s * s)).astype(np.float32)
    close(TU.convex_upsample(t(depth), t(mask.transpose(0, 3, 1, 2)), scale),
          JU.convex_upsample(depth, mask, scale), atol=1e-4)  # depth O(50)


def test_entropy(rng):
    logits = rng.normal(0, 2, (2, 16, 5, 6)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    close(TL.entropy(t(prob), dim=1, keepdim=True),
          JL.entropy(prob, axis=1, keepdims=True))
