"""The port's training ops against the JAX package, on the CPU.

The plain versions of the two training kernels, ``sweep_warp_reference``
and ``warp_images_border_reference``, are held against the JAX package's
Pallas kernels in interpret mode, forward and gradient, as
tests/test_pallas_warp.py and tests/test_image_warp.py hold those kernels
against the gather path. The image-warp tolerance is 2e-5 (PARITY.md). The
ported losses and masks are held against their JAX functions. Inputs are
made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movedepth_tpu.ops import losses as JL
from movedepth_tpu.ops import masking as JM
from movedepth_tpu.ops.costvolume import schedule_depth_bins, sweep_grid
from movedepth_tpu.ops.pallas.image_warp import (
    warp_images_border as jax_warp_images_border,
)
from movedepth_tpu.ops.pallas.sweep_warp import grid_to_pixel
from movedepth_tpu.ops.pallas.sweep_warp import sweep_warp as jax_sweep_warp
from movedepth_tpu_torch.ops import image_warp as IW
from movedepth_tpu_torch.ops import losses as L
from movedepth_tpu_torch.ops import masking as M
from movedepth_tpu_torch.ops import sweep_warp as SW


def _t(x):
    return torch.from_numpy(np.array(x))


def _sweep_setup(rng, b=2, d=16, h=16, w=32, c=8):
    """Features and sweep coordinates of a small forward motion (the JAX
    package's test setup)."""
    src = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    K = np.tile(np.array([[0.58 * w, 0, 0.5 * w, 0],
                          [0, 1.92 * h, 0.5 * h, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (b, 1, 1))
    prior = rng.uniform(5, 60, (b, h, w)).astype(np.float32)
    bins = schedule_depth_bins(jnp.asarray(prior), d, 0.3)
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 2, 3] = 0.05
    T[:, 0, 3] = 0.01
    grid = sweep_grid(bins, jnp.asarray(K), jnp.asarray(np.linalg.pinv(K)),
                      jnp.asarray(T))
    sx, sy = grid_to_pixel(grid, h, w)
    return src, np.asarray(sx), np.asarray(sy)


# ------------------------------------------------------------- sweep warp

def test_sweep_warp_matches_jax_kernel(rng):
    src, sx, sy = _sweep_setup(rng)
    want = jax_sweep_warp(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy),
                          interpret=True)
    got = SW.sweep_warp(_t(src), _t(sx), _t(sy))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_sweep_warp_gradient_matches_jax_kernel(rng):
    """d/dsrc through the plain version's autograd against the Pallas
    kernel's custom VJP."""
    src, sx, sy = _sweep_setup(rng, b=1, d=8, h=8, w=16)
    ref = rng.normal(0, 1, src.shape).astype(np.float32)

    def loss(s):
        out = jax_sweep_warp(s, jnp.asarray(sx), jnp.asarray(sy),
                             interpret=True) * jnp.asarray(ref)[:, None]
        return jnp.sum(out ** 2)

    want = jax.grad(loss)(jnp.asarray(src))
    leaf = _t(src).requires_grad_()
    out = SW.sweep_warp(leaf, _t(sx), _t(sy)) * _t(ref)[:, None]
    torch.sum(out ** 2).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                               atol=1e-3, rtol=1e-4)


def test_sweep_warp_zeros_padding_out_of_frame(rng):
    """Far out-of-frame coordinates give exact zeros on both sides."""
    b, d, h, w, c = 1, 8, 16, 32, 8
    src = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    sx = np.full((b, d, h, w), -50.0, np.float32)
    sy = np.full((b, d, h, w), 5.0, np.float32)
    want = jax_sweep_warp(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy),
                          interpret=True)
    got = SW.sweep_warp(_t(src), _t(sx), _t(sy))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)


def test_sweep_warp_identity(rng):
    b, d, h, w, c = 1, 8, 16, 32, 8
    src = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = np.broadcast_to(xs.astype(np.float32), (b, d, h, w)).copy()
    sy = np.broadcast_to(ys.astype(np.float32), (b, d, h, w)).copy()
    want = jax_sweep_warp(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy),
                          interpret=True)
    got = SW.sweep_warp(_t(src), _t(sx), _t(sy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(
        src[:, None], (b, d, h, w, c)), atol=1e-6)


def test_sweep_warp_no_gradient_to_coords(rng):
    src, sx, sy = _sweep_setup(rng, b=1, d=4, h=8, w=16)
    want = jax.grad(lambda a: jnp.sum(jax_sweep_warp(
        jnp.asarray(src), a, jnp.asarray(sy), interpret=True)))(
            jnp.asarray(sx))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    x = _t(sx).requires_grad_()
    leaf = _t(src).requires_grad_()
    out = SW.sweep_warp(leaf, x, _t(sy))
    assert out.grad_fn is not None
    torch.sum(out).backward()
    assert x.grad is None and leaf.grad is not None


def test_sweep_warp_corr_reference_is_the_warp_correlated(rng):
    """The inference kernel's plain version is the training warp's, times
    the reference feature, group-meaned."""
    src, sx, sy = _sweep_setup(rng)
    ref = rng.normal(0, 1, src.shape).astype(np.float32)
    warped = SW.sweep_warp_reference(_t(src), _t(sx), _t(sy))
    want = (warped * _t(ref)[:, None]).view(*warped.shape[:4], 2, 4).mean(-2)
    got = SW.sweep_warp_corr_reference(_t(src), _t(ref), _t(sx), _t(sy), 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_sweep_warp_refuses_other_devices_and_dtypes(rng):
    src, sx, sy = _sweep_setup(rng, b=1, d=2, h=8, w=16)
    with pytest.raises(ValueError, match="device"):
        SW.sweep_warp(_t(src).to("meta"), _t(sx).to("meta"),
                      _t(sy).to("meta"))
    with pytest.raises(TypeError):
        SW.sweep_warp(_t(src).double(), _t(sx), _t(sy))


# ------------------------------------------------------------- image warp

def _image_coords(rng, b, k, r, w, off=3.0):
    """Shifted pixel grids with coordinates exactly on 0, W-1 and R-1 and
    outside the frame. Each stays near its own row, so the Pallas kernel
    keeps its windowed rung: its gather fallback clamps twice and passes
    1/4 of the gradient on an exact bound, where the rung and the JAX
    package's training path (``_sample_one``) pass 1/2."""
    ys, xs = np.meshgrid(np.arange(r), np.arange(w), indexing="ij")
    sx = (np.broadcast_to(xs, (b, k, r, w))
          + rng.uniform(-off, off, (b, k, 1, 1))).astype(np.float32)
    sy = (np.broadcast_to(ys, (b, k, r, w))
          + rng.uniform(-off, off, (b, k, 1, 1))).astype(np.float32)
    sx[:, :, 5, :4] = [0.0, w - 1.0, -2.5, w + 1.5]
    sx[:, :, r - 1, 7] = w - 1.0
    sy[:, :, r - 1, 3:6] = [r - 1.0, r + 2.0, r - 1.0]
    sy[:, :, 0, 8:10] = [0.0, -0.75]
    sx[:, :, 0, 8] = 0.0
    return sx, sy


def test_image_warp_precise_matches_jax_kernel(rng):
    b, k, r, w, c = 2, 3, 64, 96, 3
    src = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    sx, sy = _image_coords(rng, b, k, r, w)
    want = jax_warp_images_border(jnp.asarray(src), jnp.asarray(sx),
                                  jnp.asarray(sy), precise=True,
                                  interpret=True)
    got = IW.warp_images_border(_t(src), _t(sx), _t(sy))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_image_warp_coord_gradient_matches_jax_kernel(rng):
    """d/dsx, d/dsy of the plain version with the port's clamp against the
    Pallas kernel's coordinate VJP composed with jnp.clip: 1/2 on an exact
    bound, the zero-read tap's part at x = W-1 and y = R-1, 0 outside."""
    b, k, r, w, c = 1, 2, 64, 96, 3
    src = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    sx, sy = _image_coords(rng, b, k, r, w)
    tgt = rng.uniform(0, 1, (b, k, r, w, c)).astype(np.float32)

    def loss(a, b2):
        out = jax_warp_images_border(jnp.asarray(src), a, b2, precise=True,
                                     interpret=True)
        return jnp.sum((out - jnp.asarray(tgt)) ** 2)

    gx, gy = jax.grad(loss, (0, 1))(jnp.asarray(sx), jnp.asarray(sy))
    x, y = _t(sx).requires_grad_(), _t(sy).requires_grad_()
    out = IW.warp_images_border(_t(src), x, y)
    torch.sum((out - _t(tgt)) ** 2).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=2e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gy), atol=2e-5)


def test_clamp_gradient_matches_jax_clip():
    """On an exact bound the clamp passes half the gradient, as jnp.clip
    does (torch.clamp would pass all of it)."""
    pts = np.array([0.0, 11.0, -1.0, 12.5, 4.5], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 11.0)))(pts)
    x = _t(pts).requires_grad_()
    IW.clamp_coords(x, x.detach(), 8, 12)[0].sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.5, 0.5, 0.0, 0.0, 1.0]


def test_image_warp_border_gradient_masked_outside(rng):
    """Coordinates far outside: edge sampling and zero coordinate
    gradient, as the Pallas kernel gives."""
    b, k, r, w, c = 1, 1, 32, 48, 3
    src = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    sx = np.full((b, k, r, w), -10.0, np.float32)
    sy = np.full((b, k, r, w), 5.0, np.float32)
    want = jax_warp_images_border(jnp.asarray(src), jnp.asarray(sx),
                                  jnp.asarray(sy), precise=True,
                                  interpret=True)
    x = _t(sx).requires_grad_()
    got = IW.warp_images_border(_t(src), x, _t(sy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(got[0, 0].detach().numpy(), np.broadcast_to(
        src[0, 5, 0], (r, w, c)), atol=1e-6)
    got.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), 0.0)


def test_image_warp_large_spread_matches_jax_kernel(rng):
    """Coordinates spanning the whole image within one row (the Pallas
    kernel's gather fallback)."""
    b, k, r, w, c = 1, 2, 64, 96, 3
    src = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    sx = np.broadcast_to(np.arange(w, dtype=np.float32), (b, k, r, w)).copy()
    sy = np.broadcast_to(np.linspace(0.0, r - 1.0, w, dtype=np.float32),
                         (b, k, r, w)).copy()
    want = jax_warp_images_border(jnp.asarray(src), jnp.asarray(sx),
                                  jnp.asarray(sy), precise=True,
                                  interpret=True)
    got = IW.warp_images_border(_t(src), _t(sx), _t(sy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_image_warp_refuses_other_devices_and_dtypes(rng):
    src = _t(rng.uniform(0, 1, (1, 8, 12, 3)).astype(np.float32))
    x = torch.zeros(1, 2, 8, 12)
    with pytest.raises(ValueError, match="device"):
        IW.warp_images_border(src.to("meta"), x.to("meta"), x.to("meta"))
    with pytest.raises(TypeError):
        IW.warp_images_border(src.double(), x, x)


# ----------------------------------------------------------------- losses

def _images(rng, b=2, h=24, w=32, c=3):
    return (rng.uniform(0, 1, (b, h, w, c)).astype(np.float32),
            rng.uniform(0, 1, (b, h, w, c)).astype(np.float32))


def test_ssim_matches_jax(rng):
    x, y = _images(rng)
    np.testing.assert_allclose(L.ssim(_t(x), _t(y)).numpy(),
                               np.asarray(JL.ssim(x, y)), atol=1e-6)


@pytest.mark.parametrize("use_ssim", [True, False])
def test_reprojection_loss_matches_jax(rng, use_ssim):
    x, y = _images(rng)
    got = L.reprojection_loss(_t(x), _t(y), 0.85, use_ssim)
    want = JL.reprojection_loss(x, y, 0.85, use_ssim)
    assert got.shape == want.shape == (2, 24, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_smooth_loss_matches_jax(rng):
    x, _ = _images(rng)
    disp = rng.uniform(0.01, 1, (2, 24, 32, 1)).astype(np.float32)
    np.testing.assert_allclose(float(L.smooth_loss(_t(disp), _t(x))),
                               float(JL.smooth_loss(disp, x)), rtol=1e-6)


def test_smooth_l1_loss_matches_jax(rng):
    a = rng.normal(0, 2, (2, 6, 8)).astype(np.float32)
    b = rng.normal(0, 2, (2, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(float(L.smooth_l1_loss(_t(a), _t(b))),
                               float(JL.smooth_l1_loss(a, b)), rtol=1e-6)


def test_min_reprojection_with_automask_matches_jax(rng):
    reproj = rng.uniform(0, 1, (2, 24, 32, 2)).astype(np.float32)
    ident = rng.uniform(0, 1, (2, 24, 32, 2)).astype(np.float32)
    noise = rng.normal(0, 1, (2, 24, 32, 1)).astype(np.float32)
    got = L.min_reprojection_with_automask(_t(reproj), _t(ident), _t(noise))
    want = JL.min_reprojection_with_automask(reproj, ident, noise)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    mask = got[1]
    np.testing.assert_allclose(float(L.masked_mean(got[0], mask)),
                               float(JL.masked_mean(want[0], want[1])),
                               rtol=1e-6)


# ------------------------------------------------------------------ masks

def test_random_image_mask_matches_jax_with_its_draw(rng):
    """The box drawn by jax.random, injected: the same masked image."""
    img = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_img, want_mask = JM.random_image_mask(key, jnp.asarray(img),
                                               (21, 32))
    kx, ky = jax.random.split(key)
    box = (int(jax.random.randint(kx, (), 0, 96 - 32)),
           int(jax.random.randint(ky, (), 0, 64 - 21)))
    got_img, got_mask = M.random_image_mask(_t(img), (21, 32), box)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_sample_box_is_seeded_and_in_range():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    boxes = [M.sample_box(64, 96, (21, 32), g1, "cpu") for _ in range(20)]
    assert boxes == [M.sample_box(64, 96, (21, 32), g2, "cpu")
                     for _ in range(20)]
    assert all(0 <= x < 64 and 0 <= y < 43 for x, y in boxes)


def test_geometric_consistency_mask_matches_jax(rng):
    b, h, w = 2, 24, 32
    depth = rng.uniform(5, 20, (b, h, w)).astype(np.float32)
    K = np.tile(np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 0, 3] = 0.1
    T[:, 2, 3] = 0.2
    src_depth = depth * rng.uniform(0.9, 1.1, depth.shape).astype(np.float32)
    want = JM.geometric_consistency_mask(depth, K, T, src_depth, K, 1.0, 0.1)
    got = M.geometric_consistency_mask(_t(depth), _t(K), _t(T),
                                       _t(src_depth), _t(K), 1.0, 0.1)
    want = np.asarray(want)
    assert got.dtype == torch.bool and 0 < want.mean() < 1
    assert (got.numpy() != want).mean() < 2e-3  # threshold ties only


def test_compute_mvs_masks_matches_jax(rng):
    """The conf, dist and geo masks of the MVS loss, all on."""
    from movedepth_tpu import pipeline as JP
    from movedepth_tpu.config import Config
    from movedepth_tpu_torch import pipeline as P
    cfg = Config(height=24, width=32, frame_ids=(0, -1, 1),
                 mask_mvs_conf=True, mask_mvs_dist=True, mask_mvs_geo=True,
                 photo_conf=0.15, dist_thres=0.4)
    b, d = 2, 8
    logits = rng.normal(0, 1.5, (b, d, 6, 8)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    disp0 = rng.uniform(0, 1, (b, 24, 32)).astype(np.float32)
    depth = rng.uniform(5, 20, (b, 24, 32)).astype(np.float32)
    K = np.tile(np.array([[0.58 * 32, 0, 16, 0], [0, 1.92 * 24, 12, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 2, 3] = 0.05
    cam = {-1: T, 1: np.linalg.inv(T).astype(np.float32)}
    color = np.zeros((b, 3, 24, 32, 3), np.float32)
    want = JP.compute_mvs_masks(jnp.asarray(prob), jnp.asarray(disp0),
                                {"color": jnp.asarray(color),
                                 "K": jnp.asarray(K)},
                                {f: jnp.asarray(v) for f, v in cam.items()},
                                jnp.asarray(depth), cfg)
    got = P.compute_mvs_masks(_t(prob), _t(disp0),
                              {"color": _t(color), "K": _t(K)},
                              {f: _t(v) for f, v in cam.items()}, _t(depth),
                              cfg)
    want = np.asarray(want)
    assert got.shape == want.shape == (b, 24, 32, 1)
    assert 0 < want.mean() < 1
    assert (got.numpy() != want).mean() < 2e-3  # threshold ties only
    assert P.compute_mvs_masks(_t(prob), _t(disp0), {}, cam, _t(depth),
                               Config()) is None
