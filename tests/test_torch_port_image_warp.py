"""The border clamp rule of the image warp's coordinate gradient, on the CPU.

The CUDA kernels of ``movedepth_tpu_torch/csrc/image_warp.cu`` clamp the
coordinates in registers and multiply the sample's derivative by the
clamp's: 1 inside the frame, 1/2 on an exact bound, 0 outside, and 1/4
where 0 = W-1 (a 1-pixel-wide image) or 0 = R-1 (1 pixel tall). These
tests pin that rule on the plain version, whose clamp is autograd's: its
gradient at the raw coordinates is the factor times its gradient at the
clamped ones, and the factor is ``jax.grad`` of ``jnp.clip``. Inputs are
made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movedepth_tpu_torch.ops import image_warp as IW

# image (R, W); coordinates x, y; the expected factors of d/dx and d/dy
CASES = {
    "inside": (8, 12, [3.25, 7.5], [2.5, 6.75], [1.0, 1.0], [1.0, 1.0]),
    "x_on_0": (8, 12, [0.0], [3.5], [0.5], [1.0]),
    "x_on_w_minus_1": (8, 12, [11.0], [3.5], [0.5], [1.0]),
    "y_on_0": (8, 12, [4.5], [0.0], [1.0], [0.5]),
    "y_on_r_minus_1": (8, 12, [4.5], [7.0], [1.0], [0.5]),
    "outside": (8, 12, [-1.5, 14.0, 5.5, 5.5], [3.5, 3.5, -0.25, 9.0],
                [0.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0]),
    "corner": (8, 12, [11.0, 0.0], [7.0, 0.0], [0.5, 0.5], [0.5, 0.5]),
    "one_pixel_wide": (8, 1, [0.0, -0.5, 0.5], [3.5, 3.5, 3.5],
                       [0.25, 0.0, 0.0], [1.0, 1.0, 1.0]),
    "one_pixel_tall": (1, 12, [3.5, 3.5, 3.5], [0.0, -2.0, 1.0],
                       [1.0, 1.0, 1.0], [0.25, 0.0, 0.0]),
}


def _clip_slope(v, hi):
    """d clip(v, 0, hi) / dv, elementwise, by jax.grad."""
    return np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, hi)))(
        jnp.asarray(v, jnp.float32)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_coordinate_gradient_is_the_clamp_factor_times_the_sample_one(case):
    r, w, xs, ys, want_fx, want_fy = CASES[case]
    n = len(xs)
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.uniform(0, 1, (1, r, w, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (1, 1, 1, n, 3)).astype(np.float32))
    x = torch.tensor(xs).view(1, 1, 1, n).requires_grad_()
    y = torch.tensor(ys).view(1, 1, 1, n).requires_grad_()
    (IW.warp_images_border_reference(src, x, y) * g).sum().backward()
    cx, cy = (t.detach().requires_grad_()
              for t in IW.clamp_coords(x.detach(), y.detach(), r, w))
    (IW.sample_in_frame_reference(src, cx, cy) * g).sum().backward()

    fx, fy = _clip_slope(xs, w - 1.0), _clip_slope(ys, r - 1.0)
    np.testing.assert_array_equal(fx, want_fx)
    np.testing.assert_array_equal(fy, want_fy)
    assert np.all(cx.grad.numpy() != 0) and np.all(cy.grad.numpy() != 0)
    np.testing.assert_array_equal(x.grad.numpy().ravel(),
                                  fx * cx.grad.numpy().ravel())
    np.testing.assert_array_equal(y.grad.numpy().ravel(),
                                  fy * cy.grad.numpy().ravel())


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_aligned_flag_follows_the_data_pointers(offset):
    """The wrappers take the kernels' 16-byte path only when every tensor
    starts on a 16-byte boundary (a view at a storage offset may not)."""
    base = torch.zeros(64)
    view = base[offset:offset + 32]
    assert base.data_ptr() % 16 == 0
    assert IW.aligned(base, view) == int(offset % 4 == 0)
