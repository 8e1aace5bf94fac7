"""The image warp's photometric L1 epilogue (``kernel_l1``) of the port
against the JAX package, on the CPU.

The plain version ``warp_images_border_l1_reference`` is held against the
JAX package's ``warp_images_border(..., target=...)``, whose Pallas
epilogue kernel runs in interpret mode: the warped stack, the L1 map, and
the coordinate gradients of ``sum(a * warped) + sum(b * l1)``, within the
image warp's 2e-5 (PARITY.md), exact bounds, out-of-frame coordinates and
exact ties (|w - t| = 0, whose cotangent sign is 0) included. Then the
port's ``forward_train`` with ``kernel_l1`` on and off: the JAX package
claims the two bit-identical (tests/test_pipeline.py), and so does the
port on the CPU.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movedepth_tpu.ops.pallas.image_warp import (
    warp_images_border as jax_warp_images_border,
)
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops import image_warp as IW
from test_torch_port_pipeline import B, CFG
from test_torch_port_train_ops import _image_coords, _t


def _l1_inputs(rng, b=2, k=3, r=64, w=96, c=3):
    """Images, coordinates with edge cases, and a target that equals the
    image in rows 10-11, where map 0 sits on the pixel grid (exact ties);
    elsewhere the target is another image."""
    src = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    sx, sy = _image_coords(rng, b, k, r, w)
    ys, xs = np.meshgrid(np.arange(10, 12), np.arange(w), indexing="ij")
    sx[:, 0, 10:12] = xs
    sy[:, 0, 10:12] = ys
    tgt = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    tgt[:, 10:12] = src[:, 10:12]
    return src, sx, sy, tgt


def test_l1_epilogue_matches_jax_kernel(rng):
    src, sx, sy, tgt = _l1_inputs(rng)
    want_w, want_l1 = jax_warp_images_border(
        jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy), precise=True,
        interpret=True, target=jnp.asarray(tgt))
    got_w, got_l1 = IW.warp_images_border(_t(src), _t(sx), _t(sy),
                                          target=_t(tgt))
    assert got_l1.shape == want_l1.shape == (2, 3, 64, 96)
    assert got_l1.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=2e-5)
    np.testing.assert_allclose(got_l1.numpy(), np.asarray(want_l1),
                               atol=2e-5)
    # the L1 tail of the plain warp, and exact zeros at the ties
    np.testing.assert_array_equal(got_l1.numpy(), np.abs(
        IW.warp_images_border_reference(_t(src), _t(sx), _t(sy)).numpy()
        - tgt[:, None]).mean(-1))
    assert np.all(got_l1[:, 0, 10:12].numpy() == 0.0)
    assert np.all(np.asarray(want_l1)[:, 0, 10:12] == 0.0)


def test_l1_epilogue_gradient_matches_jax_kernel(rng):
    """d/dsx and d/dsy of sum(a * warped) + sum(b * l1): the L1 cotangent
    sign(w - t) * b / C folded into the coordinate gradient, sign 0 at the
    ties, 1/2 on an exact bound, 0 outside the frame."""
    src, sx, sy, tgt = _l1_inputs(rng)
    a = rng.normal(0, 1, (2, 3, 64, 96, 3)).astype(np.float32)
    bw = rng.normal(0, 1, (2, 3, 64, 96)).astype(np.float32)

    def loss(x, y):
        w, l1 = jax_warp_images_border(
            jnp.asarray(src), x, y, precise=True, interpret=True,
            target=jnp.asarray(tgt))
        return jnp.sum(w * a) + jnp.sum(l1 * bw)

    gx, gy = jax.grad(loss, (0, 1))(jnp.asarray(sx), jnp.asarray(sy))
    x, y = _t(sx).requires_grad_(), _t(sy).requires_grad_()
    w, l1 = IW.warp_images_border(_t(src), x, y, target=_t(tgt))
    (torch.sum(w * _t(a)) + torch.sum(l1 * _t(bw))).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=2e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gy), atol=2e-5)
    # the L1 part is there: without it the gradient differs
    x0 = _t(sx).requires_grad_()
    torch.sum(IW.warp_images_border(_t(src), x0, _t(sy)) * _t(a)).backward()
    assert (x0.grad - x.grad).abs().max() > 1e-2


def test_l1_epilogue_refuses_a_differentiable_target(rng):
    """The target is data: the JAX package silently returns it a zero
    cotangent; the port refuses it."""
    src, sx, sy, tgt = _l1_inputs(rng, b=1, k=1, r=32, w=48)
    with pytest.raises(ValueError, match="target"):
        IW.warp_images_border(_t(src), _t(sx), _t(sy),
                              target=_t(tgt).requires_grad_())
    with pytest.raises(ValueError, match="target"):
        IW.warp_images_border(_t(src), _t(sx), _t(sy), target=_t(tgt)[:, 1:])


@pytest.fixture(scope="module")
def train_pair():
    """forward_train on the CPU with kernel_l1 off and on, from the same
    weights, batch and draws: (losses, gradients) of each. On one thread:
    with several, the convolutions' backward sums in a varying order and
    two runs of the same step differ by ~1e-6."""
    models = build_models(CFG, "cpu", torch.Generator().manual_seed(7))
    with torch.no_grad():  # a few-pixel motion, as the parity tests use
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)
    batch = P.synthetic_batch(CFG, B, seed=3, device="cpu")
    draws = P.sample_draws(CFG, B, torch.Generator().manual_seed(2),
                           device="cpu")
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for on in (False, True):
            step_models = copy.deepcopy(models)
            for m in step_models.values():
                m.train()
            total, losses, _ = P.forward_train(
                step_models, batch, CFG.replace(kernel_l1=on), False, draws)
            total.backward()
            out[on] = ({k: v.item() for k, v in losses.items()},
                       {f"{n}.{k}": p.grad.clone()
                        for n, m in step_models.items()
                        for k, p in m.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    return out


def test_forward_train_kernel_l1_same_losses(train_pair):
    assert train_pair[True][0] == train_pair[False][0]


def test_forward_train_kernel_l1_same_gradients(train_pair):
    got, want = train_pair[True][1], train_pair[False][1]
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
