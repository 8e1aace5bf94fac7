"""The port's kernels as ``torch.library`` ops, on the CPU.

Each op of the ``movedepth`` namespace (rows 1-5 and 4b of PERF.md's
kernel table) passes ``torch.library.opcheck`` at a small shape (its
schema, its fake implementation against the real one, its autograd
registration and its trace under AOT dispatch); its CPU implementation
gives the plain version's output exactly, and its gradient (the plain
transposed form, ``*_bwd_reference``) the plain forward's autograd
gradient within 1e-5 relative (the two sum the same terms in another
order); and each op alone goes through
``torch.export``, ``save`` and ``load`` and gives the same output.
"""

import numpy as np
import pytest
import torch

from movedepth_tpu_torch.ops import image_warp as IW
from movedepth_tpu_torch.ops import sweep_warp as SW

OPS = torch.ops.movedepth


def _sweep(rng, b=2, r=6, w=8, c=8, d=3, h=5):
    """src (B, R, W, C), ref (B, H, W, C), coordinates (B, D, H, W) from
    two pixels outside the frame to two past it."""
    src = rng.normal(0, 1, (b, r, w, c)).astype(np.float32)
    ref = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    sx = rng.uniform(-2.5, w + 1.5, (b, d, h, w)).astype(np.float32)
    sy = rng.uniform(-2.5, r + 1.5, (b, d, h, w)).astype(np.float32)
    return [torch.from_numpy(a) for a in (src, ref, sx, sy)]


def _image(rng, b=2, k=3, r=6, w=8, c=3):
    """Images, a target, and coordinates with exact bounds and
    out-of-frame points (B, K, R, W)."""
    src = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    tgt = rng.uniform(0, 1, (b, r, w, c)).astype(np.float32)
    sx = rng.uniform(-1.5, w + 0.5, (b, k, r, w)).astype(np.float32)
    sy = rng.uniform(-1.5, r + 0.5, (b, k, r, w)).astype(np.float32)
    sx[:, 0, 0] = w - 1.0
    sy[:, 0, 1] = 0.0
    return [torch.from_numpy(a) for a in (src, tgt, sx, sy)]


def _args(name, rng):
    """The op and its arguments, gradients asked of what the op
    differentiates (the source features, or the coordinates)."""
    if name == "sweep_warp_corr":
        src, ref, sx, sy = _sweep(rng)
        return OPS.sweep_warp_corr, (src, ref, sx, sy, 4)
    if name == "sweep_warp_fwd":
        src, _, sx, sy = _sweep(rng)
        return OPS.sweep_warp_fwd, (src.requires_grad_(), sx, sy)
    if name == "sweep_warp_bwd":
        src, _, sx, sy = _sweep(rng)
        grad = torch.randn(tuple(sx.shape) + (src.shape[-1],))
        return OPS.sweep_warp_bwd, (grad, sx, sy, src.shape[1])
    src, tgt, sx, sy = _image(rng)
    grad = torch.randn(tuple(sx.shape) + (3,))
    if name == "warp_images_border_fwd":
        return OPS.warp_images_border_fwd, (src, sx.requires_grad_(),
                                            sy.requires_grad_())
    if name == "warp_images_border_bwd":
        return OPS.warp_images_border_bwd, (src, sx, sy, grad)
    if name == "warp_images_border_l1_fwd":
        return OPS.warp_images_border_l1_fwd, (
            src, tgt, sx.requires_grad_(), sy.requires_grad_())
    return OPS.warp_images_border_l1_bwd, (src, tgt, sx, sy, grad,
                                           torch.randn(sx.shape))


NAMES = ("sweep_warp_corr", "sweep_warp_fwd", "sweep_warp_bwd",
         "warp_images_border_fwd", "warp_images_border_bwd",
         "warp_images_border_l1_fwd", "warp_images_border_l1_bwd")


@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name, rng):
    op, args = _args(name, rng)
    torch.library.opcheck(op, args)


def test_sweep_ops_match_plain_versions(rng):
    src, ref, sx, sy = _sweep(rng)
    assert torch.equal(SW.sweep_warp_corr(src, ref, sx, sy, 4),
                       SW.sweep_warp_corr_reference(src, ref, sx, sy, 4))
    a = src.clone().requires_grad_()
    b = src.clone().requires_grad_()
    got = SW.sweep_warp(a, sx, sy)
    want = SW.sweep_warp_reference(b, sx, sy)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_target", [False, True])
def test_image_ops_match_plain_versions(rng, with_target):
    src, tgt, sx, sy = _image(rng)
    xs = [t.clone().requires_grad_() for t in (sx, sx)]
    ys = [t.clone().requires_grad_() for t in (sy, sy)]
    if with_target:
        got = IW.warp_images_border(src, xs[0], ys[0], target=tgt)
        want = IW.warp_images_border_l1_reference(src, xs[1], ys[1], tgt)
    else:
        got = (IW.warp_images_border(src, xs[0], ys[0]),)
        want = (IW.warp_images_border_reference(src, xs[1], ys[1]),)
    gen = torch.Generator().manual_seed(2)
    cot = [torch.randn(t.shape, generator=gen) for t in got]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.autograd.backward(got, cot)
    torch.autograd.backward(want, cot)
    torch.testing.assert_close(xs[0].grad, xs[1].grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ys[0].grad, ys[1].grad, rtol=1e-5, atol=1e-6)


class _Call(torch.nn.Module):
    def __init__(self, op, extra):
        super().__init__()
        self.op, self.extra = op, extra

    def forward(self, *tensors):
        return self.op(*tensors, *self.extra)


@pytest.mark.parametrize("name", NAMES)
def test_export_each_op(name, rng, tmp_path):
    """Each op alone through torch.export (non-strict), save and load."""
    op, args = _args(name, rng)
    tensors = [a.detach() for a in args if isinstance(a, torch.Tensor)]
    extra = [a for a in args if not isinstance(a, torch.Tensor)]
    with torch.no_grad():
        program = torch.export.export(_Call(op, extra), tuple(tensors),
                                      strict=False)
    assert f"movedepth.{name}.default" in [
        str(n.target) for n in program.graph.nodes
        if n.op == "call_function"]
    torch.export.save(program, tmp_path / "op.pt2")
    loaded = torch.export.load(tmp_path / "op.pt2").module()
    got, want = loaded(*tensors), op(*tensors, *extra)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert torch.equal(g, w)
