"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

Each skips where no CUDA device is present. The GPU machine has no JAX,
so this file imports none and takes no fixture from tests/conftest.py
(which imports JAX). On the card, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from movedepth_tpu_torch import Config
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops import sweep_warp as SW
from movedepth_tpu_torch.ops.costvolume import schedule_depth_bins, sweep_grid
from movedepth_tpu_torch.ops.geometry import transformation_from_parameters

pytestmark = pytest.mark.cuda

@pytest.fixture
def device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    # float32 results are compared: keep cuDNN and cuBLAS out of TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _sweep_inputs(b=2, d=16, h=48, w=160, c=32):
    g = torch.Generator().manual_seed(0)
    src = torch.randn(b, h, w, c, generator=g)
    ref = torch.randn(b, h, w, c, generator=g)
    K = torch.tensor([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]]).repeat(b, 1, 1)
    bins = schedule_depth_bins(torch.rand(b, h, w, generator=g) * 55 + 5, d,
                               0.3)
    T = transformation_from_parameters(
        torch.randn(b, 3, generator=g) * 5e-3,
        torch.tensor([[0.3, 0.02, -0.1]]).repeat(b, 1))
    sx, sy = SW.grid_to_pixel(sweep_grid(bins, K, torch.linalg.inv(K), T),
                              h, w)
    return src, ref, sx.contiguous(), sy.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(device, dtype):
    """float32 within 1e-5 of the volume's range; bf16 within one bf16 ulp
    of the float32 result on the same inputs (plus that float32 bound)."""
    src, ref, sx, sy = (t.to(device) for t in _sweep_inputs())
    src, ref = src.to(dtype), ref.to(dtype)
    before = SW.launches
    got = SW.sweep_warp_corr(src, ref, sx, sy, 16)
    assert SW.launches == before + 1
    want = SW.sweep_warp_corr_reference(src.float(), ref.float(), sx, sy, 16)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
    assert torch.all((got.float() - want).abs() <= tol)


def test_kernel_out_of_frame_gives_exact_zeros(device):
    src, ref, sx, sy = (t.to(device) for t in _sweep_inputs())
    got = SW.sweep_warp_corr(src, ref, sx + 1000.0, sy, 16)
    assert torch.count_nonzero(got).item() == 0


def _warp_coords(sx, sy, w, h):
    """Sweep coordinates with a few exact-bound and out-of-frame points."""
    sx, sy = sx.clone(), sy.clone()
    sx[:, 0, 0, :8] = torch.tensor([0.0, w - 1.0, -0.5, w - 0.5, -3.0,
                                    w + 4.0, 0.0, w - 1.0])
    sy[:, 0, 0, :8] = torch.tensor([0.0, h - 1.0, 3.0, 2.0, h - 0.5,
                                    -0.5, h - 1.0, 0.0])
    return sx, sy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_warp_kernels_match_plain_version(device, dtype):
    """Forward within 1e-5 of the range (plus one bf16 ulp in bfloat16),
    dsrc within 1e-5 of its range against the plain version's autograd."""
    src, _, sx, sy = _sweep_inputs()
    sx, sy = _warp_coords(sx, sy, src.shape[2], src.shape[1])
    src, sx, sy = (t.to(device) for t in (src.to(dtype), sx, sy))
    g = torch.randn(sx.shape + src.shape[-1:],
                    generator=torch.Generator().manual_seed(1)).to(device)
    fwd, bwd = SW.warp_launches, SW.warp_bwd_launches
    leaf = src.clone().requires_grad_()
    got = SW.sweep_warp(leaf, sx, sy)
    (got.float() * g).sum().backward()
    assert (SW.warp_launches, SW.warp_bwd_launches) == (fwd + 1, bwd + 1)
    ref_leaf = src.float().clone().requires_grad_()
    want = SW.sweep_warp_reference(ref_leaf, sx, sy)
    (want * g.to(dtype).float()).sum().backward()
    torch.cuda.synchronize()
    assert got.dtype == dtype and leaf.grad.dtype == dtype
    tol = 1e-5 * want.abs().max()
    dtol = 1e-5 * ref_leaf.grad.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
        dtol = dtol + torch.exp2(torch.floor(torch.log2(
            ref_leaf.grad.abs().clamp_min(1e-30))) - 7)
    assert torch.all((got.float() - want).abs() <= tol)
    assert torch.all((leaf.grad.float() - ref_leaf.grad).abs() <= dtol)


def _image_inputs(b=2, k=6, h=48, w=96):
    g = torch.Generator().manual_seed(2)
    src = torch.rand(b, h, w, 3, generator=g)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    shift = torch.randn(b, k, 1, 1, generator=g) * 2.0
    sx = (xs + shift + 0.3 * torch.randn(b, k, h, w, generator=g)).contiguous()
    sy = (ys - shift + 0.3 * torch.randn(b, k, h, w, generator=g)).contiguous()
    sx[:, :, 0, :6] = torch.tensor([0.0, w - 1.0, -2.0, w + 3.0, 0.0, w - 1.0])
    sy[:, :, 0, :6] = torch.tensor([h - 1.0, 0.0, h - 1.0, -1.0, 0.0, h - 1.0])
    return src, sx, sy


def test_image_warp_kernels_match_plain_version(device):
    """Border-mode forward and dsx/dsy within 1e-5 of their range against
    the plain version (and its autograd), exact bounds and out-of-frame
    coordinates included."""
    from movedepth_tpu_torch.ops import image_warp as IW
    src, sx, sy = (t.to(device) for t in _image_inputs())
    g = torch.randn(sx.shape + (3,),
                    generator=torch.Generator().manual_seed(3)).to(device)
    fwd, bwd = IW.launches, IW.bwd_launches
    x, y = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    got = IW.warp_images_border(src, x, y)
    (got * g).sum().backward()
    assert (IW.launches, IW.bwd_launches) == (fwd + 1, bwd + 1)
    xr, yr = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    want = IW.warp_images_border_reference(src, xr, yr)
    (want * g).sum().backward()
    torch.cuda.synchronize()
    for a, b in ((got, want), (x.grad, xr.grad), (y.grad, yr.grad)):
        assert torch.all((a - b).abs() <= 1e-5 * b.abs().max())


def test_image_warp_l1_kernels_match_plain_version(device):
    """The L1 epilogue: warped stack, L1 map and dsx/dsy with both
    cotangents nonzero within 1e-5 of their range against the plain
    version's autograd; exact ties (rows on the pixel grid, the target the
    image there) give an L1 of exactly 0."""
    from movedepth_tpu_torch.ops import image_warp as IW
    src, sx, sy = _image_inputs()
    h, w = src.shape[1:3]
    sx[:, :, 10] = torch.arange(w, dtype=torch.float32)
    sy[:, :, 10] = 10.0
    g = torch.Generator().manual_seed(5)
    tgt = torch.rand(src.shape, generator=g)
    tgt[:, 10] = src[:, 10]
    gi = torch.randn(sx.shape + (3,), generator=g)
    gl = torch.randn(sx.shape, generator=g)
    src, sx, sy, tgt, gi, gl = (t.to(device) for t in
                                (src, sx, sy, tgt, gi, gl))
    fwd, bwd = IW.l1_launches, IW.l1_bwd_launches
    x, y = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    got, got_l1 = IW.warp_images_border(src, x, y, target=tgt)
    torch.autograd.backward((got, got_l1), (gi, gl))
    assert (IW.l1_launches, IW.l1_bwd_launches) == (fwd + 1, bwd + 1)
    xr, yr = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    want, want_l1 = IW.warp_images_border_l1_reference(src, xr, yr, tgt)
    torch.autograd.backward((want, want_l1), (gi, gl))
    torch.cuda.synchronize()
    for a, b in ((got, want), (got_l1, want_l1), (x.grad, xr.grad),
                 (y.grad, yr.grad)):
        assert torch.all((a - b).abs() <= 1e-5 * b.abs().max())
    assert torch.count_nonzero(got_l1[:, :, 10]).item() == 0


def test_kernel_variants_full_is_the_shipped_kernel(device):
    """The stage ablations build and run; ``full`` equals sweep_warp_corr
    bit for bit, and the others differ from it (wrong by design)."""
    from movedepth_tpu_torch import profile_kernel_variants as PKV
    inputs = PKV.shipped_inputs(batch=2)
    shipped = SW.sweep_warp_corr(*inputs, 16)
    outs = {name: PKV.run_variant(name, *inputs) for name in PKV.VARIANTS}
    torch.cuda.synchronize()
    assert torch.equal(outs["full"], shipped)
    for name, out in outs.items():
        assert torch.isfinite(out.float()).all(), name
        assert name == "full" or not torch.equal(out, shipped), name


def test_train_step_kernel_l1_card_matches_cpu(device):
    """kernel_l1 on the card: the L1 epilogue kernel runs (2 forward and 2
    backward launches, the plain border warp none) and the losses equal
    the CPU step's within 1e-3 and the card's kernel_l1=False step's
    within 1e-5."""
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.train import state as S
    cfg = Config(height=64, width=96, compute_dtype="float32",
                 kernel_l1=True)
    models = build_models(cfg)
    with torch.no_grad():
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)
    batch = P.synthetic_batch(cfg, 2, seed=11)
    draws = P.sample_draws(cfg, 2, torch.Generator().manual_seed(5))
    gpu_batch = {k: v.to(device) for k, v in batch.items()}
    gpu_draws = {"box": draws["box"],
                 "noise": [n.to(device) for n in draws["noise"]]}

    def step(step_cfg, step_models, step_batch, step_draws):
        opt, sched = S.create_optimizer(step_models, step_cfg)
        return S.train_step(step_models, opt, sched, step_batch, step_cfg,
                            False, step_draws)[0]

    want = step(cfg, copy.deepcopy(models), batch, draws)
    counts = (IW.launches, IW.bwd_launches, IW.l1_launches,
              IW.l1_bwd_launches)
    got = step(cfg, {k: copy.deepcopy(m).to(device)
                     for k, m in models.items()}, gpu_batch, gpu_draws)
    assert (IW.launches - counts[0], IW.bwd_launches - counts[1],
            IW.l1_launches - counts[2], IW.l1_bwd_launches - counts[3]) \
        == (0, 0, 2, 2)
    off = step(cfg.replace(kernel_l1=False),
               {k: copy.deepcopy(m).to(device) for k, m in models.items()},
               gpu_batch, gpu_draws)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].item(), off[k].item(), rtol=1e-5,
                                   err_msg=k)


def _grad_rel(models, ref_models):
    """Per model: relative L2 distance of the parameters' .grad."""
    out = {}
    for name, ref in ref_models.items():
        pairs = [(a.grad.cpu(), b.grad) for a, b in
                 zip(models[name].parameters(), ref.parameters())]
        num = sum(float((a - b).norm() ** 2) for a, b in pairs)
        den = sum(float(b.norm() ** 2) for _, b in pairs)
        out[name] = (num / den) ** 0.5
    return out


def test_train_step_card_matches_cpu(device):
    """One train step of the port on the card (through the kernels) against
    the same step on the CPU (through the plain versions), float32, 64x96:
    the kernel launches of one step, every loss within 1e-3, and every
    model's gradient within 5e-3 or twice the spread the CPU shows between
    1 thread and all of them, whichever is larger (a float32 gradient of
    this step is fixed only up to the order of its sums)."""
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.train import state as S
    cfg = Config(height=64, width=96, compute_dtype="float32")
    models = build_models(cfg)
    with torch.no_grad():  # a few-pixel motion: no automask near-ties
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)
    batch = P.synthetic_batch(cfg, 2, seed=11)
    draws = P.sample_draws(cfg, 2, torch.Generator().manual_seed(5))
    gpu_models = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
    one_thread = {k: copy.deepcopy(m) for k, m in models.items()}

    def step(step_models, step_batch, step_draws):
        opt, sched = S.create_optimizer(step_models, cfg)
        return S.train_step(step_models, opt, sched, step_batch, cfg, False,
                            step_draws)[0]

    want = step(models, batch, draws)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step(one_thread, batch, draws)
    finally:
        torch.set_num_threads(threads)
    counts = (SW.warp_launches, SW.warp_bwd_launches, IW.launches,
              IW.bwd_launches)
    got = step(gpu_models, {k: v.to(device) for k, v in batch.items()},
               {"box": draws["box"],
                "noise": [n.to(device) for n in draws["noise"]]})
    assert (SW.warp_launches - counts[0], SW.warp_bwd_launches - counts[1],
            IW.launches - counts[2], IW.bwd_launches - counts[3]) \
        == (1, 1, 2, 2)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-3,
                                   err_msg=k)
    spreads = _grad_rel(one_thread, models)
    for name, gap in _grad_rel(gpu_models, models).items():
        assert gap <= max(5e-3, 2.0 * spreads[name]), (name, gap, spreads)


def test_forward_infer_fused_card_matches_cpu(device):
    """The main path on the card (through the kernel) against the same
    port on the CPU (through the plain version), float32, 64x96."""
    cfg = Config(height=64, width=96, compute_dtype="float32")
    models = build_models(cfg)
    batch = P.synthetic_batch(cfg, 2, seed=11)
    want = P.forward_infer_fused(models, batch, cfg)
    models = {k: m.to(device) for k, m in models.items()}
    before = SW.launches
    got = P.forward_infer_fused(
        models, {k: v.to(device) for k, v in batch.items()}, cfg)
    assert SW.launches == before + 1
    for key in ("disp_mono", "cost_prob", "trust_mono"):
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   want[key].numpy(), rtol=1e-4, atol=1e-5)
    rel = ((got["depth_mvs"].cpu() - want["depth_mvs"]).abs()
           / want["depth_mvs"].abs())
    assert rel.mean().item() <= 6e-3
