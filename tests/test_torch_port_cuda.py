"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

Each skips where no CUDA device is present. The GPU machine has no JAX,
so this file imports none and takes no fixture from tests/conftest.py
(which imports JAX). On the card, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

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
