"""The port's sweep_warp_corr (warp + correlate + group mean) against the
JAX package's Pallas kernel in interpret mode and its unfused XLA path.

On the CPU the port runs its plain PyTorch version. The CUDA kernel is
held to that version on the card by tests/test_torch_port_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from movedepth_tpu.ops.costvolume import (
    plane_sweep_costvol,
    reduce_cost_groups,
    schedule_depth_bins,
    sweep_grid,
)
from movedepth_tpu.ops.geometry import transformation_from_parameters
from movedepth_tpu.ops.pallas import sweep_warp as JW
from movedepth_tpu_torch.ops import sweep_warp as SW


def _inputs(rng, b=2, d=8, h=16, w=32, c=8):
    """Features, intrinsics, bins and a small KITTI-like motion plus a
    sideways shift, so taps cover both in-frame and out-of-frame points."""
    src = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    ref = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    K = np.tile(np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (b, 1, 1))
    invK = np.linalg.inv(K).astype(np.float32)
    bins = schedule_depth_bins(
        jnp.asarray(rng.uniform(5, 60, (b, h, w)).astype(np.float32)), d, 0.3)
    aa = rng.normal(0, 5e-3, (b, 3)).astype(np.float32)
    tr = np.tile(np.float32([[0.3, 0.02, -0.1]]), (b, 1))
    T = transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr))
    grid = sweep_grid(bins, K, invK, T)
    sx, sy = JW.grid_to_pixel(grid, h, w)
    return src, ref, K, invK, bins, T, np.array(sx), np.array(sy)


def _port(src, ref, sx, sy, groups, dtype=torch.float32):
    return SW.sweep_warp_corr(torch.from_numpy(src).to(dtype),
                              torch.from_numpy(ref).to(dtype),
                              torch.from_numpy(sx), torch.from_numpy(sy),
                              groups)


# (C, G) cases: the shipped pair, G < 16-byte vector (G = 1, 2), G = C; the
# G = C = 64 case at a smaller shape (interpret mode is slow at its width)
_PAIRS = [(8, 4), (32, 16), (8, 1), (16, 2), (32, 1), (32, 2), (64, 2),
          (64, 64)]
_SHAPE = {(64, 64): dict(b=1, d=8, h=8, w=16)}


@pytest.mark.parametrize("c,groups", _PAIRS)
def test_matches_pallas_kernel_interpret(rng, c, groups):
    src, ref, _, _, _, _, sx, sy = _inputs(rng, c=c,
                                           **_SHAPE.get((c, groups), {}))
    want = JW.sweep_warp_corr(jnp.asarray(src), jnp.asarray(ref), sx, sy,
                              groups, interpret=True)
    got = _port(src, ref, sx, sy, groups)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("c,groups", _PAIRS)
def test_matches_unfused_xla_path(rng, c, groups):
    src, ref, K, invK, bins, T, sx, sy = _inputs(
        rng, c=c, **_SHAPE.get((c, groups), {}))
    want = reduce_cost_groups(
        plane_sweep_costvol(ref, src, K, invK, bins, T), groups)
    got = _port(src, ref, sx, sy, groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_group_channel_order_k_times_g_plus_g(rng):
    """At integer coordinates the warp is the identity, so group g must be
    the mean over k of src*ref at channel k*G+g (C=32, G=16)."""
    b, d, h, w, c, g = 1, 2, 4, 6, 32, 16
    src = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    ref = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = np.broadcast_to(xs, (b, d, h, w)).astype(np.float32)
    sy = np.broadcast_to(ys, (b, d, h, w)).astype(np.float32)
    prod = (src * ref).reshape(b, 1, h, w, c // g, g)
    want = np.broadcast_to(prod.mean(-2), (b, d, h, w, g))
    got = _port(src, ref, sx, sy, g)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_frame_gives_exact_zeros(rng, dtype):
    src, ref, _, _, _, _, sx, sy = _inputs(rng)
    w, r = src.shape[2], src.shape[1]
    for fx, fy in ((sx + w + 1.0, sy), (sx, sy - r - 1.0),
                   (np.full_like(sx, -1e9), np.full_like(sy, 1e9))):
        got = _port(src, ref, fx, fy, 4, dtype)
        assert got.dtype == dtype
        assert torch.count_nonzero(got) == 0


def test_bf16_inputs_round_once(rng):
    """bf16 features give a bf16 volume within one bf16 ulp of the float32
    result on the same (bf16-rounded) inputs."""
    src, ref, _, _, _, _, sx, sy = _inputs(rng, c=32)
    src16 = torch.from_numpy(src).bfloat16()
    ref16 = torch.from_numpy(ref).bfloat16()
    got = SW.sweep_warp_corr(src16, ref16, torch.from_numpy(sx),
                             torch.from_numpy(sy), 16)
    assert got.dtype == torch.bfloat16
    want = JW.sweep_warp_corr(jnp.asarray(src16.float().numpy()),
                              jnp.asarray(ref16.float().numpy()), sx, sy, 16,
                              interpret=True)
    want = torch.from_numpy(np.array(want))
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert torch.all((got.float() - want).abs() <= ulp + 2e-5)


def test_cpu_path_never_counts_a_launch(rng, monkeypatch):
    monkeypatch.setattr(SW, "launches", 0)
    src, ref, _, _, _, _, sx, sy = _inputs(rng)
    _port(src, ref, sx, sy, 4)
    _port(src, ref, sx, sy, 4, torch.bfloat16)
    assert SW.launches == 0


@pytest.mark.parametrize("case", ["groups", "dtype", "coord_dtype", "shape",
                                  "ref_shape"])
def test_rejects_what_the_kernel_does_not_take(rng, case):
    src, ref, _, _, _, _, sx, sy = _inputs(rng)
    args = [torch.from_numpy(a) for a in (src, ref, sx, sy)] + [4]
    if case == "groups":
        args[4] = 3
    elif case == "dtype":
        args[0], args[1] = args[0].half(), args[1].half()
    elif case == "coord_dtype":
        args[2] = args[2].double()
    elif case == "shape":
        args[2], args[3] = args[2][..., :-1], args[3][..., :-1]
    else:
        args[1] = args[1][:, :-1]
    with pytest.raises((ValueError, TypeError)):
        SW.sweep_warp_corr(*args)


def test_kernel_pairs_follow_the_jax_contract():
    """The (C, G) pairs compiled into csrc/sweep_warp_corr.cu are exactly
    those the JAX package fuses at the FPN's matching widths: C in {8, 16,
    32, 64}, G dividing C, C/G a power of two."""
    src = (Path(SW.__file__).resolve().parents[1] / "csrc"
           / "sweep_warp_corr.cu").read_text()
    macro = re.search(r"#define SWC_PAIRS\(X\)(.*?)\n\n", src, re.S).group(1)
    built = {(int(c), int(g))
             for c, g in re.findall(r"X\((\d+),\s*(\d+)\)", macro)}
    rule = {(c, g) for c in (8, 16, 32, 64) for g in range(1, c + 1)
            if c % g == 0 and (c // g) & (c // g - 1) == 0}
    assert len(rule) == 22
    assert built == rule
