#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py      # from the root of a checkout; one CUDA card

Phases, in order; any failure raises and the script exits non-zero
without printing the final ok line:

1. device: a CUDA card must be present (the CPU is never used instead);
   prints its name and power limit from nvidia-smi.
2. build: compiles every csrc/*.cu with nvcc for sm_90a, all at once.
3. kernel: sweep_warp_corr against its plain PyTorch version on the card
   at the shipped prior-scale shape, in float32 and bfloat16, plus an
   out-of-frame case; times both with CUDA events.
4. main path: forward_infer_fused of the shipped Config() models at
   640x192, float32 on the card against the same port on the CPU, and the
   same forward in bfloat16 autocast.
5. serve: the inference CLI on 4 synthetic frames and a .pth folder.
6. throughput: forward_infer frames/s in bfloat16 at batch 128 and 1.
7. train kernels: the sweep warp and the border image warp, forward and
   backward, against their plain versions (and autograd) at the shipped
   train shapes (batch 12), exact-bound and out-of-frame coordinates
   included; times kernel and plain version, forward and backward.
8. train path: one train_step of the shipped Config(compute_dtype=
   "float32") models at 640x192, batch 2, on the card against the same step
   on the CPU (every loss; every model's gradient, against the spread the
   CPU shows between 1 thread and all of them), the kernel launches of that
   step, then one step of the shipped bfloat16 config.
9. train throughput: train_step in bfloat16 autocast at batch 12, with the
   kernels and with this script swapping in the plain versions.

The lines before the last carry the card's nvidia-smi name and power limit
and a JSON summary of every kernel; the last line is the JSON ok record.
"""

import copy
import json
import os
import re
import statistics
import subprocess
import tempfile
import time

KERNEL_SHAPE = dict(B=16, R=48, W=160, C=32, D=16, G=16)
# the shipped train step's kernel shapes: batch 12, the prior-scale sweep
# (16 bins, 32 FPN channels) and the full-resolution warps of K = 6 maps
TRAIN_SHAPE = dict(B=12, R=48, W=160, C=32, D=16, H=192, X=640, K=6)
KERNELS = ("sweep_warp_corr", "sweep_warp", "image_warp")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, runs=20, warmup=3):
    """Median milliseconds of ``fn`` over ``runs`` timed calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    """Every kernel source at once (one nvcc each), then the typed
    libraries."""
    from movedepth_tpu_torch import native
    from movedepth_tpu_torch.ops import image_warp, sweep_warp
    t0 = time.perf_counter()
    native.build_all(KERNELS)
    sweep_warp.kernel_library()
    sweep_warp.warp_library()
    image_warp.kernel_library()
    log(f"[build] {', '.join(KERNELS)}: nvcc {' '.join(native.NVCC_FLAGS)} "
        f"-> {native.BUILD_DIR}, {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        report = native.build_reports.get(name)
        if not report:
            log(f"[build] {name}: already built")
            continue
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", report[1])]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                report[1]))
        log(f"[build] {name}: ready after {report[0]:.1f} s; ptxas: "
            f"{len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes spilled")


def _bf16_ulp(x):
    import torch
    e = torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32)
                                                 .tiny)))
    return torch.exp2(e - 7)


def _check_kernel(src, ref, sx, sy, g):
    """Kernel vs plain version in float32 and bfloat16; raises on a
    mismatch, returns the float32 max abs error."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW
    got = SW.sweep_warp_corr(src, ref, sx, sy, g)
    want = SW.sweep_warp_corr_reference(src, ref, sx, sy, g)
    torch.cuda.synchronize()
    err32 = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[kernel] float32 {tuple(got.shape)}: max|kernel-plain| {err32:.3e} "
        f"<= 1e-5*max|plain| = {1e-5 * scale:.3e}")
    if not err32 <= 1e-5 * scale:
        raise RuntimeError("float32 kernel disagrees with the plain version")

    src16, ref16 = src.bfloat16(), ref.bfloat16()
    got16 = SW.sweep_warp_corr(src16, ref16, sx, sy, g)
    want32 = SW.sweep_warp_corr_reference(src16.float(), ref16.float(), sx,
                                          sy, g)
    want16 = want32.bfloat16()
    torch.cuda.synchronize()
    if got16.dtype != torch.bfloat16:
        raise RuntimeError(f"bfloat16 kernel returned {got16.dtype}")
    # one bf16 ulp of the float32 result, plus the float32 tolerance for
    # the summation-order noise that decides the rounding of values near 0
    excess = ((got16.float() - want32).abs() - _bf16_ulp(want32)
              - 1e-5 * want32.abs().max()).max().item()
    ulps = ((got16.float() - want16.float()).abs()
            / _bf16_ulp(want16.float())).max().item()
    err16 = (got16.float() - want16.float()).abs().max().item()
    log(f"[kernel] bfloat16 {tuple(got16.shape)}: max|kernel-plain| "
        f"{err16:.3e}, at most {ulps:.0f} bf16 ulp of the plain bf16 result; "
        f"excess over one ulp of the float32 result {excess:.3e} (must be "
        f"<= 0)")
    if excess > 0:
        raise RuntimeError("bfloat16 kernel is more than one ulp off")
    return err32


def _kitti_pose(b, gen, scale=1.0):
    """Small forward motions with a little rotation, as between KITTI
    frames."""
    import torch
    from movedepth_tpu_torch.ops.geometry import transformation_from_parameters
    aa = torch.randn(b, 3, generator=gen) * 5e-3 * scale
    tr = torch.randn(b, 3, generator=gen) * 3e-2 * scale
    tr[:, 2] -= 0.1 * scale
    return transformation_from_parameters(aa, tr)


def _kitti_K(b, h, w):
    import torch
    return torch.tensor([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]]).repeat(b, 1, 1)


def phase_kernel():
    """Kernel vs plain version on the card at the shipped prior-scale shape
    (batch cut to 16) with coordinates from the sweep grid of small,
    KITTI-like motions. Returns the kernel's summary record."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW
    from movedepth_tpu_torch.ops.costvolume import (schedule_depth_bins_z,
                                                    sweep_grid)

    s = KERNEL_SHAPE
    b, r, w, c, d, g = s["B"], s["R"], s["W"], s["C"], s["D"], s["G"]
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    ref = torch.randn(b, r, w, c, generator=gen).to(dev)
    K = _kitti_K(b, r, w)
    T = _kitti_pose(b, gen)
    prior = torch.rand(b, r, w, generator=gen) * 55 + 5
    bins = schedule_depth_bins_z(prior, d, 0.3, 30.0 * T[:, 2, 3].abs()[:, None,
                                                                        None])
    grid = sweep_grid(bins, K, torch.linalg.inv(K), T)
    sx, sy = (t.contiguous().to(dev) for t in SW.grid_to_pixel(grid, r, w))

    # the smoke shape, then one sample: the batch-1 shape the serving CLI
    # gives the kernel
    err32 = max(_check_kernel(*(t[:nb].contiguous()
                                for t in (src, ref, sx, sy)), g)
                for nb in (b, 1))

    src16, ref16 = src.bfloat16(), ref.bfloat16()
    far = torch.full_like(sx, w + 10.0)
    zeros = SW.sweep_warp_corr(src16, ref16, far, sy, g)
    zeros32 = SW.sweep_warp_corr(src, ref, sx, torch.full_like(sy, -7.5), g)
    torch.cuda.synchronize()
    if zeros.abs().max().item() != 0 or zeros32.abs().max().item() != 0:
        raise RuntimeError("out-of-frame taps did not give exact zeros")
    log("[kernel] out-of-frame coordinates: exact zeros in both dtypes")

    ms = cuda_ms(lambda: SW.sweep_warp_corr(src16, ref16, sx, sy, g))
    plain_ms = cuda_ms(
        lambda: SW.sweep_warp_corr_reference(src16, ref16, sx, sy, g))
    ms32 = cuda_ms(lambda: SW.sweep_warp_corr(src, ref, sx, sy, g))
    plain_ms32 = cuda_ms(
        lambda: SW.sweep_warp_corr_reference(src, ref, sx, sy, g))
    log(f"[kernel] median of 20 at {s}: bfloat16 kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; float32 kernel {ms32:.4f} ms, plain "
        f"{plain_ms32:.4f} ms")
    return {"name": "sweep_warp_corr", "route": "cuda",
            "source": "movedepth_tpu_torch/csrc/sweep_warp_corr.cu",
            "replaces": "movedepth_tpu/ops/pallas/sweep_warp.py:586",
            "launches": None, "max_abs_err": err32, "ms": ms,
            "plain_ms": plain_ms}


def _temper_pose_head(models):
    """Scale the final 6-DoF conv by 1e-2 so random weights give the
    near-identity motion of a trained model (bench.py's temper_pose_head)."""
    import torch
    with torch.no_grad():
        for p in models["pose"].net[3].parameters():
            p.mul_(1e-2)


def _stats(got, want):
    """mean / p95 of the relative and absolute differences."""
    import torch
    diff = (got.float().cpu() - want.float().cpu()).abs().flatten()
    rel = diff / want.float().cpu().abs().flatten().clamp_min(1e-12)
    q = lambda t: t.kthvalue(max(1, int(0.95 * t.numel()))).values.item()
    return {"mean_rel": rel.mean().item(), "p95_rel": q(rel),
            "mean_abs": diff.mean().item(), "p95_abs": q(diff)}


# card-vs-CPU gates of the float32 main path (the JAX package's chip
# parity bounds, scripts/chip_parity.py)
GATES = {("disp_mono", "mean_rel"): 6e-3, ("disp_mono", "p95_rel"): 1.5e-2,
         ("cost_prob", "mean_abs"): 1e-4, ("cost_prob", "p95_abs"): 5e-4,
         ("depth_mvs", "mean_rel"): 6e-3, ("depth_mvs", "p95_rel"): 1.5e-2}


def phase_main_path():
    """forward_infer_fused of the shipped Config() models (ResNet18,
    640x192, 16 bins, convex upsampling) at batch 2: float32 on the card
    against the CPU, then bfloat16 autocast on the card. Returns the CPU
    models (tempered) for the serve phase."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.ops import sweep_warp as SW

    cfg32 = Config(compute_dtype="float32")
    cpu_models = build_models(cfg32, "cpu", torch.Generator().manual_seed(0))
    _temper_pose_head(cpu_models)
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    batch = P.synthetic_batch(cfg32, 2, seed=0)
    t0 = time.perf_counter()
    want = P.forward_infer_fused(cpu_models, batch, cfg32)
    log(f"[main] CPU float32 forward_infer_fused at batch 2: "
        f"{time.perf_counter() - t0:.1f} s")
    gpu_batch = P.as_batch(batch, "cuda")
    before = SW.launches
    got = P.forward_infer_fused(models, gpu_batch, cfg32)
    torch.cuda.synchronize()
    if SW.launches != before + 1:
        raise RuntimeError(f"sweep_warp_corr launched {SW.launches - before}"
                           " times in one forward, expected 1")
    failed = []
    for key in ("disp_mono", "cost_prob", "depth_mvs", "depth_fused"):
        st = _stats(got[key], want[key])
        log(f"[main] float32 card vs CPU {key}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in st.items()))
        failed += [f"{key}.{k} {st[k]:.3e} > {bound}"
                   for (name, k), bound in GATES.items()
                   if name == key and not st[k] <= bound]
    if failed:
        raise RuntimeError("card vs CPU gates failed: " + "; ".join(failed))
    log(f"[main] float32 gates pass: {GATES}; sweep_warp_corr launched once")

    cfg16 = Config()  # compute_dtype bfloat16: models under autocast
    before = SW.launches
    got16 = P.forward_infer_fused(models, gpu_batch, cfg16)
    torch.cuda.synchronize()
    if SW.launches != before + 1:
        raise RuntimeError("bfloat16 forward did not launch the kernel once")
    for key in ("disp_mono", "cost_prob", "depth_mvs", "depth_fused"):
        if not torch.isfinite(got16[key]).all():
            raise RuntimeError(f"bfloat16 {key} is not finite")
        st = _stats(got16[key], got[key])
        log(f"[main] bfloat16 vs float32 on the card {key}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in st.items()))
    return cpu_models


def phase_serve(cpu_models):
    """The serving CLI on 4 synthetic 640x192 frames and a .pth folder of
    the same (tempered) weights, in the shipped bfloat16 config. Returns
    the kernel launches of the run."""
    import numpy as np
    import torch
    from PIL import Image
    from movedepth_tpu_torch.cli import infer
    from movedepth_tpu_torch.ops import sweep_warp as SW

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights")
        frames = os.path.join(tmp, "frames")
        out = os.path.join(tmp, "out")
        os.makedirs(weights)
        os.makedirs(frames)
        for name, m in cpu_models.items():
            torch.save(m.state_dict(), os.path.join(weights, f"{name}.pth"))
        for i in range(4):
            small = rng.uniform(0, 255, (24, 80, 3)).astype(np.uint8)
            Image.fromarray(small).resize((640, 192), Image.BILINEAR).save(
                os.path.join(frames, f"{i:010d}.png"))
        SW.launches = 0
        t0 = time.perf_counter()
        infer.main(["--image_path", frames, "--load_weights_folder", weights,
                    "--out_dir", out, "--fused"])
        torch.cuda.synchronize()
        launches = SW.launches
        log(f"[serve] cli.infer --fused on 4 frames: "
            f"{time.perf_counter() - t0:.1f} s, sweep_warp_corr launched "
            f"{launches} times")
        depths = sorted(f for f in os.listdir(out) if f.endswith("_depth.npy"))
        if len(depths) != 4:
            raise RuntimeError(f"expected 4 depth maps, got {depths}")
        for f in depths:
            d = np.load(os.path.join(out, f))
            if d.shape != (192, 640) or not (np.isfinite(d).all()
                                             and (d > 0).all()):
                raise RuntimeError(f"{f}: bad depth map {d.shape}")
        log(f"[serve] 4 finite, positive (192, 640) depth maps: {depths}")
    if launches != 3:  # frame 0 is mono-only; frames 1-3 run the MVS path
        raise RuntimeError(f"expected 3 kernel launches, got {launches}")
    return launches


def phase_throughput(cpu_models, card):
    """forward_infer frames/s in bfloat16 (bench.py's program) at batch 128
    and at batch 1 (the eval protocol), CUDA events after warmup."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P

    cfg = Config()
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    torch.backends.cudnn.benchmark = True
    for bsz, iters in ((128, 10), (1, 50)):
        batch = P.synthetic_batch(cfg.replace(frame_ids=cfg.matching_ids),
                                  bsz, seed=1, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: P.forward_infer(models, batch, cfg), runs=iters,
                     warmup=3)
        log(f"[throughput] forward_infer bfloat16 batch {bsz}: "
            f"{ms:.3f} ms/iter (median of {iters}), "
            f"{bsz / ms * 1e3:.1f} frames/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")


def _within(name, got, want, bf16=False):
    """Raise unless |got - want| <= 1e-5 * max|want| (+ one bf16 ulp of
    want with ``bf16``) everywhere; returns max |got - want|."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = 1e-5 * want.abs().max()
    excess = err - bound
    if bf16:
        excess = excess - _bf16_ulp(want)
    worst = excess.max().item()
    log(f"[train-kernel] {name}: max|kernel-plain| {err.max().item():.3e}, "
        f"1e-5*max|plain| {bound.item():.3e}"
        + (" + one bf16 ulp" if bf16 else "")
        + f"; excess {worst:.3e} (must be <= 0)")
    if worst > 0 or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err.max().item()


def _edge_cases(sx, sy, w, h):
    """Coordinates exactly on 0, W-1, R-1 and outside the frame in the
    first row of every map, and one map shifted wholly out of frame."""
    import torch
    sx[:, :, 0, :8] = torch.tensor([0.0, w - 1.0, -0.5, w - 0.5, -3.0,
                                    w + 4.0, 0.0, w - 1.0])
    sy[:, :, 0, :8] = torch.tensor([0.0, h - 1.0, 3.0, 2.0, h - 0.5, -0.5,
                                    h - 1.0, 0.0])
    sx[:, 1] += 2.0 * w


def _grad_ms(out, inputs, g):
    """CUDA-event median of one backward through ``out``'s graph."""
    import torch
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, g,
                                               retain_graph=True))


def phase_train_kernels():
    """The train step's four kernels against their plain versions at the
    shipped train shapes (batch 12): the sweep warp in float32 and bfloat16
    and its source gradient (twice: atomics make it run-to-run variable),
    the border image warp and its coordinate gradient. Returns the kernels'
    summary records."""
    import torch
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.ops import sweep_warp as SW
    from movedepth_tpu_torch.ops.costvolume import (schedule_depth_bins_z,
                                                    sweep_grid)
    from movedepth_tpu_torch.ops.geometry import backproject, project

    s = TRAIN_SHAPE
    b, r, w, c, d = s["B"], s["R"], s["W"], s["C"], s["D"]
    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    K = _kitti_K(b, r, w)
    T = _kitti_pose(b, gen)
    prior = torch.rand(b, r, w, generator=gen) * 55 + 5
    bins = schedule_depth_bins_z(prior, d, 0.3, 30.0 * T[:, 2, 3].abs()[:, None,
                                                                        None])
    sx, sy = SW.grid_to_pixel(sweep_grid(bins, K, torch.linalg.inv(K), T),
                              r, w)
    sx, sy = sx.contiguous(), sy.contiguous()
    _edge_cases(sx, sy, w, r)
    sx, sy = sx.to(dev), sy.to(dev)
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    g = torch.randn((b, d, r, w, c), generator=gen).to(dev)

    err_fwd = _within("sweep_warp float32 forward", SW.sweep_warp(src, sx, sy),
                      SW.sweep_warp_reference(src, sx, sy))
    src16 = src.bfloat16()
    _within("sweep_warp bfloat16 forward", SW.sweep_warp(src16, sx, sy),
            SW.sweep_warp_reference(src16.float(), sx, sy), bf16=True)

    leaf = src.clone().requires_grad_()
    want = torch.autograd.grad(SW.sweep_warp_reference(leaf, sx, sy), leaf,
                               g)[0]
    runs = []
    for _ in range(2):
        leaf = src.clone().requires_grad_()
        runs.append(torch.autograd.grad(SW.sweep_warp(leaf, sx, sy), leaf,
                                        g)[0])
    err_bwd = max(_within(f"sweep_warp float32 dsrc, run {i + 1}", run, want)
                  for i, run in enumerate(runs))
    log(f"[train-kernel] sweep_warp dsrc run-to-run max difference "
        f"{(runs[0] - runs[1]).abs().max().item():.3e} (float32 atomics)")
    g16 = g.bfloat16()
    leaf16 = src16.clone().requires_grad_()
    leaf32 = src16.float().requires_grad_()
    _within("sweep_warp bfloat16 dsrc",
            torch.autograd.grad(SW.sweep_warp(leaf16, sx, sy), leaf16, g16)[0],
            torch.autograd.grad(SW.sweep_warp_reference(leaf32, sx, sy),
                                leaf32, g16.float())[0], bf16=True)

    # bfloat16, the train path's dtype, for the times
    ms_fwd = cuda_ms(lambda: SW.sweep_warp(src16, sx, sy))
    plain_fwd = cuda_ms(lambda: SW.sweep_warp_reference(src16, sx, sy))
    leaf16 = src16.clone().requires_grad_()
    ms_bwd = _grad_ms(SW.sweep_warp(leaf16, sx, sy), leaf16, g16)
    plain_bwd = _grad_ms(SW.sweep_warp_reference(leaf16, sx, sy), leaf16, g16)
    log(f"[train-kernel] sweep_warp bfloat16 at {s}: forward kernel "
        f"{ms_fwd:.4f} ms, plain {plain_fwd:.4f} ms; backward kernel "
        f"{ms_bwd:.4f} ms, plain {plain_bwd:.4f} ms")

    # the full-resolution image warp: a depth map projected into the source
    # frame by K = 6 poses near one KITTI-like motion
    hh, xx, k = s["H"], s["X"], s["K"]
    Kf = _kitti_K(b, hh, xx)
    depth = torch.nn.functional.interpolate(
        torch.rand(b, 1, hh // 16, xx // 16, generator=gen) * 45 + 5,
        size=(hh, xx), mode="bilinear", align_corners=False)[:, 0]
    T = _kitti_pose(b, gen, scale=3.0)
    Tk = torch.stack([T @ _kitti_pose(b, gen, scale=0.1) for _ in range(k)],
                     dim=1)
    pts = backproject(depth[:, None].expand(b, k, hh, xx),
                      torch.linalg.inv(Kf)[:, None])
    gx, gy = SW.grid_to_pixel(project(pts, Kf[:, None], Tk, hh, xx), hh, xx)
    gx, gy = gx.contiguous(), gy.contiguous()
    _edge_cases(gx, gy, xx, hh)
    gx, gy = gx.to(dev), gy.to(dev)
    img = torch.rand(b, hh, xx, 3, generator=gen).to(dev)
    gi = torch.randn((b, k, hh, xx, 3), generator=gen).to(dev)
    err_img = _within("warp_images_border forward",
                      IW.warp_images_border(img, gx, gy),
                      IW.warp_images_border_reference(img, gx, gy))
    x, y = gx.clone().requires_grad_(), gy.clone().requires_grad_()
    got = torch.autograd.grad(IW.warp_images_border(img, x, y), (x, y), gi)
    want = torch.autograd.grad(IW.warp_images_border_reference(img, x, y),
                               (x, y), gi)
    err_coord = max(_within("warp_images_border dsx", got[0], want[0]),
                    _within("warp_images_border dsy", got[1], want[1]))
    # the kernels alone take the coordinates clamped; the plain version
    # clamps inside (the clamp's backward is in its time)
    xc, yc = (t.detach().requires_grad_()
              for t in IW.clamp_coords(gx, gy, hh, xx))
    ms_img = cuda_ms(lambda: IW.WarpImagesBorder.apply(img, xc, yc))
    plain_img = cuda_ms(lambda: IW.warp_images_border_reference(img, gx, gy))
    ms_coord = _grad_ms(IW.WarpImagesBorder.apply(img, xc, yc), (xc, yc), gi)
    plain_coord = _grad_ms(IW.warp_images_border_reference(img, x, y), (x, y),
                           gi)
    log(f"[train-kernel] warp_images_border float32 at B={b}, K={k}, "
        f"{hh}x{xx}: forward kernel {ms_img:.4f} ms, plain {plain_img:.4f} "
        f"ms; coordinate backward kernel {ms_coord:.4f} ms, plain "
        f"{plain_coord:.4f} ms")

    def record(name, source, replaces, err, ms, plain_ms):
        return {"name": name, "route": "cuda",
                "source": f"movedepth_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms}

    return [
        record("sweep_warp", "sweep_warp.cu",
               "movedepth_tpu/ops/pallas/sweep_warp.py:662", err_fwd, ms_fwd,
               plain_fwd),
        record("sweep_warp_bwd", "sweep_warp.cu",
               "movedepth_tpu/ops/pallas/sweep_warp.py:618", err_bwd, ms_bwd,
               plain_bwd),
        record("warp_images_border", "image_warp.cu",
               "movedepth_tpu/ops/pallas/image_warp.py:576", err_img, ms_img,
               plain_img),
        record("warp_images_border_coord_bwd", "image_warp.cu",
               "movedepth_tpu/ops/pallas/image_warp.py:443", err_coord,
               ms_coord, plain_coord),
    ]


def _boost_pose_head(models):
    """Scale the final 6-DoF conv by 40, as the JAX package's parity tests
    do: random weights then give a motion of a pixel or so. At the
    near-identity motion of raw (or tempered) random weights, warped and
    unwarped losses tie and the automask's choices fall to round-off."""
    import torch
    with torch.no_grad():
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)


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


def _launch_counts():
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.ops import sweep_warp as SW
    return {"sweep_warp": SW.warp_launches,
            "sweep_warp_bwd": SW.warp_bwd_launches,
            "warp_images_border": IW.launches,
            "warp_images_border_coord_bwd": IW.bwd_launches}


def _zero_launch_counts():
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.ops import sweep_warp as SW
    SW.warp_launches = SW.warp_bwd_launches = 0
    IW.launches = IW.bwd_launches = 0


def phase_train_path():
    """The train path: train_step of the shipped Config(compute_dtype=
    "float32") models (ResNet18, 640x192, 16 bins, convex upsampling) at
    batch 2 on the card against the same step on the CPU, then one step in
    the shipped bfloat16 config. Returns (the launches of the card's float32
    step, the CPU models)."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.train import state as S

    cfg32 = Config(compute_dtype="float32")
    cpu_models = build_models(cfg32, "cpu", torch.Generator().manual_seed(0))
    _boost_pose_head(cpu_models)
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    bf16_models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    one_thread = {k: copy.deepcopy(m) for k, m in cpu_models.items()}
    batch = P.synthetic_batch(cfg32, 2, seed=0)
    draws = P.sample_draws(cfg32, 2, torch.Generator().manual_seed(0))

    def step(step_models, step_batch, step_draws):
        opt, sched = S.create_optimizer(step_models, cfg32)
        t0 = time.perf_counter()
        out = S.train_step(step_models, opt, sched, step_batch, cfg32, False,
                           step_draws)
        return out, time.perf_counter() - t0

    want, seconds = step(cpu_models, batch, draws)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, seconds1 = step(one_thread, batch, draws)
    finally:
        torch.set_num_threads(threads)
    log(f"[train] CPU float32 train_step at batch 2, 640x192: {seconds:.1f} s "
        f"on {threads} threads, {seconds1:.1f} s on 1")

    gpu_batch = P.as_batch(batch, "cuda")
    gpu_draws = {"box": draws["box"],
                 "noise": [n.cuda() for n in draws["noise"]]}
    _zero_launch_counts()
    got, _ = step(models, gpu_batch, gpu_draws)
    torch.cuda.synchronize()
    launches = _launch_counts()
    log(f"[train] kernel launches of one card train_step: {launches}")
    if list(launches.values()) != [1, 1, 2, 2]:
        raise RuntimeError("expected sweep_warp 1 forward + 1 backward and "
                           "warp_images_border 2 forward + 2 backward")
    failed = []
    for key, value in want.items():
        rel = abs(got[key].item() - value.item()) / abs(value.item())
        log(f"[train] float32 card vs CPU {key}: card {got[key].item():.6f}, "
            f"CPU {value.item():.6f}, rel {rel:.3e}")
        if not rel <= 1e-3:
            failed.append(f"{key} rel {rel:.3e} > 1e-3")
    # A float32 gradient of this step is fixed only up to the spread that
    # reordering its sums gives: the CPU on 1 thread against the CPU on all
    # of them. The card must agree with the CPU within 5e-3 or twice that
    # spread, whichever is larger.
    gaps = _grad_rel(models, cpu_models)
    spreads = _grad_rel(one_thread, cpu_models)
    for name, gap in gaps.items():
        bound = max(5e-3, 2.0 * spreads[name])
        log(f"[train] float32 gradient of {name}: card vs CPU relative L2 "
            f"{gap:.3e}; CPU 1 thread vs {threads} {spreads[name]:.3e}; "
            f"bound {bound:.3e}")
        if not gap <= bound:
            failed.append(f"{name} gradient {gap:.3e} > {bound:.3e}")
    if failed:
        raise RuntimeError("train card vs CPU gates failed: "
                           + "; ".join(failed))
    log("[train] float32 gates pass: every loss within 1e-3 relative, every "
        "gradient within max(5e-3, 2 x the CPU's own thread-count spread)")

    cfg16 = Config()  # bfloat16 autocast, the shipped config
    opt, sched = S.create_optimizer(bf16_models, cfg16)
    got16 = S.train_step(bf16_models, opt, sched, gpu_batch, cfg16, True,
                         gpu_draws)
    torch.cuda.synchronize()
    bad = [k for k, v in got16.items() if not torch.isfinite(v).all()]
    bad += [n for n, m in bf16_models.items()
            if not all(torch.isfinite(p.grad).all() and
                       torch.isfinite(p).all() for p in m.parameters())]
    if bad:
        raise RuntimeError(f"bfloat16 train_step not finite: {bad}")
    log(f"[train] bfloat16 train_step (z-guided bins): loss "
        f"{got16['loss'].item():.6f} (float32 on the card "
        f"{got['loss'].item():.6f}); every loss, gradient and updated "
        "parameter finite")
    return launches, cpu_models


def phase_train_throughput(cpu_models, card):
    """train_step in bfloat16 autocast at batch 12, 640x192 (the shipped
    config): 3 warmup steps, then the median of 10, CUDA events; then the
    same with the plain versions swapped in for the two kernel Functions."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.ops import sweep_warp as SW
    from movedepth_tpu_torch.train import state as S

    cfg = Config()
    bsz = cfg.batch_size
    batch = P.synthetic_batch(cfg, bsz, seed=1, device="cuda")
    draws = P.sample_draws(cfg, bsz, torch.Generator("cuda").manual_seed(1),
                           device="cuda")

    def run(label):
        models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
        opt, sched = S.create_optimizer(models, cfg)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: S.train_step(models, opt, sched, batch, cfg,
                                          True, draws), runs=10, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train-throughput] {label}: train_step bfloat16 batch {bsz}, "
            f"640x192: {ms:.3f} ms/step (median of 10), "
            f"{bsz / ms * 1e3:.2f} examples/s, peak {peak:.2f} GiB; {card}")
        return ms

    ms = run("kernels")
    kernels = (P.sweep_warp, P.warp_images_border)
    P.sweep_warp = SW.sweep_warp_reference
    P.warp_images_border = IW.warp_images_border_reference
    try:
        plain = run("plain versions")
    finally:
        P.sweep_warp, P.warp_images_border = kernels
    log(f"[train-throughput] kernels {ms:.3f} ms/step vs plain versions "
        f"{plain:.3f} ms/step")


def main():
    card = phase_device()
    phase_build()
    kernel = phase_kernel()
    cpu_models = phase_main_path()
    kernel["launches"] = phase_serve(cpu_models)
    phase_throughput(cpu_models, card)
    train_kernels = phase_train_kernels()
    launches, train_models = phase_train_path()
    for rec in train_kernels:
        rec["launches"] = launches[rec["name"]]
    phase_train_throughput(train_models, card)
    import torch
    log(card)
    log(json.dumps({"kernels": [kernel] + train_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
