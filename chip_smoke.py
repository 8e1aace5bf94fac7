#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py      # from the root of a checkout; one CUDA card

Phases, in order; any failure raises and the script exits non-zero
without printing the final ok line:

1. device: a CUDA card must be present (the CPU is never used instead);
   prints its name and power limit from nvidia-smi.
2. build: compiles csrc/sweep_warp_corr.cu with nvcc for sm_90a.
3. kernel: the kernel against its plain PyTorch version on the card at the
   shipped prior-scale shape, in float32 and bfloat16, plus an
   out-of-frame case; times both with CUDA events.
4. main path: forward_infer_fused of the shipped Config() models at
   640x192, float32 on the card against the same port on the CPU, and the
   same forward in bfloat16 autocast.
5. serve: the inference CLI on 4 synthetic frames and a .pth folder.
6. throughput: forward_infer frames/s in bfloat16 at batch 128 and 1.

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
    from movedepth_tpu_torch import native
    from movedepth_tpu_torch.ops import sweep_warp
    t0 = time.perf_counter()
    sweep_warp.kernel_library()
    seconds = time.perf_counter() - t0
    report = native.build_reports.get("sweep_warp_corr")
    log(f"[build] sweep_warp_corr: nvcc {' '.join(native.NVCC_FLAGS)} -> "
        f"{native.BUILD_DIR}, {seconds:.1f} s"
        + ("" if report else " (already built)"))
    if report:
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", report[1])]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                report[1]))
        log(f"[build] ptxas: {len(regs)} kernel instantiations, "
            f"{min(regs)}-{max(regs)} registers, {spills} bytes spilled")


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


def phase_kernel():
    """Kernel vs plain version on the card at the shipped prior-scale shape
    (batch cut to 16) with coordinates from the sweep grid of small,
    KITTI-like motions. Returns the kernel's summary record."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW
    from movedepth_tpu_torch.ops.costvolume import (schedule_depth_bins_z,
                                                    sweep_grid)
    from movedepth_tpu_torch.ops.geometry import transformation_from_parameters

    s = KERNEL_SHAPE
    b, r, w, c, d, g = s["B"], s["R"], s["W"], s["C"], s["D"], s["G"]
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    ref = torch.randn(b, r, w, c, generator=gen).to(dev)
    K = torch.tensor([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * r, 0.5 * r, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]]).repeat(b, 1, 1)
    aa = torch.randn(b, 3, generator=gen) * 5e-3
    tr = torch.randn(b, 3, generator=gen) * 3e-2
    tr[:, 2] -= 0.1
    T = transformation_from_parameters(aa, tr)
    prior = torch.rand(b, r, w, generator=gen) * 55 + 5
    bins = schedule_depth_bins_z(prior, d, 0.3, 30.0 * tr[:, 2].abs()[:, None,
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


def main():
    card = phase_device()
    phase_build()
    kernel = phase_kernel()
    cpu_models = phase_main_path()
    kernel["launches"] = phase_serve(cpu_models)
    phase_throughput(cpu_models, card)
    import torch
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
