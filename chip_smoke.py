#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py      # from the root of a checkout; one CUDA card

Phases, in order; any failure raises and the script exits non-zero
without printing the final ok line:

1. device: a CUDA card must be present (the CPU is never used instead);
   prints its name and power limit from nvidia-smi.
2. build: compiles every csrc/*.cu with nvcc for sm_90a, all at once, and
   the host loader csrc/loader.cpp with g++ beside them (its route: a,
   libjpeg and libpng; b, Pillow decode; and its build seconds); prints
   ptxas's registers, spills and static shared memory of the sweep-warp,
   warp-correlate (C=32, G=16) and image-warp kernels.
3. kernel: sweep_warp_corr against its plain PyTorch version on the card
   at the shipped prior-scale shape, in float32 and bfloat16, plus an
   out-of-frame case, and at every (C, G) pair it is built for on a small
   plane; times it at batch 16, 128 (the serving batch) and 1.
4. main path: forward_infer_fused of the shipped Config() models at
   640x192, float32 on the card against the same port on the CPU, and the
   same forward in bfloat16 autocast.
4b. the same float32 check at batch 1 and 8 bins with reg3d_c = 2, and
   with prior_scale = 3, reg3d_c = 64.
5. serve: the inference CLI on 4 synthetic frames and a .pth folder.
5b. eval, this slice's path: ``cli.export_gt`` and ``cli.evaluate`` (the
   eigen protocol) at 640x192, ResNet18, 16 bins, bfloat16, on a synthetic
   KITTI-raw tree of 12 test lines with calibration and velodyne scans:
   12 kernel launches at batch 1, 6 at batch 5 with --post_process (a
   partial last batch, two passes a batch); four finite tables each; the
   float32 disparities on the card against the CPU under phase 4's gates
   at batch 1 and at batch 2 with post_process, and one batch-5 forward's
   outputs (cost_prob included); images/s of predict_disparities at batch
   1 and 5 on the 12 lines repeated to 120, two passes each.
6. throughput: forward_infer frames/s in bfloat16 at batch 128, with the
   kernel and with its plain version in turns (twice each), and at batch 1.
7. train kernels: the sweep warp and the border image warp, forward and
   backward, against their plain versions (and autograd) at the shipped
   train shapes (batch 12), exact-bound and out-of-frame coordinates
   included, the sweep warp also at KITTI speed (~1 m between frames),
   the border warp's stack bit for bit; times kernel (the sweep warp's
   forward and whole backward, zero, kernel and cast, on both coordinate
   sets), plain version
   and library call; counts the CUDA kernels of one
   photometric_losses forward and backward with the border clamp in the
   kernels and in torch (torch.profiler, in a child process:
   ``chip_smoke.py --clamp-launches``).
7b. the L1 epilogue: the border image warp with a target (warped stack bit
   for bit, L1 map, and the coordinate gradient with both cotangents)
   against its plain version at batch 12, timed against it and against the
   two-step path (the row-4 warp kernel, then the L1 in torch).
8. train path: one train_step of the shipped Config(compute_dtype=
   "float32") models at 640x192, batch 2, on the card against the same step
   on the CPU (every loss; every model's gradient, against the spread the
   CPU shows between 1 thread and all of them), the kernel launches of that
   step, then one step of the shipped bfloat16 config.
8b. phase 8 with kernel_l1 on, under the same gates; its launches (the L1
   kernel 2 forward + 2 backward, the plain warp kernel none); the same
   losses as phase 8's card step within 1e-5.
9. train throughput: train_step in bfloat16 autocast at batch 12, with the
   kernels and with this script swapping in the plain versions, in turns
   (twice each); 9b: with kernel_l1 on.
10. train CLI: ``python -m movedepth_tpu_torch.cli.train`` on a
   KITTI-layout tree of synthetic 1242x375 JPEGs at 640x192, batch 12,
   bfloat16, --kernel_l1, with the native loader (its default; the CLI
   must say so), 2 epochs with validation and checkpoints, then a resume
   from ``last`` for a third epoch with ``--steps_per_dispatch 2`` (phase
   14's dispatch: one CUDA graph of the step, replayed twice, Adam's state
   from the checkpoint); its kernel launches, wall ms/step against phase
   9b's train_step.
10a. the train loader, this slice's path: ``Loader.epoch`` over 240 train
   lines of synthetic 1242x375 JPEGs at batch 12, 640x192, with flips and
   jitter, 12 threads: the PIL path and the C++ loader in turns, two
   passes each (samples/s, ms/batch, the host's CPU count); the native
   samples against the PIL samples of the same indices, each read timed
   one sample at a time.
10b. the train CLI's entry point in this process for one epoch of 10
   steps at batch 12 with validation at its default cadence, with
   --no-native_loader and with the native loader: wall ms/step of the
   epoch against phase 9b's train_step.
11. the stage ablations of the sweep kernel at batch 128 (``full`` bit for
   bit the shipped kernel), and the public wrapper against the bare launch.
12. data-parallel training, this slice's path. 12a: ``torchrun --standalone
   --nproc_per_node 1 -m movedepth_tpu_torch.cli.train`` (nccl) at 640x192,
   batch 12, bfloat16, --kernel_l1 on phase 10's tree, one epoch of 2 steps
   with validation and checkpoints: its ``dist:`` line, the launches of
   rows 2, 3 and 4b, weights_0 and last once each, its wall ms/step after
   the first step beside phase 10's. 12b: two ranks sharing the card over
   gloo (child processes, ``chip_smoke.py --ddp-rank R DIR``), float32 at
   640x192, 2 rows a rank, one train_step against one process's card step
   at batch 4 from the same weights, batch and draws: the losses within the
   train parity gates, each parameter's Adam update under the per-leaf rule
   of tests/test_sharding.py, the ranks' parameters identical, rows 2-5
   launched in each rank; one more step and one gradient all-reduce
   timed in each rank.
   12c: in this process, a world-1 nccl group: the bfloat16 batch-12
   train_step with the group (SyncBatchNorm, global masked means, gradient
   all-reduce) and without it, in turns, and the gradient all-reduce alone.
13. the serving export, this slice's path: ``cli/export_model.
   build_export`` of the bfloat16 640x192 forward with phase 5's weights,
   MVS at batch 1 and 128 and mono at batch 1: export, save, load, run;
   the loaded program against the live forward under phase 4's gates (and
   its worst difference), row 1's launches per call, loaded against live
   timed in turns.
14. the multi-step dispatch, this slice's path: ``steps_per_dispatch`` 4
   at bfloat16 batch 12, 640x192, kernel_l1: a CUDA graph of one step
   against eager steps (step 1's losses and gradients, later steps beside
   two eager runs' spread, and each replay against an eager step from its
   state), ms/step eager against graphed in turns without a group and
   under a world-1 nccl group, the memory the graph holds, launches of
   rows 2, 3 and 4b per replay (the train CLI's dispatch runs in phase
   10's resume).
15. the training variants, this slice's path. 15a: Reg2D (4 bins) and the
   DCN head at 640x192, ResNet18: forward_infer_fused at batch 1 and one
   float32 train_step at batch 2, card against CPU under phase 4's and
   phase 8's gates, their launches; rows 1-3 at D = 4 against their plain
   versions, and timed. 15b: bfloat16 parameter storage in the bfloat16
   kernel_l1 step at batch 12: the first step's losses against float32
   storage, the type of every parameter, gradient, Adam state and
   BatchNorm statistic, ms/step and peak memory in turns. 15c:
   rematerialization at batch 32 ("full", "mvs", none; cuDNN's heuristic
   algorithms, as the trainer runs a rematerialized step): step 1's losses, gradients and BatchNorm
   statistics against the plain step, launches, ms/step and peak memory
   in turns, and the remat step with bfloat16 parameters as a CUDA graph
   against two eager steps from each replay's state (losses, parameters,
   buffers and Adam moments). 15d: robust_train's
   offsets through ``Loader.epoch``, native against PIL; the train CLI
   with --robust_train --param_dtype bfloat16 --num_depth_bins 4 --dcn
   (its start-up lines) and a resume from ``last``.

16. the remaining modules, this slice's path: the modules and functions
   that no pipeline path runs, at 640x192, batch 2, float32, on the card
   against the same module, weights and inputs on the CPU (the tolerance
   printed), each with its device ms: upsample_nearest_2x, the per-pixel
   transforms (transformation_from_parameters_v2, project_per_pixel),
   project_pixel, schedule_depth_bins_v1 (plain, geo-masked, z-scaled),
   mvs_ssim, update_flow, depth_grid, ContextEncoder, PoseCNN, FPN3cas,
   MPMDecoder, DepthDecoder3D, DepthDecoderBin, DepthDecoder3Head,
   ResBlockWDSR and ContextAdjustmentLayer over phase 4's ResNet18
   features; flowvis's image and a PLY point cloud (host numpy) from the
   card's outputs against those from the CPU's.

After each phase a ``[time]`` line gives the seconds since the start.

Kernel times (``ms``) are device times: many bare launches (the typed C
function on preallocated outputs, no checks, no allocation) back to back
between two CUDA events, over the count, median of 5 runs. ``call_ms`` is
one call of the kernel's wrapper (its Function's backward through
autograd) between two events, synchronised after each: the gap is the
host work a caller pays. Every kernel's record carries its bound: the
least time the card could take, the larger of the bytes it must move over
3.35 TB/s and its float32 operations over 67 TFLOP/s (H100 SXM at 700 W),
and the device time of one PyTorch call computing the same function where
there is one (``F.grid_sample`` for rows 2 and 4,
``aten.grid_sampler_2d_backward`` for rows 3 and 5).

The lines before the last carry the card's nvidia-smi name and power limit
and a JSON summary of every kernel; the last line is the JSON ok record.
"""

import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

KERNEL_SHAPE = dict(B=16, R=48, W=160, C=32, D=16, G=16)
# the shipped train step's kernel shapes: batch 12, the prior-scale sweep
# (16 bins, 32 FPN channels) and the full-resolution warps of K = 6 maps
TRAIN_SHAPE = dict(B=12, R=48, W=160, C=32, D=16, H=192, X=640, K=6)
KERNELS = ("sweep_warp_corr", "sweep_warp", "image_warp",
           "sweep_warp_corr_variants")
ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM and float32 outside the
# tensor cores; every kernel here does float32 arithmetic
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound(nbytes, flops):
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` float32 operations."""
    b_ms, f_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return {"bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


# Work of each kernel from its shapes: each input read once, each output
# written once; operations counted per output point.
def sweep_corr_work(b, r, w, c, d, h, g, esize):
    """src (B,R,W,C), ref (B,H,W,C), sx/sy (B,D,H,W) f32 -> (B,D,H,W,G):
    four taps of C multiply-adds, the product with ref, the group mean and
    ~8 operations of tap weights per point."""
    pts = b * d * h * w
    return (b * (r + h) * w * c * esize + 2 * pts * 4 + pts * g * esize,
            pts * (8 * c + c + c + g + 8))


def sweep_warp_work(b, r, w, c, d, h, esize, backward=False):
    """Forward: src, coordinates -> (B,D,H,W,C). Backward: the (B,D,H,W,C)
    gradient and the coordinates -> dsrc (B,R,W,C)."""
    pts = b * d * h * w
    nbytes = b * r * w * c * esize + 2 * pts * 4 + pts * c * esize
    return nbytes, pts * (8 * c + (0 if backward else 8))


def image_warp_work(b, k, h, w, c, backward=False, l1=False):
    """Forward: images (B,H,W,C), coordinates -> (B,K,H,W,C) [+ target in,
    L1 (B,K,H,W) out]. Backward: images, coordinates, gradient [+ target,
    L1 gradient] -> dsx, dsy."""
    pts = b * k * h * w
    img = b * h * w * c * 4
    if backward:
        nbytes = img + 2 * pts * 4 + pts * c * 4 + 2 * pts * 4
        flops = pts * (14 * c + 4)
        if l1:
            nbytes += img + pts * 4
            flops += pts * (12 * c + 1)
    else:
        nbytes = img + 2 * pts * 4 + pts * c * 4
        flops = pts * (8 * c + 8)
        if l1:
            nbytes += img + pts * 4
            flops += pts * (3 * c + 1)
    return nbytes, flops


def _norm_grid(sx, sy, h, w):
    """Pixel coordinates (B, D, H', W') -> F.grid_sample's normalized grid
    (B, D*H', W', 2), align_corners=True, the D maps folded into rows."""
    import torch
    b, d, ho, wo = sx.shape
    grid = torch.stack([sx / (w - 1) * 2.0 - 1.0, sy / (h - 1) * 2.0 - 1.0],
                       dim=-1)
    return grid.reshape(b, d * ho, wo, 2)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, runs=20, warmup=3):
    """Median milliseconds of one ``fn`` call between two CUDA events,
    synchronised after each: device time plus the host work before the
    launch (``call_ms``, and the step times)."""
    from movedepth_tpu_torch.profile_kernel_variants import cuda_ms as timer
    return timer(fn, runs, warmup)


def device_ms(fn, launches=50, warmup=5):
    """The port's kernel timer: ``launches`` calls back to back between two
    CUDA events over the count, median of 5 such runs."""
    from movedepth_tpu_torch.profile_kernel_variants import device_ms as dm
    return dm(fn, launches, warmup)


def plain_ms(fn):
    """:func:`device_ms` of a plain version (milliseconds a call): fewer
    launches, since each takes a few milliseconds."""
    return device_ms(fn, launches=10, warmup=2)


def _bare(fn, *args):
    """A bare launch: the typed C function ``fn`` on ``args`` (tensors by
    pointer, ints as they are) and the current stream, no checks, no
    allocation and no launch count. Launches once and checks the error
    code; returns a function that launches again, for the timer."""
    import torch
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    vals.append(torch.cuda.current_stream().cuda_stream)
    err = fn(*vals)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"bare launch failed: CUDA error {err}")
    return lambda: fn(*vals)


def _grad_fn(out, inputs, g):
    """One backward through ``out``'s graph (the graph is kept)."""
    import torch
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


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
    from movedepth_tpu_torch import profile_kernel_variants as PKV
    from movedepth_tpu_torch.ops import image_warp, sweep_warp
    from movedepth_tpu_torch.data import native_loader as NL
    t0 = time.perf_counter()
    # the host loader's g++ beside the kernels' nvcc processes
    with ThreadPoolExecutor(1) as pool:
        loader = pool.submit(NL.get)
        native.build_all(KERNELS)
        loader = loader.result()
    report = native.build_reports.get(f"loader-{loader.route}")
    log(f"[build] loader: {loader.describe()}; {native.cxx()} "
        f"{' '.join(native.LOADER_FLAGS)} "
        f"{' '.join(sum(native.LOADER_ROUTES[loader.route], ()))} -> "
        f"{native.loader_path(loader.route).name}, "
        + (f"{report[0]:.1f} s" if report else "already built"))
    sweep_warp.kernel_library()
    sweep_warp.warp_library()
    image_warp.kernel_library()
    PKV.variant_library()
    log(f"[build] {', '.join(KERNELS)}: nvcc {' '.join(native.NVCC_FLAGS)} "
        f"-> {native.BUILD_DIR}, {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        report = native.build_reports.get(name)
        if not report:
            log(f"[build] {name}: already built")
            continue
        rows = native.ptxas_report(name)
        regs = [r[1] for r in rows]
        log(f"[build] {name}: ready after {report[0]:.1f} s; ptxas: "
            f"{len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
            f"registers, {sum(r[3] for r in rows)} bytes spilled")
    # every sweep-warp and image-warp kernel; of the warp-correlate pairs,
    # the shipped C=32, G=16 ones
    for name in ("sweep_warp", "image_warp", "sweep_warp_corr"):
        for kernel, regs, stack, spill, smem in native.ptxas_report(name):
            short = re.sub(r"\((int|bool)\)|<unnamed>::|^void ", "",
                           kernel)
            if short.endswith(")"):
                short = short[:short.rindex("(")]
            if name == "sweep_warp_corr" and ", 32, 16" not in short:
                continue
            log(f"[build] {short}: {regs} registers, {stack} bytes stack, "
                f"{spill} bytes spilled, {smem} bytes static shared memory")


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


def _sweep_coords(b, r, w, d, gen, scale=1.0):
    """Pixel coordinates (B, D, R, W) of the plane sweep over a depth prior
    (5-60 m) with z-guided bins, for a KITTI-like motion between frames
    (``_kitti_pose``; scale 1: ~0.1 m, scale 10: ~1 m, KITTI speed)."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW
    from movedepth_tpu_torch.ops.costvolume import (schedule_depth_bins_z,
                                                    sweep_grid)
    K = _kitti_K(b, r, w)
    T = _kitti_pose(b, gen, scale)
    prior = torch.rand(b, r, w, generator=gen) * 55 + 5
    bins = schedule_depth_bins_z(prior, d, 0.3, 30.0 * T[:, 2, 3].abs()[:, None,
                                                                        None])
    grid = sweep_grid(bins, K, torch.linalg.inv(K), T)
    return tuple(t.contiguous() for t in SW.grid_to_pixel(grid, r, w))


def _corr_times(b, gen, lib):
    """Device ms of the bare bfloat16 warp-correlate kernel at the shipped
    prior-scale shape and batch ``b``, on phase 3's kind of inputs."""
    import torch
    s = KERNEL_SHAPE
    r, w, c, d, g = s["R"], s["W"], s["C"], s["D"], s["G"]
    dev = torch.device("cuda")
    src = torch.randn(b, r, w, c, generator=gen).bfloat16().to(dev)
    ref = torch.randn(b, r, w, c, generator=gen).bfloat16().to(dev)
    sx, sy = (t.to(dev) for t in _sweep_coords(b, r, w, d, gen))
    out = torch.empty((b, d, r, w, g), dtype=torch.bfloat16, device=dev)
    return device_ms(_bare(lib.sweep_warp_corr_bf16, src, ref, sx, sy, out, b,
                           r, w, d, r, c, g))


# every (C, G) pair the JAX package fuses at the FPN's matching widths: G
# divides C and C/G is a power of two
SWC_PAIRS = [(c, c >> k) for c in (8, 16, 32, 64) for k in range(c.bit_length())]


def _check_pairs(dev):
    """sweep_warp_corr at every (C, G) pair of SWC_PAIRS against its plain
    version on a 16x40 plane, 16 planes of KITTI-like sweep coordinates,
    float32 and bfloat16, batch 2 and 1: within 1e-5 of the volume's range
    (plus one bf16 ulp of the float32 result in bfloat16). Raises on the
    first failure."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW
    gen = torch.Generator().manual_seed(5)
    b, r, w, d = 2, 16, 40, 16
    sx, sy = (t.to(dev) for t in _sweep_coords(b, r, w, d, gen))
    worst = -math.inf
    for c, g in SWC_PAIRS:
        src = torch.randn(b, r, w, c, generator=gen).to(dev)
        ref = torch.randn(b, r, w, c, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            for nb in (2, 1):
                args = [t[:nb].contiguous() for t in (src.to(dtype),
                                                      ref.to(dtype), sx, sy)]
                got = SW.sweep_warp_corr(*args, g)
                want = SW.sweep_warp_corr_reference(
                    args[0].float(), args[1].float(), *args[2:], g)
                torch.cuda.synchronize()
                excess = ((got.float() - want).abs() - 1e-5
                          * want.abs().max())
                if dtype == torch.bfloat16:
                    excess = excess - _bf16_ulp(want)
                worst = max(worst, excess.max().item())
                if (got.dtype != dtype or got.shape != want.shape
                        or not excess.max().item() <= 0):
                    raise RuntimeError(f"sweep_warp_corr C={c}, G={g}, "
                                       f"{dtype}, batch {nb} disagrees with "
                                       "the plain version")
    log(f"[kernel] every (C, G) pair: {len(SWC_PAIRS)} of {len(SWC_PAIRS)} "
        f"pairs pass ({SWC_PAIRS}) in float32 and bfloat16 at batch 2 and "
        f"1 on a {r}x{w} plane, {d} planes; worst excess over the tolerance "
        f"{worst:.3e} (must be <= 0)")


def phase_kernel(card):
    """Kernel vs plain version on the card at the shipped prior-scale shape
    (batch cut to 16) with coordinates from the sweep grid of small,
    KITTI-like motions; times at batch 16, 128 (the serving batch) and 1.
    Returns the kernel's summary record."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW

    s = KERNEL_SHAPE
    b, r, w, c, d, g = s["B"], s["R"], s["W"], s["C"], s["D"], s["G"]
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    ref = torch.randn(b, r, w, c, generator=gen).to(dev)
    sx, sy = (t.to(dev) for t in _sweep_coords(b, r, w, d, gen))

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

    _check_pairs(dev)

    lib = SW.kernel_library()
    times = {}
    for tag, (fs, fr) in (("bfloat16", (src16, ref16)), ("float32",
                                                          (src, ref))):
        out = torch.empty((b, d, r, w, g), dtype=fs.dtype, device=dev)
        fn = (lib.sweep_warp_corr_bf16 if fs.dtype == torch.bfloat16
              else lib.sweep_warp_corr_f32)
        times[tag] = (
            device_ms(_bare(fn, fs, fr, sx, sy, out, b, r, w, d, r, c, g)),
            cuda_ms(lambda: SW.sweep_warp_corr(fs, fr, sx, sy, g)),
            plain_ms(lambda: SW.sweep_warp_corr_reference(fs, fr, sx, sy,
                                                          g)))
        log(f"[kernel] {tag} at {s}: bare launch {times[tag][0]:.4f} ms "
            f"(device), one wrapper call {times[tag][1]:.4f} ms, plain "
            f"{times[tag][2]:.4f} ms")
    ms, call, plain = times["bfloat16"]
    rec = _record("sweep_warp_corr", "sweep_warp_corr.cu",
                  "movedepth_tpu/ops/pallas/sweep_warp.py:586", err32, ms,
                  plain, sweep_corr_work(b, r, w, c, d, r, g, 2), None, call)
    for nb in (128, 1):
        ms_nb = _corr_times(nb, gen, lib)
        bound_nb = bound(*sweep_corr_work(nb, r, w, c, d, r, g, 2))
        rec[f"ms_b{nb}"], rec[f"bound_ms_b{nb}"] = ms_nb, bound_nb["bound_ms"]
        log(f"[kernel] bfloat16 at batch {nb}: bare launch {ms_nb:.4f} ms "
            f"(device), bound {bound_nb['bound_ms']:.4f} ms "
            f"({bound_nb['bound_ms'] / ms_nb:.1%} of it); {card}")
    log(f"[kernel] bfloat16 at batch {b}: bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_ms'] / ms:.1%} of it); {card}")
    return rec


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


def _check_gates(label, got, want):
    """Log the card-vs-CPU statistics of a forward's outputs, each line
    starting with ``label``, and raise unless every one is finite and
    within GATES."""
    import torch
    failed = []
    for key in ("disp_mono", "cost_prob", "depth_mvs", "depth_fused"):
        if not torch.isfinite(got[key]).all():
            failed.append(f"{key} not finite")
        st = _stats(got[key], want[key])
        log(f"{label} float32 card vs CPU {key}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in st.items()))
        failed += [f"{key}.{k} {st[k]:.3e} > {bound}"
                   for (name, k), bound in GATES.items()
                   if name == key and not st[k] <= bound]
    if failed:
        raise RuntimeError(f"{label} card vs CPU gates failed: "
                           + "; ".join(failed))


def phase_main_path():
    """forward_infer_fused of the shipped Config() models (ResNet18,
    640x192, 16 bins, convex upsampling) at batch 2: float32 on the card
    against the CPU, then bfloat16 autocast on the card. Returns the CPU
    models (tempered) for the serve phase."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models

    cfg32 = Config(compute_dtype="float32")
    cpu_models = build_models(cfg32, "cpu", torch.Generator().manual_seed(0))
    _temper_pose_head(cpu_models)
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    batch = P.synthetic_batch(cfg32, 2, seed=0, device="cpu")
    t0 = time.perf_counter()
    want = P.forward_infer_fused(cpu_models, batch, cfg32)
    log(f"[main] CPU float32 forward_infer_fused at batch 2: "
        f"{time.perf_counter() - t0:.1f} s")
    gpu_batch = P.as_batch(batch, "cuda")
    before = _corr_launches()
    got = P.forward_infer_fused(models, gpu_batch, cfg32)
    torch.cuda.synchronize()
    if _corr_launches() != before + 1:
        raise RuntimeError(f"sweep_warp_corr launched "
                           f"{_corr_launches() - before} times in one "
                           "forward, expected 1")
    _check_gates("[main]", got, want)
    log(f"[main] float32 gates pass: {GATES}; sweep_warp_corr launched once")

    cfg16 = Config()  # compute_dtype bfloat16: models under autocast
    before = _corr_launches()
    got16 = P.forward_infer_fused(models, gpu_batch, cfg16)
    torch.cuda.synchronize()
    if _corr_launches() != before + 1:
        raise RuntimeError("bfloat16 forward did not launch the kernel once")
    for key in ("disp_mono", "cost_prob", "depth_mvs", "depth_fused"):
        if not torch.isfinite(got16[key]).all():
            raise RuntimeError(f"bfloat16 {key} is not finite")
        st = _stats(got16[key], got[key])
        log(f"[main] bfloat16 vs float32 on the card {key}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in st.items()))
    return cpu_models


def phase_group_configs():
    """forward_infer_fused at 640x192, batch 1, 8 depth bins, in the two
    configurations whose (C, G) pairs the kernel gained last: reg3d_c = 2
    (C = 32) and prior_scale = 3 with reg3d_c = 64 (C = 64). float32 on the
    card against the same port on the CPU under phase 4's gates, and the
    cost volume itself within 1e-3 of its range (random weights make the
    prior-scale-3 features tiny, so its softmax is uniform to float32); one
    kernel launch each."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models

    for prior_scale, groups in ((2, 2), (3, 64)):
        cfg = Config(compute_dtype="float32", prior_scale=prior_scale,
                     reg3d_c=groups, num_depth_bins=8)
        tag = f"prior_scale {prior_scale}, reg3d_c {groups}"
        cpu_models = build_models(cfg, "cpu",
                                  torch.Generator().manual_seed(0))
        _temper_pose_head(cpu_models)
        models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
        batch = P.synthetic_batch(cfg, 1, seed=0, device="cpu")
        costs, kernel = [], P.sweep_warp_corr

        def record(*args):
            costs.append(kernel(*args))
            return costs[-1]

        P.sweep_warp_corr = record
        try:
            want = P.forward_infer_fused(cpu_models, batch, cfg)
            before = _corr_launches()
            got = P.forward_infer_fused(models, P.as_batch(batch, "cuda"),
                                        cfg)
            torch.cuda.synchronize()
        finally:
            P.sweep_warp_corr = kernel
        if _corr_launches() != before + 1:
            raise RuntimeError(f"{tag}: sweep_warp_corr launched "
                               f"{_corr_launches() - before} times, "
                               "expected 1")
        scale = costs[0].abs().max().item()
        rel = (costs[1].cpu() - costs[0]).abs().max().item() / scale
        log(f"[groups] {tag}: cost volume {tuple(costs[1].shape)}, card vs "
            f"CPU max difference {rel:.3e} of its range {scale:.3e}")
        if not rel <= 1e-3:
            raise RuntimeError(f"{tag}: the card's cost volume differs from "
                               "the CPU's")
        _check_gates(f"[groups] {tag}:", got, want)
        log(f"[groups] {tag} (C={8 << prior_scale}, G={groups}): "
            "phase 4's gates pass; sweep_warp_corr launched once")


def phase_serve(cpu_models):
    """The serving CLI on 4 synthetic 640x192 frames and a .pth folder of
    the same (tempered) weights, in the shipped bfloat16 config. Returns
    the kernel launches of the run."""
    import numpy as np
    import torch
    from PIL import Image
    from movedepth_tpu_torch.cli import infer

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
        before = _corr_launches()
        t0 = time.perf_counter()
        infer.main(["--image_path", frames, "--load_weights_folder", weights,
                    "--out_dir", out, "--fused"])
        torch.cuda.synchronize()
        launches = _corr_launches() - before
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


def _eval_cli(tag, args):
    """``cli.evaluate.main(args)`` in this process with the launch count
    set to 0 just before; returns (its results, its output, the launches
    counted, the launches it printed)."""
    import contextlib
    import io
    import torch
    from movedepth_tpu_torch.cli import evaluate
    out = io.StringIO()
    before = _corr_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = evaluate.main(args)
    torch.cuda.synchronize()
    launches = _corr_launches() - before
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[eval]   {line}")
    printed = [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("kernel launches: ")]
    log(f"[eval] {tag}: cli.evaluate in {time.perf_counter() - t0:.1f} s")
    return results, text, launches, printed


def _check_tables(tag, results, text):
    """Four finite tables, and the oracle at least as good as either
    branch."""
    import numpy as np
    names = re.findall(r"(\w+) results:", text)
    if names != ["mono", "mvs", "fused", "upbound"]:
        raise RuntimeError(f"{tag}: printed tables {names}")
    if not all(np.isfinite(r).all() for r in results.values()):
        raise RuntimeError(f"{tag}: a metric is not finite: {results}")
    if not results["upbound"][0] <= min(results["mono"][0],
                                        results["mvs"][0]):
        raise RuntimeError(f"{tag}: upbound abs_rel above a branch's")


def _check_disparities(label, got, want):
    """Hold ``predict_disparities``'s (mono, mvs, fused) card disparities
    against the CPU's: the mono one under disp_mono's gates, the MVS one
    under depth_mvs's (x and 1/x have the same relative error to first
    order); the fused one, like phase 4's depth_fused, finite."""
    import torch
    failed = []
    for name, key, g, w in zip(("mono", "mvs", "fused"),
                               ("disp_mono", "depth_mvs", None), got, want):
        g, w = torch.from_numpy(g), torch.from_numpy(w)
        if not torch.isfinite(g).all():
            failed.append(f"{name} not finite")
        st = _stats(g, w)
        log(f"{label} float32 card vs CPU {name} disparity: " + ", ".join(
            f"{k} {v:.3e}" for k, v in st.items()))
        failed += [f"{name}.{k} {st[k]:.3e} > {bound}"
                   for (gate, k), bound in GATES.items()
                   if gate == key and not st[k] <= bound]
    if failed:
        raise RuntimeError(f"{label} card vs CPU gates failed: "
                           + "; ".join(failed))


def _eval_batch(data, split_dir, bsz, device):
    """The first batch of ``bsz`` test lines as ``predict_disparities``
    loads it, on ``device``."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch.data.kitti import KITTIRawDataset, readlines
    from movedepth_tpu_torch.data.loader import Loader
    cfg = Config()
    lines = readlines(os.path.join(split_dir, "test_files.txt"))[:bsz]
    dataset = KITTIRawDataset(data, lines, cfg.height, cfg.width,
                              cfg.matching_ids, is_train=False,
                              load_depth=False)
    batch = next(iter(Loader(dataset, bsz, shuffle=False, drop_last=False,
                             num_workers=4).epoch(0)))
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ("color", "K", "inv_K")}


def phase_eval(cpu_models, card):
    """This slice's path: the eigen evaluation at full width (the shipped
    Config(): 640x192, ResNet18, 16 bins, bfloat16) with phase 5's weights
    as a .pth folder, on a synthetic KITTI-raw tree of EVAL_LINES test
    lines with calibration and velodyne scans. Exports the GT with
    ``cli.export_gt``, runs ``cli.evaluate`` at batch 1 (a launch a line)
    and at batch 5 with ``--post_process`` (a partial last batch, two
    passes a batch), holds float32 card disparities against the CPU's on 2
    images under phase 4's gates (at batch 1, and at batch 2 with
    ``post_process``) and one batch-5 forward's outputs, and times
    ``predict_disparities`` on the lines repeated to EVAL_TIMED_LINES.
    Returns the launches of the two CLI runs."""
    import numpy as np
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.cli import export_gt
    from movedepth_tpu_torch.eval import evaluate as E

    n = EVAL_LINES
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "kitti")
        splits = _write_eval_tree(data)
        weights = os.path.join(tmp, "weights")
        os.makedirs(weights)
        for name, m in cpu_models.items():
            torch.save(m.state_dict(), os.path.join(weights, f"{name}.pth"))

        t0 = time.perf_counter()
        gt_path = export_gt.main(["--data_path", data, "--splits_dir",
                                  splits, "--split", "eigen"])
        gt = E.load_gt_depths(gt_path)
        inside = [int(E.eigen_mask(g).sum()) for g in gt]
        log(f"[eval] cli.export_gt: {len(gt)} maps in "
            f"{time.perf_counter() - t0:.1f} s, shapes "
            f"{sorted({g.shape for g in gt})}, valid pixels in the eigen "
            f"crop {min(inside)}-{max(inside)}")
        if (len(gt) != n or any(g.shape != (375, 1242) for g in gt)
                or min(inside) < 100):
            raise RuntimeError("the exported GT is not 12 sparse 375x1242 "
                               "maps filling the eigen crop")

        common = ["--data_path", data, "--load_weights_folder", weights,
                  "--splits_dir", splits, "--num_workers", "8"]
        launches = {}
        for tag, extra, want in (
                ("batch_1", ["--batch_size", "1"], n),
                ("batch_5_post_process", ["--batch_size", "5",
                                          "--post_process"],
                 2 * math.ceil(n / 5))):
            results, text, count, printed = _eval_cli(tag, common + extra)
            _check_tables(tag, results, text)
            log(f"[eval] {tag}: four finite tables; sweep_warp_corr "
                f"launched {count} times (printed {printed}), expected "
                f"{want}")
            if count != want or printed != [{"sweep_warp_corr": want}]:
                raise RuntimeError(f"{tag}: expected {want} launches")
            launches[tag] = count

        # float32 on the card against the CPU, on the first 2 images: at
        # batch 1, and at batch 2 with post_process (both passes of a batch
        # blended); then one batch-5 forward's outputs, cost_prob included
        cfg32 = Config(compute_dtype="float32")
        models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
        eigen = os.path.join(splits, "eigen")
        for label, bsz, cfg_run in (
                ("batch 1", 1, cfg32),
                ("batch 2 post_process", 2, cfg32.replace(post_process=True))):
            got, want = (E.predict_disparities(on, cfg_run, data, eigen, bsz,
                                               limit=2, device=dev)
                         for on, dev in ((models, "cuda"),
                                         (cpu_models, "cpu")))
            _check_disparities(f"[eval] {label}", got, want)
            rows = {dev: E.evaluate_disparities(*p[:2], gt[:2],
                                                pred_disps_fused=p[2])
                    for dev, p in (("card", got), ("CPU", want))}
            for dev, res in rows.items():
                log(f"[eval] {label} float32 {dev} rows on 2 images: "
                    + "; ".join(f"{k} " + " ".join(f"{v:.4f}" for v in r)
                                for k, r in res.items()))
        with torch.no_grad():
            _check_gates("[eval] batch 5", *(
                P.forward_infer_fused(on, _eval_batch(data, eigen, 5, dev),
                                      cfg32)
                for on, dev in ((models, "cuda"), (cpu_models, "cpu"))))
        log("[eval] float32 card vs CPU at batch 1, batch 2 with "
            "post_process and batch 5: phase 4's gates pass")

        # throughput of predict_disparities in the shipped bfloat16 config,
        # on the 12 lines repeated to EVAL_TIMED_LINES (seconds a pass)
        timed = os.path.join(splits, "timed")
        os.makedirs(timed)
        lines = [f"{DRIVE} {i} l" for i in range(1, n + 1)]
        n_timed = EVAL_TIMED_LINES
        with open(os.path.join(timed, "test_files.txt"), "w") as f:
            f.write("\n".join(lines * (n_timed // n)))
        cfg = Config()
        for bsz in (1, 5):
            E.predict_disparities(models, cfg, data, timed, bsz, limit=2 * bsz,
                                  device="cuda")  # warm (cuDNN autotuning)
            for run in range(2):
                t0 = time.perf_counter()
                preds = E.predict_disparities(models, cfg, data, timed, bsz,
                                              device="cuda")
                sec = time.perf_counter() - t0
                log(f"[eval] predict_disparities bfloat16 batch {bsz}, pass "
                    f"{run + 1}: {n_timed} images in {sec:.3f} s, "
                    f"{n_timed / sec:.2f} "
                    f"images/s (JPEG decode and resize included); {card}")
        t0 = time.perf_counter()
        E.evaluate_disparities(*preds[:2], gt[np.arange(n_timed) % n],
                               pred_disps_fused=preds[2])
        log(f"[eval] evaluate_disparities (host) on {n_timed} images: "
            f"{(time.perf_counter() - t0) / n_timed:.4f} s per image; "
            f"{card}")
    log(f"[eval] phase 5b: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_throughput(cpu_models, card):
    """forward_infer frames/s in bfloat16 (bench.py's program) at batch 128,
    with the kernel and with this script swapping in its plain version, in
    turns (kernel, plain, kernel, plain), then at batch 1 (the eval
    protocol); CUDA events after warmup."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.ops import sweep_warp as SW

    cfg = Config()
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    torch.backends.cudnn.benchmark = True
    kernel = P.sweep_warp_corr
    runs = [(128, 6, "kernel"), (128, 6, "plain"), (128, 6, "kernel"),
            (128, 6, "plain"), (1, 30, "kernel")]
    batches = {bsz: P.synthetic_batch(cfg.replace(frame_ids=cfg.matching_ids),
                                      bsz, seed=1, device="cuda")
               for bsz in (128, 1)}  # one numpy batch of 128 takes seconds
    for bsz, iters, label in runs:
        batch = batches[bsz]
        torch.cuda.reset_peak_memory_stats()
        P.sweep_warp_corr = (kernel if label == "kernel"
                             else SW.sweep_warp_corr_reference)
        try:
            ms = cuda_ms(lambda: P.forward_infer(models, batch, cfg),
                         runs=iters, warmup=3)
        finally:
            P.sweep_warp_corr = kernel
        log(f"[throughput] forward_infer bfloat16 batch {bsz}, {label}: "
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


def _bitwise(name, got, want):
    """Raise unless got equals want bit for bit; returns max |got - want|
    (0.0)."""
    import torch
    err = _within(name, got, want)
    if not torch.equal(got, want):
        raise RuntimeError(f"{name}: not the plain version bit for bit")
    log(f"[train-kernel] {name}: equal to the plain version bit for bit")
    return err


def _edge_cases(sx, sy, w, h):
    """Coordinates exactly on 0, W-1, R-1 and outside the frame in the
    first row of every map, and one map shifted wholly out of frame."""
    import torch
    sx[:, :, 0, :8] = torch.tensor([0.0, w - 1.0, -0.5, w - 0.5, -3.0,
                                    w + 4.0, 0.0, w - 1.0])
    sy[:, :, 0, :8] = torch.tensor([0.0, h - 1.0, 3.0, 2.0, h - 0.5, -0.5,
                                    h - 1.0, 0.0])
    sx[:, 1] += 2.0 * w


def _clamp_launches(card):
    """CUDA kernels of one photometric_losses forward and backward at the
    shipped train shape (batch 12, 640x192, kernel_l1 off), by
    torch.profiler: with the border clamp in the warp kernels (now), and
    with the clamp done in torch before the launch (as the warp's wrapper
    did before; the clamp's 4 elementwise passes and their backward)."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.ops import image_warp as IW
    from torch.profiler import ProfilerActivity, profile

    cfg = Config()
    b, h, w = cfg.batch_size, cfg.height, cfg.width
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    batch = P.synthetic_batch(cfg, b, seed=2, device="cuda")
    disps = {("disp", s): (torch.rand(b, h >> s, w >> s, generator=gen)
                           * 0.3 + 0.01).to(dev).requires_grad_()
             for s in cfg.scales}
    depth = (torch.rand(b, h, w, generator=gen) * 40 + 5).to(dev)
    depth.requires_grad_()
    fused = (torch.rand(b, h, w, generator=gen) * 40 + 5).to(dev)
    cam = {f: _kitti_pose(b, gen, scale=3.0).to(dev).requires_grad_()
           for f in cfg.frame_ids[1:]}
    leaves = list(disps.values()) + [depth] + list(cam.values())
    noise = P.sample_draws(cfg, b, torch.Generator("cuda").manual_seed(2),
                           device="cuda")["noise"]

    def step():
        losses, _ = P.photometric_losses(disps, depth, fused, batch, cam,
                                         cfg, noise)
        torch.autograd.grad(losses["mono_loss"] + losses["mvs_loss"]
                            + losses["fuse_reproj_loss"], leaves)

    def kernels():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    def clamp_first(src, sx, sy, target=None):
        x, y = IW.clamp_coords(sx, sy, src.shape[1], src.shape[2])
        return IW.warp_images_border(src, x, y, target=target)

    now = kernels()
    shipped, P.warp_images_border = P.warp_images_border, clamp_first
    try:
        before = kernels()
    finally:
        P.warp_images_border = shipped
    if now == 0 or before <= now:
        raise RuntimeError(f"clamp launches: torch.profiler counted {before} "
                           f"CUDA kernels with the clamp in torch and {now} "
                           "with it in the warp kernels")
    log(f"[train-kernel] photometric_losses forward + backward at batch {b}, "
        f"{w}x{h}: {before} CUDA kernels with the clamp in torch, {now} "
        f"with it in the warp kernels: {before - now} launches saved per "
        f"step (torch.profiler); {card}")


def _dsrc_check(name, src, sx, sy, g, bf16=False):
    """The sweep warp's source gradient through the kernel (the op
    ``movedepth::sweep_warp_bwd``) against the plain version's autograd on the same inputs, in
    float32 (bf16: src and g rounded to bfloat16 first, the plain version
    in float32). Returns (max |kernel - plain|, the kernel's dsrc)."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW
    if bf16:
        src, g = src.bfloat16(), g.bfloat16()
    leaf = src.clone().requires_grad_()
    got = torch.autograd.grad(SW.sweep_warp(leaf, sx, sy), leaf, g)[0]
    ref = src.float().requires_grad_()
    want = torch.autograd.grad(SW.sweep_warp_reference(ref, sx, sy), ref,
                               g.float())[0]
    if got.dtype != src.dtype:
        raise RuntimeError(f"{name}: dsrc is {got.dtype}, src {src.dtype}")
    return _within(name, got, want, bf16=bf16), got


def phase_sweep_warp(card):
    """The train step's sweep warp at the shipped train shape (batch 12):
    forward in float32 and bfloat16 against the plain version, and its
    source gradient in both against the plain version's autograd, on phase
    7's coordinates (exact-bound and out-of-frame ones included; the
    float32 gradient twice, for the run-to-run difference) and on
    KITTI-speed coordinates. Times, in bfloat16, each on both coordinate
    sets: the forward (bare launch) and the whole backward (every launch
    ``movedepth::sweep_warp_bwd`` makes, on preallocated tensors: zero the
    float32 buffer, the kernel, the cast); then the plain versions and the
    library calls. Returns the two kernels' summary records and ``gen``,
    for phase 7's image warp."""
    import torch
    import torch.nn.functional as F
    from movedepth_tpu_torch.ops import sweep_warp as SW

    s = TRAIN_SHAPE
    b, r, w, c, d = s["B"], s["R"], s["W"], s["C"], s["D"]
    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    sx, sy = _sweep_coords(b, r, w, d, gen)
    _edge_cases(sx, sy, w, r)
    sx, sy = sx.to(dev), sy.to(dev)
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    g = torch.randn((b, d, r, w, c), generator=gen).to(dev)
    fast = tuple(t.to(dev) for t in _sweep_coords(
        b, r, w, d, torch.Generator().manual_seed(3), 10.0))
    coords = {"phase 7": (sx, sy), "KITTI speed": fast}

    src16 = src.bfloat16()
    err_fwd = 0.0
    for tag, (x, y) in coords.items():
        err_fwd = max(err_fwd, _within(
            f"sweep_warp float32 forward, {tag}", SW.sweep_warp(src, x, y),
            SW.sweep_warp_reference(src, x, y)))
        _within(f"sweep_warp bfloat16 forward, {tag}",
                SW.sweep_warp(src16, x, y),
                SW.sweep_warp_reference(src16.float(), x, y), bf16=True)

    err_bwd, runs = 0.0, []
    for tag, (x, y) in coords.items():
        for i in range(2 if tag == "phase 7" else 1):
            err, got = _dsrc_check(f"sweep_warp float32 dsrc, {tag}, run "
                                   f"{i + 1}", src, x, y, g)
            err_bwd = max(err_bwd, err)
            if tag == "phase 7":
                runs.append(got)
        _dsrc_check(f"sweep_warp bfloat16 dsrc, {tag}", src, x, y, g, True)
    log(f"[train-kernel] sweep_warp dsrc run-to-run max difference "
        f"{(runs[0] - runs[1]).abs().max().item():.3e} (float32 atomics; "
        f"max|dsrc| {runs[0].abs().max().item():.3e})")

    # bfloat16, the train path's dtype, for the times
    lib = SW.warp_library()
    g16 = g.bfloat16()
    out16 = torch.empty((b, d, r, w, c), dtype=torch.bfloat16, device=dev)
    dsrc16 = torch.empty((b, r, w, c), dtype=torch.bfloat16, device=dev)
    dsrc32 = torch.zeros((b, r, w, c), device=dev)
    ms_fwd, ms_bwd = {}, {}
    for tag, (x, y) in coords.items():
        ms_fwd[tag] = device_ms(_bare(lib.sweep_warp_fwd_bf16, src16, x, y,
                                      out16, b, r, w, d, r, c))
        launch = _bare(lib.sweep_warp_bwd_bf16, g16, x, y, dsrc32, b, r, w, d,
                       r, c)

        def whole(launch=launch):
            dsrc32.zero_()
            launch()
            dsrc16.copy_(dsrc32)
        ms_bwd[tag] = device_ms(whole)
    call_fwd = cuda_ms(lambda: SW.sweep_warp(src16, sx, sy))
    plain_fwd = plain_ms(lambda: SW.sweep_warp_reference(src16, sx, sy))
    leaf16 = src16.clone().requires_grad_()
    call_bwd = cuda_ms(_grad_fn(SW.sweep_warp(leaf16, sx, sy), leaf16, g16))
    plain_bwd = plain_ms(_grad_fn(SW.sweep_warp_reference(leaf16, sx, sy),
                                  leaf16, g16))
    # the library call: one F.grid_sample (zeros padding, the D maps folded
    # into the grid's rows) on the NCHW source, and its input gradient
    # straight from aten (no autograd)
    src_nchw = src16.permute(0, 3, 1, 2).contiguous()
    grid16 = _norm_grid(sx, sy, r, w).bfloat16()
    sample = dict(mode="bilinear", padding_mode="zeros", align_corners=True)
    lib_fwd = device_ms(lambda: F.grid_sample(src_nchw, grid16, **sample))
    g_nchw = g16.permute(0, 4, 1, 2, 3).reshape(b, c, d * r, w).contiguous()
    lib_bwd = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, src_nchw, grid16, 0, 0, True, [True, False]))
    work_bwd = sweep_warp_work(b, r, w, c, d, r, 2, True)
    work_fwd = sweep_warp_work(b, r, w, c, d, r, 2)
    log(f"[train-kernel] sweep_warp bfloat16 at {s}, device ms: forward "
        "kernel " + ", ".join(f"{ms:.4f} on {k} coordinates"
                              for k, ms in ms_fwd.items())
        + f"; bound {bound(*work_fwd)['bound_ms']:.4f}; plain "
        f"{plain_fwd:.4f}, grid_sample {lib_fwd:.4f}; whole backward (zero, "
        "kernel, cast) "
        + ", ".join(f"{ms:.4f} on {k} coordinates" for k, ms in ms_bwd.items())
        + f"; bound {bound(*work_bwd)['bound_ms']:.4f}; plain "
        f"{plain_bwd:.4f}, grid_sampler_2d_backward {lib_bwd:.4f}; one "
        f"wrapper call {call_fwd:.4f} forward, {call_bwd:.4f} backward; "
        f"{card}")
    fwd = _record("sweep_warp", "sweep_warp.cu",
                  "movedepth_tpu/ops/pallas/sweep_warp.py:662", err_fwd,
                  ms_fwd["phase 7"], plain_fwd, work_fwd, lib_fwd, call_fwd)
    fwd["ms_kitti_speed"] = ms_fwd["KITTI speed"]
    bwd = _record("sweep_warp_bwd", "sweep_warp.cu",
                  "movedepth_tpu/ops/pallas/sweep_warp.py:618", err_bwd,
                  ms_bwd["phase 7"], plain_bwd, work_bwd, lib_bwd, call_bwd)
    bwd["ms_kitti_speed"] = ms_bwd["KITTI speed"]
    return [fwd, bwd], gen


def phase_train_kernels(card, gen):
    """The border image warp and its coordinate gradient against their
    plain versions at the shipped train shape (batch 12, K = 6 maps,
    640x192), inputs drawn from ``gen`` after phase 7's sweep-warp inputs,
    each timed against its plain version and its library call; then the
    clamp-launch count. Returns (the kernels' summary records, the image
    warp's inputs)."""
    import torch
    import torch.nn.functional as F
    from movedepth_tpu_torch.ops import image_warp as IW
    from movedepth_tpu_torch.ops import sweep_warp as SW
    from movedepth_tpu_torch.ops.geometry import backproject, project

    s = TRAIN_SHAPE
    b = s["B"]
    dev = torch.device("cuda")
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
    err_img = _bitwise("warp_images_border forward",
                       IW.warp_images_border(img, gx, gy),
                       IW.warp_images_border_reference(img, gx, gy))
    x, y = gx.clone().requires_grad_(), gy.clone().requires_grad_()
    got = torch.autograd.grad(IW.warp_images_border(img, x, y), (x, y), gi)
    want = torch.autograd.grad(IW.warp_images_border_reference(img, x, y),
                               (x, y), gi)
    err_coord = max(_within("warp_images_border dsx", got[0], want[0]),
                    _within("warp_images_border dsy", got[1], want[1]))
    iw = IW.kernel_library()
    out = torch.empty((b, k, hh, xx, 3), device=dev)
    dsx, dsy = torch.empty_like(gx), torch.empty_like(gy)
    ms_img = device_ms(_bare(iw.warp_images_border_fwd, img, gx, gy, out, b,
                             hh, xx, k, 3, IW.aligned(gx, gy, out)))
    ms_coord = device_ms(_bare(iw.warp_images_border_bwd, img, gx, gy, gi,
                               dsx, dsy, b, hh, xx, k, 3,
                               IW.aligned(gx, gy, gi, dsx, dsy)))
    call_img = cuda_ms(lambda: IW.warp_images_border(img, x, y))
    call_coord = cuda_ms(_grad_fn(IW.warp_images_border(img, x, y), (x, y),
                                  gi))
    plain_img = plain_ms(lambda: IW.warp_images_border_reference(img, gx, gy))
    plain_coord = plain_ms(_grad_fn(IW.warp_images_border_reference(img, x,
                                                                    y),
                                    (x, y), gi))
    # the library call: F.grid_sample in border mode, the K maps folded into
    # the grid's rows, and its grid gradient straight from aten
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = _norm_grid(gx, gy, hh, xx)
    border = dict(mode="bilinear", padding_mode="border", align_corners=True)
    lib_img = device_ms(lambda: F.grid_sample(img_nchw, grid, **border))
    gi_nchw = gi.permute(0, 4, 1, 2, 3).reshape(b, 3, k * hh, xx).contiguous()
    lib_coord = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        gi_nchw, img_nchw, grid, 0, 1, True, [False, True]))
    log(f"[train-kernel] warp_images_border float32 at B={b}, K={k}, "
        f"{hh}x{xx}, device ms: forward kernel {ms_img:.4f}, plain "
        f"{plain_img:.4f}, grid_sample {lib_img:.4f}; coordinate backward "
        f"kernel {ms_coord:.4f}, plain {plain_coord:.4f}, "
        f"grid_sampler_2d_backward {lib_coord:.4f}; one wrapper call "
        f"{call_img:.4f} forward, {call_coord:.4f} backward")
    # in a process of its own: the profiler's tracing stays out of the
    # timings that follow
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--clamp-launches"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        raise RuntimeError("the clamp-launch count failed:\n"
                           + proc.stderr[-4000:])

    records = [
        _record("warp_images_border", "image_warp.cu",
                "movedepth_tpu/ops/pallas/image_warp.py:576", err_img, ms_img,
                plain_img, image_warp_work(b, k, hh, xx, 3), lib_img,
                call_img),
        _record("warp_images_border_coord_bwd", "image_warp.cu",
                "movedepth_tpu/ops/pallas/image_warp.py:443", err_coord,
                ms_coord, plain_coord,
                image_warp_work(b, k, hh, xx, 3, backward=True), lib_coord,
                call_coord),
    ]
    return records, (img, gx, gy)


def _record(name, source, replaces, err, ms, plain_ms, work, library_ms,
            call_ms):
    """A kernel's summary record: ``ms`` the device time of its bare launch,
    ``call_ms`` one call of its wrapper (the gap is the caller's host
    cost)."""
    return {"name": name, "route": "cuda",
            "source": f"movedepth_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(*work),
            "library_ms": library_ms, "call_ms": call_ms}


def phase_l1_kernel(img, gx, gy):
    """Kernel 4b, the border warp with the photometric L1 epilogue, against
    its plain version at phase 7's train shape and coordinates (exact
    bounds, out of frame). Rows 100-103 of every map sit on the pixel grid
    and the target equals the image there, so |warped - target| is exactly
    0 (sign 0 in the cotangent); elsewhere the target is the image offset
    by 0.01-0.1 of either sign. Checks the warped stack, the L1 map, and
    dsx, dsy with both cotangents nonzero, in float32 within 1e-5 of each
    output's range. Times the kernels against the plain version and the
    forward against the two-step path (the row-4 kernel, then the L1 in
    torch). Returns the two kernels' records."""
    import torch
    from movedepth_tpu_torch.ops import image_warp as IW

    b, hh, xx, c = img.shape
    k = gx.shape[1]
    dev = img.device
    gen = torch.Generator().manual_seed(4)
    rows = slice(100, 104)
    gx, gy = gx.clone(), gy.clone()
    gx[:, :, rows] = torch.arange(xx, dtype=torch.float32, device=dev)
    gy[:, :, rows] = torch.arange(100, 104, dtype=torch.float32,
                                  device=dev)[:, None]
    sign = torch.where(torch.rand(img.shape, generator=gen) < 0.5, -1.0, 1.0)
    off = (torch.rand(img.shape, generator=gen) * 0.09 + 0.01) * sign
    off[:, rows] = 0.0
    tgt = img + off.to(dev)
    gi = torch.randn((b, k, hh, xx, c), generator=gen).to(dev)
    gl = torch.randn((b, k, hh, xx), generator=gen).to(dev)

    x, y = gx.clone().requires_grad_(), gy.clone().requires_grad_()
    got_w, got_l1 = IW.warp_images_border(img, x, y, target=tgt)
    xr, yr = gx.clone().requires_grad_(), gy.clone().requires_grad_()
    want_w, want_l1 = IW.warp_images_border_l1_reference(img, xr, yr, tgt)
    err_w = _bitwise("warp_images_border_l1 warped", got_w, want_w)
    err_l1 = _within("warp_images_border_l1 l1", got_l1, want_l1)
    if got_l1[:, :, rows].abs().max().item() != 0:
        raise RuntimeError("the L1 of exact samples of the target is not 0")
    got = torch.autograd.grad((got_w, got_l1), (x, y), (gi, gl))
    want = torch.autograd.grad((want_w, want_l1), (xr, yr), (gi, gl))
    err_d = max(_within("warp_images_border_l1 dsx", got[0], want[0]),
                _within("warp_images_border_l1 dsy", got[1], want[1]))
    log(f"[l1-kernel] exact ties (|w - t| = 0) in rows 100-103 of all {k} "
        f"maps: l1 exactly 0; {int((want_l1 == 0).sum())} zero L1 values "
        "in all")

    def two_step(sx=gx, sy=gy):
        out = IW.warp_images_border(img, sx, sy)
        return out, torch.mean(torch.abs(out - tgt[:, None]), dim=-1)

    iw = IW.kernel_library()
    out = torch.empty((b, k, hh, xx, c), device=dev)
    l1 = torch.empty_like(gx)
    dsx, dsy = torch.empty_like(gx), torch.empty_like(gy)
    ms = device_ms(_bare(iw.warp_images_border_l1_fwd, img, tgt, gx, gy, out,
                         l1, b, hh, xx, k, c,
                         IW.aligned(tgt, gx, gy, out, l1)))
    ms_bwd = device_ms(_bare(iw.warp_images_border_l1_bwd, img, tgt, gx, gy,
                             gi, gl, dsx, dsy, b, hh, xx, k, c,
                             IW.aligned(tgt, gx, gy, gi, gl, dsx, dsy)))
    call = cuda_ms(lambda: IW.warp_images_border(img, x, y, target=tgt))
    call_bwd = cuda_ms(_grad_fn(IW.warp_images_border(img, x, y, target=tgt),
                                (x, y), (gi, gl)))
    plain = plain_ms(lambda: IW.warp_images_border_l1_reference(img, gx, gy,
                                                                tgt))
    plain_bwd = plain_ms(_grad_fn(IW.warp_images_border_l1_reference(
        img, x, y, tgt), (x, y), (gi, gl)))
    xs, ys = gx.clone().requires_grad_(), gy.clone().requires_grad_()
    two = device_ms(two_step)
    two_bwd = device_ms(_grad_fn(two_step(xs, ys), (xs, ys), (gi, gl)))
    log(f"[l1-kernel] warp_images_border_l1 float32 at B={b}, K={k}, "
        f"{hh}x{xx}, device ms: forward kernel {ms:.4f}, plain {plain:.4f}, "
        f"two-step (row-4 kernel + torch L1) {two:.4f}; backward kernel "
        f"{ms_bwd:.4f}, plain {plain_bwd:.4f}, two-step {two_bwd:.4f}; one "
        f"wrapper call {call:.4f} forward, {call_bwd:.4f} backward")
    return [
        _record("warp_images_border_l1", "image_warp.cu",
                "movedepth_tpu/ops/pallas/image_warp.py:499",
                max(err_w, err_l1), ms, plain,
                image_warp_work(b, k, hh, xx, c, l1=True), None, call),
        _record("warp_images_border_l1_coord_bwd", "image_warp.cu",
                "movedepth_tpu/ops/pallas/image_warp.py:523", err_d, ms_bwd,
                plain_bwd,
                image_warp_work(b, k, hh, xx, c, backward=True, l1=True),
                None, call_bwd),
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
    from movedepth_tpu_torch.ops import kernel_launches
    return kernel_launches()


def _zero_launch_counts():
    """Every counter of the tracer back to 0 (the launches among them)."""
    from movedepth_tpu_torch import trace
    trace.reset()


def _corr_launches():
    """The cost-volume kernel's launches the tracer has counted."""
    from movedepth_tpu_torch import trace
    return trace.counter("launch.sweep_warp_corr")


def _f32_step(cfg, step_models, step_batch, step_draws):
    """One float32 train_step from fresh optimizer state; (losses, s)."""
    from movedepth_tpu_torch.train import state as S
    opt, sched = S.create_optimizer(step_models, cfg)
    t0 = time.perf_counter()
    out, _ = S.train_step(step_models, opt, sched, step_batch, cfg, False,
                          step_draws)
    return out, time.perf_counter() - t0


def _card_vs_cpu(tag, got, want, models, cpu_models, spreads, threads):
    """The gates of a float32 card step against the same step on the CPU:
    every loss within 1e-3 relative; every model's gradient within 5e-3 or
    twice the spread the CPU's own gradient shows between 1 thread and all
    of them, whichever is larger (a float32 gradient of this step is fixed
    only up to the order of its sums)."""
    failed = []
    for key, value in want.items():
        rel = abs(got[key].item() - value.item()) / abs(value.item())
        log(f"[{tag}] float32 card vs CPU {key}: card {got[key].item():.6f}, "
            f"CPU {value.item():.6f}, rel {rel:.3e}")
        if not rel <= 1e-3:
            failed.append(f"{key} rel {rel:.3e} > 1e-3")
    for name, gap in _grad_rel(models, cpu_models).items():
        bound_ = max(5e-3, 2.0 * spreads[name])
        log(f"[{tag}] float32 gradient of {name}: card vs CPU relative L2 "
            f"{gap:.3e}; CPU 1 thread vs {threads} {spreads[name]:.3e}; "
            f"bound {bound_:.3e}")
        if not gap <= bound_:
            failed.append(f"{name} gradient {gap:.3e} > {bound_:.3e}")
    if failed:
        raise RuntimeError(f"{tag} card vs CPU gates failed: "
                           + "; ".join(failed))
    log(f"[{tag}] float32 gates pass: every loss within 1e-3 relative, "
        "every gradient within max(5e-3, 2 x the CPU's own thread-count "
        "spread)")


def phase_train_path():
    """The train path: train_step of the shipped Config(compute_dtype=
    "float32") models (ResNet18, 640x192, 16 bins, convex upsampling) at
    batch 2 on the card against the same step on the CPU, then one step in
    the shipped bfloat16 config. Returns (the launches of the card's float32
    step, the CPU models after their step, what phase 8b reuses)."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.train import state as S

    cfg32 = Config(compute_dtype="float32")
    cpu_models = build_models(cfg32, "cpu", torch.Generator().manual_seed(0))
    _boost_pose_head(cpu_models)
    init = {k: copy.deepcopy(m) for k, m in cpu_models.items()}
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    bf16_models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    one_thread = {k: copy.deepcopy(m) for k, m in cpu_models.items()}
    batch = P.synthetic_batch(cfg32, 2, seed=0, device="cpu")
    draws = P.sample_draws(cfg32, 2, torch.Generator().manual_seed(0),
                           device="cpu")

    want, seconds = _f32_step(cfg32, cpu_models, batch, draws)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, seconds1 = _f32_step(cfg32, one_thread, batch, draws)
    finally:
        torch.set_num_threads(threads)
    log(f"[train] CPU float32 train_step at batch 2, 640x192: {seconds:.1f} s "
        f"on {threads} threads, {seconds1:.1f} s on 1")

    gpu_batch = P.as_batch(batch, "cuda")
    gpu_draws = {"box": draws["box"],
                 "noise": [n.cuda() for n in draws["noise"]]}
    _zero_launch_counts()
    got, _ = _f32_step(cfg32, models, gpu_batch, gpu_draws)
    torch.cuda.synchronize()
    launches = _launch_counts()
    log(f"[train] kernel launches of one card train_step: {launches}")
    if list(launches.values()) != [1, 1, 2, 2, 0, 0]:
        raise RuntimeError("expected sweep_warp 1 forward + 1 backward and "
                           "warp_images_border 2 forward + 2 backward")
    spreads = _grad_rel(one_thread, cpu_models)
    _card_vs_cpu("train", got, want, models, cpu_models, spreads, threads)

    cfg16 = Config()  # bfloat16 autocast, the shipped config
    opt, sched = S.create_optimizer(bf16_models, cfg16)
    got16, _ = S.train_step(bf16_models, opt, sched, gpu_batch, cfg16, True,
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
    return launches, cpu_models, (init, batch, draws, spreads, threads, got)


def phase_train_path_l1(init, batch, draws, spreads, threads, got_off):
    """Phase 8 with kernel_l1 on: the float32 card step (through the L1
    epilogue kernel) against the same step on the CPU (through its plain
    version) under phase 8's gates, its kernel launches, and its losses
    against phase 8's card step with kernel_l1 off (same weights, batch and
    draws) within 1e-5 relative."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P

    cfg = Config(compute_dtype="float32", kernel_l1=True)
    cpu_models = {k: copy.deepcopy(m) for k, m in init.items()}
    models = {k: copy.deepcopy(m).cuda() for k, m in init.items()}
    want, seconds = _f32_step(cfg, cpu_models, batch, draws)
    log(f"[train-l1] CPU float32 train_step with kernel_l1: {seconds:.1f} s")
    gpu_draws = {"box": draws["box"],
                 "noise": [n.cuda() for n in draws["noise"]]}
    _zero_launch_counts()
    got, _ = _f32_step(cfg, models, P.as_batch(batch, "cuda"), gpu_draws)
    torch.cuda.synchronize()
    launches = _launch_counts()
    log(f"[train-l1] kernel launches of one card train_step with kernel_l1: "
        f"{launches}")
    if list(launches.values()) != [1, 1, 0, 0, 2, 2]:
        raise RuntimeError("expected sweep_warp 1 + 1, warp_images_border "
                           "0 + 0 and warp_images_border_l1 2 forward + 2 "
                           "backward")
    _card_vs_cpu("train-l1", got, want, models, cpu_models, spreads, threads)
    worst = max(abs(got[k].item() - got_off[k].item()) / abs(got_off[k].item())
                for k in got_off)
    log(f"[train-l1] kernel_l1 on vs off on the card: every loss within "
        f"{worst:.3e} relative (must be <= 1e-5)")
    if not worst <= 1e-5:
        raise RuntimeError("kernel_l1 on and off give different losses")


def phase_train_throughput(cpu_models, card):
    """train_step in bfloat16 autocast at batch 12, 640x192 (the shipped
    config): 3 warmup steps, then the median of 10, CUDA events; with the
    kernels and with the plain versions swapped in for the two kernel
    Functions, in turns (kernels, plain, kernels, plain), then with
    kernel_l1 on (phase 9b). Returns the kernel_l1 ms/step."""
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

    def run(label, step_cfg):
        models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
        opt, sched = S.create_optimizer(models, step_cfg)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: S.train_step(models, opt, sched, batch,
                                          step_cfg, True, draws),
                     runs=10, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train-throughput] {label}: train_step bfloat16 batch {bsz}, "
            f"640x192: {ms:.3f} ms/step (median of 10), "
            f"{bsz / ms * 1e3:.2f} examples/s, peak {peak:.2f} GiB; {card}")
        return ms

    def plain_warp(src, sx, sy, target=None):
        assert target is None  # kernel_l1 is off in this run
        return IW.warp_images_border_reference(src, sx, sy)

    kernels = (P.sweep_warp, P.warp_images_border)
    times = {"kernels": [], "plain versions": []}
    for label in ("kernels", "plain versions") * 2:
        if label != "kernels":
            P.sweep_warp = SW.sweep_warp_reference
            P.warp_images_border = plain_warp
        try:
            times[label].append(run(label, cfg))
        finally:
            P.sweep_warp, P.warp_images_border = kernels
    l1 = run("kernels, kernel_l1", cfg.replace(kernel_l1=True))
    log(f"[train-throughput] in turns: kernels {times['kernels']} ms/step, "
        f"plain versions {times['plain versions']} ms/step; with kernel_l1 "
        f"{l1:.3f} ms/step")
    return l1


DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


def _write_frames(root, frames):
    """``frames`` synthetic 1242x375 JPEGs of drive DRIVE: one smooth
    random texture panned 8 pixels a frame (a camera moving sideways)."""
    import numpy as np
    from PIL import Image
    img_dir = os.path.join(root, DRIVE, "image_02", "data")
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    small = rng.uniform(0, 255, (24, 100, 3)).astype(np.uint8)
    pan = Image.fromarray(small).resize((1242 + 8 * frames, 375),
                                        Image.BICUBIC)
    for i in range(frames):
        pan.crop((8 * i, 0, 8 * i + 1242, 375)).save(
            os.path.join(img_dir, f"{i:010d}.jpg"), quality=90)


def _write_kitti_tree(root, frames=30):
    """A KITTI-raw layout of ``frames`` synthetic 1242x375 JPEGs
    (``_write_frames``), 26 train lines (frames 1-26) and 2 val lines (27,
    28)."""
    _write_frames(root, frames)
    splits = os.path.join(root, "splits", "smoke")
    os.makedirs(splits)
    with open(os.path.join(splits, "train_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in range(1, 27)))
    with open(os.path.join(splits, "val_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in (27, 28)))
    return os.path.join(root, "splits")


# KITTI's published calibration of the 2011_09_26 drives (1242x375)
CALIB_CAM = (
    "S_rect_02: 1.242000e+03 3.750000e+02\n"
    "R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 "
    "9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01\n"
    "P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 "
    "0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 "
    "0.000000e+00 1.000000e+00 2.745884e-03\n")
CALIB_VELO = (
    "R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 "
    "7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02\n"
    "T: -4.069766e-03 -7.631618e-02 -2.717806e-01\n")
EVAL_LINES = 12
EVAL_TIMED_LINES = 120  # the 12 repeated: a timed pass lasts seconds


def _write_eval_tree(root, lines=EVAL_LINES):
    """The KITTI-raw layout the eigen evaluation reads: ``lines`` + 1
    frames (``_write_frames``), the drive's calibration, a velodyne scan
    per frame (20000 points 5-60 m ahead, 20 m either side, from the road
    to 1.5 m up: a sparse fill of the eigen crop) and an eigen
    ``test_files.txt`` of frames 1..lines. Returns the splits directory."""
    import numpy as np
    _write_frames(root, lines + 1)
    date = os.path.join(root, DRIVE.split("/")[0])
    with open(os.path.join(date, "calib_cam_to_cam.txt"), "w") as f:
        f.write(CALIB_CAM)
    with open(os.path.join(date, "calib_velo_to_cam.txt"), "w") as f:
        f.write(CALIB_VELO)
    velo = os.path.join(root, DRIVE, "velodyne_points", "data")
    os.makedirs(velo)
    rng = np.random.default_rng(1)
    for i in range(lines + 1):
        n = 20000
        pts = np.stack([rng.uniform(5, 60, n), rng.uniform(-20, 20, n),
                        rng.uniform(-1.7, 1.5, n), rng.uniform(0, 1, n)], 1)
        pts.astype(np.float32).tofile(os.path.join(velo, f"{i:010d}.bin"))
    splits = os.path.join(root, "splits")
    os.makedirs(os.path.join(splits, "eigen"))
    with open(os.path.join(splits, "eigen", "test_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in range(1, lines + 1)))
    return splits


def _train_cli(args, timeout, torchrun=False):
    """Run ``python -m movedepth_tpu_torch.cli.train`` with ``args`` from
    the checkout (``torchrun``: under ``torch.distributed.run --standalone
    --nproc_per_node 1``); returns (its output lines, {epoch: (steps, wall
    ms/step, wall ms/step after the first step or None)}, its kernel
    launches)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    launcher = (["-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1"] if torchrun else [])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, *launcher, "-m", "movedepth_tpu_torch.cli.train",
         *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"[cli]   {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"the train CLI exited {proc.returncode}:\n"
                           + proc.stderr[-4000:])
    log(f"[cli] exit 0 after {time.perf_counter() - t0:.1f} s")
    return _cli_results(lines)


def _train_cli_here(args):
    """The train CLI's entry point (``cli.train.main``) in this process,
    with every launch count set to 0 first: no process start, and the
    kernels and cuDNN's autotuning of earlier runs stay. Returns what
    ``_train_cli`` returns."""
    import contextlib
    import gc
    import io
    import torch
    from movedepth_tpu_torch.cli import train as cli_train
    _zero_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_train.main(args)
    gc.collect()  # the trainer's models and graphs
    torch.cuda.empty_cache()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[cli]   {line}")
    log(f"[cli] cli.train.main returned after "
        f"{time.perf_counter() - t0:.1f} s")
    return _cli_results(lines)


def _cli_results(lines):
    """(lines, {epoch: (steps, wall ms/step, wall ms/step after the first
    step or None)}, kernel launches) of a train CLI's output."""
    epochs = {int(m.group(1)): (int(m.group(2)), float(m.group(3)),
                                float(m.group(4)) if m.group(4) else None)
              for m in (re.match(r"epoch (\d+): (\d+) steps, ([\d.]+) "
                                 r"ms/step wall(?:, ([\d.]+) after the "
                                 r"first)?", ln) for ln in lines) if m}
    losses = [float(m.group(1)) for m in
              (re.search(r"\| loss: (\S+) \|", ln) for ln in lines) if m]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"logged losses not finite: {losses}")
    launches = [json.loads(ln.split(": ", 1)[1]) for ln in lines
                if ln.startswith("kernel launches: ")]
    if len(launches) != 1:
        raise RuntimeError("the train CLI printed no kernel launches")
    return lines, epochs, launches[0]


def _check_folders(models_dir, names, want_models):
    import torch
    for name in names:
        files = set(os.listdir(os.path.join(models_dir, name)))
        want = {f"{m}.pth" for m in want_models} | {"adam.pth"}
        if files != want:
            raise RuntimeError(f"{name}: {sorted(files)} != {sorted(want)}")
    return torch.load(os.path.join(models_dir, "last", "adam.pth"),
                      map_location="cpu", weights_only=True)["step"]


def phase_train_cli(l1_ms, card):
    """The train CLI as a user runs it, at the shipped width (640x192,
    batch 12, bfloat16) with --kernel_l1 and the default native loader, 2
    epochs of 2 steps with validation at every step and checkpoints, then
    a resume from ``last`` for a third epoch. Returns (the first run's
    kernel launches, its {epoch: wall ms/step after the first step})."""
    from movedepth_tpu_torch.config import ALL_MODELS

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "kitti")
        splits = _write_kitti_tree(data)
        log_dir = os.path.join(tmp, "log")
        common = ["--data_path", data, "--log_dir", log_dir, "--model_name",
                  "smoke", "--split", "smoke", "--splits_dir", splits,
                  "--kernel_l1", "--weights_init", "scratch",
                  "--log_frequency", "1", "--num_workers", "8"]
        lines, epochs, launches = _train_cli(common + ["--num_epochs", "2"],
                                             480)
        if not any(ln.startswith("data: native loader, route ")
                   for ln in lines):
            raise RuntimeError("the train CLI did not train with the native "
                               "loader, its default")
        models_dir = os.path.join(log_dir, "smoke", "models")
        if {e: n for e, (n, _, _) in epochs.items()} != {0: 2, 1: 2}:
            raise RuntimeError(f"expected 2 epochs of 2 steps: {epochs}")
        if not os.path.isfile(os.path.join(models_dir, "opt.json")):
            raise RuntimeError("no opt.json")
        step = _check_folders(models_dir, ("weights_0", "weights_1", "last"),
                              ALL_MODELS)
        want = {"sweep_warp": 8, "sweep_warp_bwd": 4,
                "warp_images_border": 0, "warp_images_border_coord_bwd": 0,
                "warp_images_border_l1": 16,
                "warp_images_border_l1_coord_bwd": 8}
        log(f"[cli] 2 epochs: step {step}; kernel launches {launches} "
            "(4 train steps and 4 validations)")
        if step != 4 or launches != want:
            raise RuntimeError(f"expected step 4 and launches {want}")

        last = os.path.join(models_dir, "last")
        _, epochs2, launches2 = _train_cli(
            common + ["--num_epochs", "3", "--load_weights_folder", last,
                      "--steps_per_dispatch", "2"], 360)
        step2 = _check_folders(models_dir, ("weights_2", "last"),
                               ALL_MODELS)
        log(f"[cli] resume from last with --steps_per_dispatch 2: step "
            f"{step} -> {step2}, epochs {sorted(epochs2)}; kernel launches "
            f"{launches2}")
        if step2 != 6 or sorted(epochs2) != [2] or epochs2[2][0] != 2:
            raise RuntimeError("the resume did not train epoch 2 from step 4")
        if not all(launches2[r] for r in GRAPHED_ROWS):
            raise RuntimeError(f"the graphed resume launched no kernel of "
                               f"rows 2, 3 and 4b: {launches2}")
    walls = {e: ms for e, (_, ms, _) in
             sorted({**epochs, **epochs2}.items())}
    log(f"[cli] trainer wall ms/step by epoch {walls} (epoch 2: one "
        f"graphed dispatch of 2 steps, its warm-up and capture included) "
        f"against train_step with kernel_l1 {l1_ms:.3f} ms/step (phase 9b); "
        f"{card}")
    return launches, {e: warm for e, (_, _, warm) in epochs.items()}


LOADER_LINES = 240  # phase 10a's train lines: 20 batches of 12
CLI_STEPS = 10  # phase 10b's epoch


def _write_loader_tree(root):
    """Phase 10a's and 10b's KITTI-raw tree: LOADER_LINES + 2 synthetic
    1242x375 JPEGs (``_write_frames``); split ``loader`` of CLI_STEPS
    batches of train lines (1..120) and one batch of val lines. Returns
    the splits directory."""
    _write_frames(root, LOADER_LINES + 2)
    splits = os.path.join(root, "splits")
    os.makedirs(os.path.join(splits, "loader"))
    n = CLI_STEPS * 12
    with open(os.path.join(splits, "loader", "train_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in range(1, n + 1)))
    with open(os.path.join(splits, "loader", "val_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in range(n + 1, n + 13)))
    return splits


def phase_loader(root, card, rt=False, passes=2):
    """Phase 10a: the train loader on this host. ``Loader.epoch`` over the
    train dataset of LOADER_LINES lines at the shipped batch 12, 640x192,
    frame_ids (0, -1, 1), flips and jitter (with ``rt``, phase 15d, also
    robust_train's random frame offsets), ``cfg.num_workers`` threads:
    the PIL path and the C++ loader in turns, two passes each; then the
    native samples against the PIL samples of the same indices under the
    JAX package's bounds (colour max < 0.06; jittered colour max < 0.08,
    mean < 0.01), each sample's two reads timed one after the other from
    this thread; every native read made by the C++ loader. ``passes``
    passes a path. Returns {path: [samples/s of each pass]}."""
    import numpy as np
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch.data.kitti import KITTIRawDataset
    from movedepth_tpu_torch.data.loader import Loader

    cfg = Config()
    tag = "[loader-rt]" if rt else "[loader]"
    files = [f"{DRIVE} {i} l" for i in range(1, LOADER_LINES + 1)]
    sets = {label: KITTIRawDataset(root, files, cfg.height, cfg.width,
                                   cfg.frame_ids, is_train=True,
                                   seed=cfg.seed, native=native, rt=rt)
            for label, native in (("PIL", False), ("native", True))}
    log(f"{tag} {sets['native'].native.describe()}; os.cpu_count() "
        f"{os.cpu_count()}, sched_getaffinity {len(os.sched_getaffinity(0))}"
        f"; {cfg.num_workers} loader threads; {card}")
    rates = {label: [] for label in sets}
    for label in ("PIL", "native") * passes:
        loader = Loader(sets[label], cfg.batch_size,
                        num_workers=cfg.num_workers, seed=cfg.seed)
        t0 = time.perf_counter()
        n = batches = 0
        for batch in loader.epoch(0):
            n += batch["color"].shape[0]
            batches += 1
        dt = time.perf_counter() - t0
        if batches != LOADER_LINES // cfg.batch_size:
            raise RuntimeError(f"{label}: {batches} batches")
        rates[label].append(n / dt)
        log(f"{tag} {label}: {n} samples in {batches} batches, {dt:.3f} "
            f"s: {n / dt:.2f} samples/s, {dt * 1e3 / batches:.1f} ms/batch")
    spread = {k: (max(v) - min(v)) / min(v) for k, v in rates.items()}
    log(f"{tag} samples/s PIL {rates['PIL']}, native {rates['native']}; "
        f"native / PIL {np.mean(rates['native']) / np.mean(rates['PIL']):.3f}"
        f"; pass-to-pass spread PIL {spread['PIL']:.1%}, native "
        f"{spread['native']:.1%}")

    colour, jit_max, jit_mean, jittered = 0.0, 0.0, 0.0, 0
    serial = {label: 0.0 for label in sets}
    for i in range(0, LOADER_LINES, 10):
        t0 = time.perf_counter()
        a = sets["native"][i]
        t1 = time.perf_counter()
        b = sets["PIL"][i]
        serial["native"] += t1 - t0
        serial["PIL"] += time.perf_counter() - t1
        colour = max(colour, float(np.abs(a["color"] - b["color"]).max()))
        if not np.array_equal(a["color"], a["color_aug"]):
            jittered += 1
            diff = np.abs(a["color_aug"] - b["color_aug"])
            jit_max = max(jit_max, float(diff.max()))
            jit_mean = max(jit_mean, float(diff.mean()))
    n = LOADER_LINES // 10
    log(f"{tag} one sample at a time from this thread (the C++ loader "
        f"spreads a sample over 3 threads of its own), {n} samples: PIL "
        f"{serial['PIL'] * 1e3 / n:.1f} ms/sample, native "
        f"{serial['native'] * 1e3 / n:.1f} ms/sample")
    log(f"{tag} native against PIL on {n} samples: "
        f"colour max {colour:.4f} (< 0.06); {jittered} jittered: max "
        f"{jit_max:.4f} (< 0.08), worst mean {jit_mean:.5f} (< 0.01)")
    if not jittered or colour >= 0.06 or jit_max >= 0.08 or jit_mean >= 0.01:
        raise RuntimeError("the native samples disagree with the PIL ones")
    made = sets["native"].native_items
    log(f"{tag} the C++ loader made {made} samples")
    if made != passes * LOADER_LINES + n:
        raise RuntimeError(f"{tag} {made} native samples, expected "
                           f"{passes * LOADER_LINES + n}: some took the PIL "
                           "path")
    return rates


def phase_loader_cli(root, splits, l1_ms, card):
    """Phase 10b: the train CLI's entry point in this process (phase 10
    runs it as a process of its own) for one epoch of CLI_STEPS steps at
    batch 12, 640x192, bfloat16, --kernel_l1, validation at its default
    cadence (the first step of an epoch), with --no-native_loader and with
    the default native loader; wall ms/step of the epoch (whole, and after
    its first step) against phase 9b's train_step. cuDNN has tuned these
    shapes in earlier phases, so the first step does not give the loader
    seconds to queue batches, as a new process's first step does."""
    walls = {}
    for label, extra in (("PIL", ["--no-native_loader"]), ("native", [])):
        log_dir = os.path.join(root, f"log_{label}")
        lines, epochs, launches = _train_cli_here(
            ["--data_path", root, "--log_dir", log_dir, "--model_name",
             "loader", "--split", "loader", "--splits_dir", splits,
             "--kernel_l1", "--weights_init", "scratch", "--num_epochs",
             "1", *extra])
        want = ("data: PIL loader" if label == "PIL"
                else "data: native loader, route ")
        if not any(ln.startswith(want) for ln in lines):
            raise RuntimeError(f"{label}: the CLI did not say {want!r}")
        if {e: n for e, (n, _, _) in epochs.items()} != {0: CLI_STEPS}:
            raise RuntimeError(f"{label}: expected one epoch of "
                               f"{CLI_STEPS} steps: {epochs}")
        if not launches.get("warp_images_border_l1"):
            raise RuntimeError(f"{label}: no L1 kernel launches {launches}")
        walls[label] = {e: v[1:] for e, v in epochs.items()}
    log(f"[cli-loader] epochs of {CLI_STEPS} steps, wall ms/step by epoch "
        f"(whole epoch, after its first step): PIL {walls['PIL']}, native "
        f"{walls['native']}; train_step with kernel_l1 {l1_ms:.3f} ms/step "
        f"(phase 9b); {card}")


def phase_variants():
    """The stage ablations of the sweep kernel (kernel 6) at the shipped
    inference shape, batch 128 bfloat16: each variant's ms, the public
    wrapper against the bare launch; ``full`` must equal the shipped
    kernel bit for bit and its plain version within one bf16 ulp of the
    float32 result (plus 1e-5 of the range). Returns its record."""
    import torch
    from movedepth_tpu_torch import profile_kernel_variants as PKV
    from movedepth_tpu_torch import trace
    from movedepth_tpu_torch.ops import sweep_warp as SW

    inputs = PKV.shipped_inputs(128)
    before = trace.counter("launch.sweep_warp_corr_variant")
    times = PKV.time_variants(inputs)
    ab = PKV.wrapper_ab(inputs)
    torch.cuda.synchronize()
    launches = trace.counter("launch.sweep_warp_corr_variant") - before
    log("[variants] batch 128, bfloat16: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items())
        + f" (device, bare launches); one public sweep_warp_corr call "
        f"{ab['wrapper']:.4f} ms vs bare full launch {ab['bare']:.4f} ms "
        f"(device); {launches} variant launches")
    if launches == 0:
        raise RuntimeError("no kernel variant was launched")

    full = PKV.run_variant("full", *inputs)
    shipped = SW.sweep_warp_corr(*inputs, 16)
    torch.cuda.synchronize()
    if not torch.equal(full, shipped):
        raise RuntimeError("the full variant differs from sweep_warp_corr")
    src, ref, sx, sy = inputs
    want32 = SW.sweep_warp_corr_reference(src.float(), ref.float(), sx, sy, 16)
    err = (full.float() - want32).abs()
    excess = (err - _bf16_ulp(want32) - 1e-5 * want32.abs().max()).max()
    log(f"[variants] full == sweep_warp_corr bit for bit; against the plain "
        f"version max|diff| {err.max().item():.3e}, excess over one bf16 "
        f"ulp {excess.item():.3e} (must be <= 0)")
    if excess.item() > 0:
        raise RuntimeError("the full variant disagrees with the plain version")
    err_max = err.max().item()
    del want32, err
    plain = device_ms(lambda: SW.sweep_warp_corr_reference(src, ref, sx, sy,
                                                           16),
                      launches=3, warmup=1)
    call = cuda_ms(lambda: PKV.run_variant("full", *inputs))
    s = PKV.SHIPPED
    rec = _record("sweep_warp_corr_variants", "sweep_warp_corr_variants.cu",
                  "scripts/profile_kernel_variants.py:81", err_max,
                  times["full"], plain,
                  sweep_corr_work(128, s["R"], s["W"], s["C"], s["D"], s["R"],
                                  s["G"], 2), None, call)
    rec["launches"] = launches
    return rec


# ------------------------------------------------------------------ phase 12

DDP_WORLD = 2  # phase 12b's ranks, sharing the one card over gloo
DDP_ROWS = 2  # each 12b rank's rows; the one-process step takes 4
DDP_TIMEOUT = 300  # seconds a 12b rank may take
LOOSE = ("loss/", "mono_loss", "loss")  # the losses gated at 1e-3


def phase_ddp_cli(warm10, card):
    """Phase 12a: the train CLI as a user starts it on one card under
    torchrun (nccl, world 1), at the shipped width (640x192, ResNet18, 16
    bins, bfloat16, batch 12) with --kernel_l1, on phase 10's tree, one
    epoch of 2 steps with validation at every step. Returns its kernel
    launches."""
    from movedepth_tpu_torch.config import ALL_MODELS

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "kitti")
        splits = _write_kitti_tree(data)
        log_dir = os.path.join(tmp, "log")
        lines, epochs, launches = _train_cli(
            ["--data_path", data, "--log_dir", log_dir, "--model_name",
             "ddp", "--split", "smoke", "--splits_dir", splits,
             "--kernel_l1", "--weights_init", "scratch", "--log_frequency",
             "1", "--num_workers", "8", "--num_epochs", "1"], 480,
            torchrun=True)
        said = [ln for ln in lines if ln.startswith("dist: ")]
        if said != ["dist: backend nccl, rank 0 of 1, device cuda:0"]:
            raise RuntimeError(f"12a: expected one nccl rank 0 of 1: {said}")
        models_dir = os.path.join(log_dir, "ddp", "models")
        found = sorted(os.listdir(models_dir))
        if found != ["last", "opt.json", "weights_0"]:
            raise RuntimeError(f"12a: checkpoints {found}")
        step = _check_folders(models_dir, ("weights_0", "last"), ALL_MODELS)
    rows = ("sweep_warp", "sweep_warp_bwd", "warp_images_border_l1",
            "warp_images_border_l1_coord_bwd")
    log(f"[ddp-cli] torchrun, 1 process: {said[0]}; epochs {epochs}; step "
        f"{step}; kernel launches {launches}")
    if step != 2 or {e: n for e, (n, _, _) in epochs.items()} != {0: 2}:
        raise RuntimeError("12a: expected one epoch of 2 steps")
    if not all(launches[k] for k in rows):
        raise RuntimeError(f"12a: rows 2, 3 and 4b must launch: {launches}")
    log(f"[ddp-cli] wall ms/step after the first step: torchrun (nccl, "
        f"SyncBatchNorm, gradient all-reduce) {epochs[0][2]:.1f}, phase 10 "
        f"(one process, no group) {warm10[0]:.1f} in epoch 0 and "
        f"{warm10[1]:.1f} in epoch 1; {card}")
    return launches


def _ddp_rank(rank, workdir):
    """A rank of phase 12b (a child process): one float32 train_step of
    DDP_ROWS rows of the spec's batch with synchronized BatchNorm, global
    masked means and the gradient all-reduce over gloo on the shared card;
    then one more step and one gradient all-reduce, each timed alone."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.parallel import dist as D
    from movedepth_tpu_torch.parallel.sync_bn import convert_sync_batchnorm
    from movedepth_tpu_torch.train import state as S

    phase_device()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DDP_WORLD),
                      LOCAL_RANK="0")
    D.initialize_distributed(
        "cuda", backend="gloo",
        init_method=f"file://{os.path.join(workdir, 'rendezvous')}")
    group = D.default_group()
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    cfg = Config(compute_dtype="float32")
    models = build_models(cfg, "cuda")
    for name, m in models.items():
        m.load_state_dict(spec["states"][name])
    convert_sync_batchnorm(models, group)
    D.broadcast_models(models, group)
    rows = slice(rank * DDP_ROWS, (rank + 1) * DDP_ROWS)
    batch = P.as_batch({k: v[rows] for k, v in spec["batch"].items()},
                       "cuda")
    draws = P.sample_draws(cfg, DDP_ROWS, torch.Generator("cuda").manual_seed(
        spec["seed"]), "cuda", rank, DDP_WORLD)
    opt, sched = S.create_optimizer(models, cfg)
    _zero_launch_counts()
    losses, _ = S.train_step(models, opt, sched, batch, cfg, False, draws,
                             group)
    torch.cuda.synchronize()
    out = {"launches": _launch_counts(),
           "losses": {k: v.item() for k, v in losses.items()},
           "state": {n: {k: v.to("cpu", copy=True)
                         for k, v in m.state_dict().items()}
                     for n, m in models.items()}}
    if rank == 0:
        out["grads"] = {n: {k: p.grad.to("cpu", copy=True) for k, p in
                            m.named_parameters()} for n, m in models.items()}
    t0 = time.perf_counter()
    S.train_step(models, opt, sched, batch, cfg, False, draws, group)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    D.all_reduce_grads(models, group)
    torch.cuda.synchronize()
    out.update(step_ms=[(t1 - t0) * 1e3],
               reduce_ms=[(time.perf_counter() - t1) * 1e3])
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    D.barrier(group)
    torch.distributed.destroy_process_group()


def _run_ranks(workdir):
    """Start the DDP_WORLD ranks of phase 12b and wait for them; a rank
    that exits non-zero or outlives DDP_TIMEOUT fails the phase with every
    rank's stderr."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
         workdir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(DDP_WORLD)]
    deadline = time.monotonic() + DDP_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1] for p in procs]
        raise RuntimeError(f"12b: a rank outlived {DDP_TIMEOUT} s:\n"
                           + "\n".join(e[-3000:] for e in errs))
    for r, (p, (stdout, err)) in enumerate(zip(procs, outs)):
        for line in stdout.splitlines():
            log(f"[ddp-ranks]   rank {r}: {line}")
        if p.returncode != 0:
            raise RuntimeError(f"12b: rank {r} exited {p.returncode}:\n"
                               + err[-6000:])


def _delta_rule(got, want):
    """tests/test_sharding.py's per-leaf rule for two Adam updates of one
    parameter: at most max(8, 2%) of the elements off by more than 2e-5 +
    5% of the reference, and a relative L2 distance of at most max(0.2,
    6/sqrt(size)). Returns (ok, elements off, size, relative L2)."""
    got, want = got.double(), want.double()
    bad = int(((got - want).abs() > 2e-5 + 0.05 * want.abs()).sum())
    rel = float((got - want).norm() / (want.norm() + 1e-12))
    size = want.numel()
    return (bad <= max(8, int(0.02 * size))
            and rel <= max(0.2, 6.0 / math.sqrt(size)), bad, size, rel)


def phase_ddp_ranks(card):
    """Phase 12b: two ranks on the one card (gloo; NCCL refuses two ranks
    on one device), float32 at 640x192 with the shipped models, DDP_ROWS
    rows a rank, one train_step against one process's card step at the
    global batch from the same seeded weights, batch and draws. Returns
    {kernel: [launches of rank 0, of rank 1]}."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.train import state as S

    cfg = Config(compute_dtype="float32")
    models = build_models(cfg, "cpu", torch.Generator().manual_seed(0))
    _boost_pose_head(models)
    states = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in models.items()}
    batch = P.synthetic_batch(cfg, DDP_WORLD * DDP_ROWS, seed=0,
                              device="cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"states": states, "seed": 0,
                    "batch": {k: v.numpy() for k, v in batch.items()}},
                   os.path.join(tmp, "spec.pt"))
        _run_ranks(tmp)
        ranks = [torch.load(os.path.join(tmp, f"out{r}.pt"),
                            weights_only=False) for r in range(DDP_WORLD)]
    log(f"[ddp-ranks] {DDP_WORLD} ranks over gloo on one card: "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")

    ref = {k: m.cuda() for k, m in models.items()}
    opt, sched = S.create_optimizer(ref, cfg)
    draws = P.sample_draws(cfg, DDP_WORLD * DDP_ROWS,
                           torch.Generator("cuda").manual_seed(0), "cuda")
    want, _ = S.train_step(ref, opt, sched, P.as_batch(batch, "cuda"), cfg,
                           False, draws)
    torch.cuda.synchronize()

    failed = []
    worst_loss = (0.0, None)
    for key, value in want.items():
        got = sum(r["losses"][key] for r in ranks) / DDP_WORLD
        rtol = 1e-3 if key.startswith(LOOSE) else 2e-4
        err = abs(got - value.item())
        rel = err / abs(value.item())
        worst_loss = max(worst_loss, (rel, key), key=lambda t: t[0])
        if not err <= 2e-6 + rtol * abs(value.item()):
            failed.append(f"{key}: ranks {got:.6f}, one process "
                          f"{value.item():.6f}")
    same = max(float((a - ranks[1]["state"][n][k]).abs().max())
               if a.is_floating_point() else
               float((a != ranks[1]["state"][n][k]).sum())
               for n, sd in ranks[0]["state"].items() for k, a in sd.items())
    if same != 0:
        failed.append(f"the ranks' parameters differ by up to {same}")
    worst = (0.0, None)
    off = []
    for name, m in ref.items():
        for k, p in m.named_parameters():
            ok, bad, size, rel = _delta_rule(
                ranks[0]["state"][name][k] - states[name][k],
                p.detach().cpu() - states[name][k])
            worst = max(worst, (rel, f"{name}.{k} ({bad}/{size} off)"),
                        key=lambda t: t[0])
            if not ok:
                off.append(f"{name}.{k}: {bad}/{size} off, rel {rel:.3f}")
    failed += off
    grads = {name: (sum(float((ranks[0]["grads"][name][k] - p.grad.cpu())
                              .norm() ** 2) for k, p in
                        m.named_parameters())
                    / sum(float(p.grad.norm() ** 2)
                          for p in m.parameters())) ** 0.5
             for name, m in ref.items()}
    launches = {k: [r["launches"][k] for r in ranks]
                for k in ranks[0]["launches"]}
    log(f"[ddp-ranks] float32 batch {DDP_ROWS} x {DDP_WORLD} ranks vs one "
        f"process at batch {DDP_WORLD * DDP_ROWS}: worst loss rel "
        f"{worst_loss[0]:.3e} ({worst_loss[1]}); worst Adam update rel L2 "
        f"{worst[0]:.3e} at {worst[1]}; gradient rel L2 by model "
        + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
        + f"; the ranks' parameters and statistics differ by {same}")
    log(f"[ddp-ranks] kernel launches of the step, rank 0 and 1: {launches}")
    for r, res in enumerate(ranks):
        log(f"[ddp-ranks] rank {r}: train_step "
            + ", ".join(f"{t:.1f}" for t in res["step_ms"])
            + " ms, gradient all-reduce alone "
            + ", ".join(f"{t:.1f}" for t in res["reduce_ms"])
            + f" ms (2 ranks on one card, gloo through the host); {card}")
    rows = ("sweep_warp", "sweep_warp_bwd", "warp_images_border",
            "warp_images_border_coord_bwd")
    if not all(all(launches[k]) for k in rows):
        failed.append(f"rows 2-5 must launch in each rank: {launches}")
    if failed:
        raise RuntimeError("12b gates failed: " + "; ".join(failed))
    log("[ddp-ranks] gates pass: every loss within 2e-4 (1e-3 for loss/*, "
        "mono_loss, loss), every Adam update under the per-leaf rule, the "
        "ranks' parameters identical, rows 2-5 launched in each rank")
    return launches


def phase_ddp_overhead(cpu_models, card):
    """Phase 12c: the data-parallel step at world 1 in this process (an
    nccl group through a file:// rendezvous): the bfloat16 batch-12
    train_step with the group (SyncBatchNorm, global masked means, the
    gradient all-reduce) and without it, in turns (without, with, with,
    without), 10 steps after 3 warmups each, and the gradient all-reduce
    alone."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.parallel import dist as D
    from movedepth_tpu_torch.parallel.sync_bn import (SyncBatchNorm,
                                                      convert_sync_batchnorm)
    from movedepth_tpu_torch.train import state as S

    cfg = Config()
    bsz = cfg.batch_size
    batch = P.synthetic_batch(cfg, bsz, seed=1, device="cuda")
    draws = P.sample_draws(cfg, bsz, torch.Generator("cuda").manual_seed(1),
                           device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        try:
            D.initialize_distributed(
                "cuda", init_method=f"file://{os.path.join(tmp, 'rdzv')}")
            group = D.default_group()
            plain = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
            synced = convert_sync_batchnorm(
                {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()},
                group)
            bns = sum(isinstance(mod, SyncBatchNorm) for m in synced.values()
                      for mod in m.modules())
            times = {"without": [], "with": []}
            for label in ("without", "with", "with", "without"):
                models = synced if label == "with" else plain
                opt, sched = S.create_optimizer(models, cfg)
                g = group if label == "with" else None
                _zero_launch_counts()
                times[label].append(cuda_ms(
                    lambda: S.train_step(models, opt, sched, batch, cfg,
                                         True, draws, g), runs=10, warmup=3))
                launches = _launch_counts()
                if not launches["sweep_warp"]:
                    raise RuntimeError(f"12c: no kernel launched {launches}")
            reduce = cuda_ms(lambda: D.all_reduce_grads(synced, group),
                             runs=10, warmup=3)
            n = sum(p.numel() for m in synced.values()
                    for p in m.parameters())
        finally:
            if D.is_distributed():
                torch.distributed.destroy_process_group()
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
                os.environ.pop(k, None)
    with_ms = sum(times["with"]) / 2
    without_ms = sum(times["without"]) / 2
    log(f"[ddp-overhead] bfloat16 train_step batch {bsz}, 640x192, world 1 "
        f"nccl, in turns: without the group {times['without']} ms, with it "
        f"{times['with']} ms (median of 10 each); the gradient all-reduce "
        f"alone ({n} float32 values, {4 * n / 2 ** 20:.1f} MiB) "
        f"{reduce:.3f} ms, {100 * reduce / with_ms:.1f}% of the step; "
        f"{bns} SyncBatchNorm modules; the step with the group costs "
        f"{with_ms - without_ms:.3f} ms more; {card}")



# ------------------------------------------------------------ phases 13-14

EXPORT_RUNS = ((False, 1), (False, 128), (True, 1))  # (mono, batch)
MULTISTEP_K = 4  # phase 14's steps per dispatch
# rows 2, 3 and 4b: the kernels a replay of the graphed kernel_l1 step runs
GRAPHED_ROWS = ("sweep_warp", "sweep_warp_bwd", "warp_images_border_l1",
                "warp_images_border_l1_coord_bwd")


def phase_export(cpu_models, card):
    """Phase 13: ``cli/export_model.build_export`` of the serving forward
    in the shipped config (bfloat16 autocast, 640x192, ResNet18, 16 bins)
    with phase 5's weights: the MVS forward at batch 1 and 128, the mono
    one at batch 1. Each is exported (timed), saved, loaded and run; its
    outputs against the live forward on the same inputs under phase 4's
    gates (disp_mono, depth_mvs; the worst absolute difference beside);
    row 1's launches per call of the loaded program; the loaded program
    and the live forward timed in turns (live, loaded, loaded, live; CUDA
    events, median of 5 at batch 128, 25 at batch 1). Returns row 1's
    launches per call of the batch-1 MVS program."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch.cli import export_model as EM

    t_phase = time.perf_counter()
    cfg = Config()
    models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
    torch.backends.cudnn.benchmark = True
    with tempfile.TemporaryDirectory() as tmp:
        for mono, bsz in EXPORT_RUNS:
            tag = f"{'mono' if mono else 'MVS'} batch {bsz}"
            t0 = time.perf_counter()
            program = EM.build_export(cfg, models, mono, bsz, "cuda")
            t_export = time.perf_counter() - t0
            path = os.path.join(tmp, "movedepth.pt2")
            t0 = time.perf_counter()
            torch.export.save(program, path)
            loaded = torch.export.load(path).module()
            t_io = time.perf_counter() - t0
            del program
            live = EM.ServingForward(models, cfg, mono)
            inputs = EM.example_inputs(cfg, mono, bsz, "cuda")
            names = EM.OUTPUTS[mono]
            with torch.no_grad():
                before = _corr_launches()
                got = dict(zip(names, loaded(*inputs)))
                torch.cuda.synchronize()
                launched = _corr_launches() - before
                want = dict(zip(names, live(*inputs)))
                failed, worst = [], {}
                for name in names:
                    if not torch.isfinite(got[name]).all():
                        failed.append(f"{name} not finite")
                    worst[name] = float((got[name] - want[name]).abs().max())
                    # the depths take depth_mvs's gates, the disparities
                    # disp_mono's
                    st = _stats(got[name], want[name])
                    gated = "disp_mono" if name.startswith("disp") else (
                        "depth_mvs")
                    failed += [f"{name}.{k} {st[k]:.3e} > {bound}"
                               for (n, k), bound in GATES.items()
                               if n == gated and not st[k] <= bound]
                if failed:
                    raise RuntimeError(f"13 {tag}: exported vs live gates "
                                       "failed: " + "; ".join(failed))
                if launched != (0 if mono else 1):
                    raise RuntimeError(f"13 {tag}: row 1 launched {launched}"
                                       " times in one call")
                if not mono:
                    mvs_launches = launched
                runs = 5 if bsz > 1 else 25
                times = {"live": [], "loaded": []}
                for label in ("live", "loaded", "loaded", "live"):
                    fn = loaded if label == "loaded" else live
                    times[label].append(cuda_ms(lambda: fn(*inputs),
                                                runs=runs, warmup=3))
            log(f"[export] {tag}, bfloat16, 640x192: export "
                f"{t_export:.1f} s, save and load {t_io:.1f} s, "
                f"{os.path.getsize(path) / 1e6:.1f} MB; loaded vs live "
                f"worst |diff| " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in worst.items())
                + f" (gates of phase 4 pass); row 1 launches per call "
                f"{launched}; ms/call in turns: live {times['live']}, "
                f"loaded {times['loaded']} (median of {runs}); {card}")
            del loaded
    log(f"[export] phase 13: {time.perf_counter() - t_phase:.1f} s")
    return mvs_launches


def _multistep_inputs(cfg, k):
    """k synthetic batches at cfg.batch_size on the card and their draws
    from one generator, as a trainer would draw them."""
    import torch
    from movedepth_tpu_torch import pipeline as P
    gen = torch.Generator("cuda").manual_seed(4)
    bsz = cfg.batch_size
    batches = [P.synthetic_batch(cfg, bsz, seed=10 + i, device="cuda")
               for i in range(k)]
    return batches, [P.sample_draws(cfg, bsz, gen, "cuda") for _ in range(k)]


def _multistep_equality(train_models, cfg, batches, draws):
    """Phase 14's equality. (1) From one state, K eager train_steps (twice:
    their spread is the yardstick) against one graphed dispatch of K:
    step 1's losses within 1e-5 relative, its gradients (the first
    dispatch of (2)) per model under phase 8's rule (relative L2 at most
    5e-3 or twice the eager runs' spread), step 2's total loss within the JAX test's loose
    tier (5e-3, or twice the eager spread) and every parameter after K
    steps within rtol 5e-2 / atol 1e-3; steps 3 to K are reported beside
    the eager spread, not gated: the backward's atomics (row 3's float32
    source gradient, cuDNN's bf16 weight gradients) sum in another order
    on every run, and through the automask's discrete choices and Adam's
    first steps (a flipped near-zero gradient moves a weight by 2 * lr) two
    eager runs part by several percent there. (2) Every replay is exact:
    K single-step dispatches in a row, each against one eager step from
    the graphed models' state (parameters, statistics and Adam's state
    copied in), every loss within 1e-5 relative at every step."""
    import torch
    from movedepth_tpu_torch.train import state as S
    k = len(batches)

    def fresh():
        models = {n: copy.deepcopy(m).cuda() for n, m in train_models.items()}
        return (models,) + S.create_optimizer(models, cfg)

    def eager():
        models, opt, sched = fresh()
        losses = []
        for i in range(k):
            losses.append(S.train_step(models, opt, sched, batches[i], cfg,
                                       True, draws[i])[0])
            if i == 0:
                grads = {n: [p.grad.clone() for p in m.parameters()]
                         for n, m in models.items()}
        return models, losses, grads

    def grad_rel(got, want):
        return {n: (sum(float((a - b).norm() ** 2)
                        for a, b in zip(got[n], want[n]))
                    / sum(float(b.norm() ** 2) for b in want[n])) ** 0.5
                for n in want}

    rel = _rel  # a loss of exactly 0 on both sides is equal, not a crash

    models, eager_losses, grads1 = eager()
    _, spread_losses, spread_grads = eager()
    many = fresh()
    got = S.make_train_multistep(*many, cfg)(batches, draws, True)
    failed = []
    worst1 = max((rel(got[key][0], eager_losses[0][key]), key)
                 for key in eager_losses[0])
    if not worst1[0] <= 1e-5:
        failed.append(f"step 1 loss {worst1[1]} off by {worst1[0]:.3e}")
    later = [(rel(got["loss"][i], eager_losses[i]["loss"]),
              rel(spread_losses[i]["loss"], eager_losses[i]["loss"]))
             for i in range(1, k)]
    if not later[0][0] <= max(5e-3, 2 * later[0][1]):
        failed.append(f"step 2 loss off by {later[0][0]:.3e} (eager spread "
                      f"{later[0][1]:.3e})")
    with torch.no_grad():
        excess = max(float(((a - b).abs() - 1e-3 - 5e-2 * b.abs()).max())
                     for n in models for a, b in
                     zip(many[0][n].parameters(), models[n].parameters()))
    if not excess <= 0:
        failed.append(f"parameters after {k} steps off the loose tier by "
                      f"{excess:.3e}")

    graphed, (ref, ref_opt, ref_sched) = fresh(), fresh()
    multi = S.make_train_multistep(*graphed, cfg)
    synced = []
    for i in range(k):
        with torch.no_grad():
            for n, m in graphed[0].items():
                for a, b in zip(ref[n].parameters(), m.parameters()):
                    a.copy_(b)
                    for key, v in graphed[1].state.get(b, {}).items():
                        if a in ref_opt.state:
                            ref_opt.state[a][key].copy_(v)
                for a, b in zip(ref[n].buffers(), m.buffers()):
                    a.copy_(b)
        want = S.train_step(ref, ref_opt, ref_sched, batches[i], cfg, True,
                            draws[i])[0]
        step = multi(batches[i:i + 1], draws[i:i + 1], True)
        synced.append(max(rel(step[key][0], want[key]) for key in want))
        zeros = [key for key in want if float(want[key]) == 0.0]
        if zeros:
            log(f"[multistep] replay {i + 1}: eager losses exactly 0: {zeros}"
                f", graphed {[float(step[key][0]) for key in zeros]}")
        if i == 0:  # a dispatch of 1 from the first state: step 1's grads
            gaps = grad_rel({n: [p.grad for p in m.parameters()]
                             for n, m in graphed[0].items()}, grads1)
    failed += [f"replay {i + 1} loss off its eager step by {v:.3e}"
               for i, v in enumerate(synced) if not v <= 1e-5]
    spread = grad_rel(spread_grads, grads1)
    failed += [f"step 1 gradient of {n} rel L2 {v:.3e} (eager spread "
               f"{spread[n]:.3e})" for n, v in gaps.items()
               if not v <= max(5e-3, 2 * spread[n])]
    log(f"[multistep] {k} eager steps (twice) vs one graphed dispatch: "
        f"step 1 worst loss rel {worst1[0]:.3e} ({worst1[1]}); "
        "step 1 gradient rel L2 by model, graphed (eager spread) " + ", ".join(
            f"{n} {v:.3e} ({spread[n]:.3e})" for n, v in gaps.items())
        + "; later steps' total loss rel, graphed (eager spread) " + ", ".join(
            f"{v:.3e} ({e:.3e})" for v, e in later)
        + f"; parameters after {k} steps: worst excess over rtol 5e-2 / "
        f"atol 1e-3 {excess:.3e}; each replay against an eager step from "
        "its state, worst loss rel " + ", ".join(f"{v:.3e}" for v in synced))
    if failed:
        raise RuntimeError("14 equality gates failed: " + "; ".join(failed))


def _multistep_turns(train_models, cfg, batches, draws, card, group=None):
    """ms/step of K eager train_steps against one graphed dispatch of K,
    in turns (eager, graphed, graphed, eager; CUDA events around the K
    steps, median of 3 after 1 warmup), the capture before them; the peak
    memory allocated in the eager turns, and the memory the graph holds
    (reserved after its capture, beyond what was reserved before it); then
    the launches of rows 2, 3 and 4b per graphed step, counted from 0 over
    one dispatch. With ``group`` the
    models carry SyncBatchNorm and both paths the group."""
    import torch
    from movedepth_tpu_torch.parallel.sync_bn import convert_sync_batchnorm
    from movedepth_tpu_torch.train import state as S
    k = len(batches)

    def fresh():
        models = {n: copy.deepcopy(m).cuda() for n, m in train_models.items()}
        if group is not None:
            convert_sync_batchnorm(models, group)
        return (models,) + S.create_optimizer(models, cfg)

    eager_models, eager_opt, eager_sched = fresh()
    graphed = fresh()
    multi = S.make_train_multistep(*graphed, cfg, group)

    def eager():
        for b, d in zip(batches, draws):
            S.train_step(eager_models, eager_opt, eager_sched, b, cfg, True,
                         d, group)

    # what the graph holds: its private pool (one step's activations) and
    # its static tensors, reserved for as long as the graph lives
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    multi(batches, draws, True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - before) / 2 ** 30
    turns = {"eager": [], "graphed": []}
    peaks = []
    for label in ("eager", "graphed", "graphed", "eager"):
        fn = eager if label == "eager" else (
            lambda: multi(batches, draws, True))
        torch.cuda.reset_peak_memory_stats()
        turns[label].append(cuda_ms(fn, runs=3, warmup=1) / k)
        if label == "eager":
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    _zero_launch_counts()
    multi(batches, draws, True)
    torch.cuda.synchronize()
    launches = {n: v / k for n, v in _launch_counts().items()}
    where = "world-1 nccl group" if group is not None else "no group"
    log(f"[multistep] bfloat16 batch {cfg.batch_size}, 640x192, kernel_l1, "
        f"K={k}, {where}: ms/step in turns eager {turns['eager']}, graphed "
        f"{turns['graphed']}; peak allocated in the eager turns {peaks} "
        f"GiB (both model sets resident), the graph holds {held:.3f} GiB "
        f"more (reserved after its capture); launches per graphed step "
        f"{launches}; {card}")
    if not all(launches[r] for r in GRAPHED_ROWS):
        raise RuntimeError(f"14: rows 2, 3 and 4b must launch in a replay: "
                           f"{launches}")
    return launches


def phase_multistep(train_models, card):
    """Phase 14: the multi-step dispatch (``steps_per_dispatch``, a CUDA
    graph of one train step replayed K times) in the shipped config with
    kernel_l1 (bfloat16, batch 12, 640x192), K = MULTISTEP_K: equality
    against eager steps (``_multistep_equality``), ms/step and peak memory
    eager against graphed without a group and at world 1 under an nccl
    group (phase 12c's set-up), launches per graphed step. Returns the
    launches per graphed step (no group)."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch.parallel import dist as D

    t_phase = time.perf_counter()
    cfg = Config(kernel_l1=True)
    torch.backends.cudnn.benchmark = True
    batches, draws = _multistep_inputs(cfg, MULTISTEP_K)
    _multistep_equality(train_models, cfg, batches, draws)
    launches = _multistep_turns(train_models, cfg, batches, draws, card)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        try:
            D.initialize_distributed(
                "cuda", init_method=f"file://{os.path.join(tmp, 'rdzv')}")
            _multistep_turns(train_models, cfg, batches, draws, card,
                             D.default_group())
        finally:
            if D.is_distributed():
                torch.distributed.destroy_process_group()
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
                os.environ.pop(k, None)
    log(f"[multistep] phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 15

REMAT_BATCH = 32  # phase 15c: above the shipped remat_batch_threshold, 24


def _rel(a, b):
    """|a - b| / |b|, and 0 for a == b == 0."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _spread_reg2d(models):
    """At random init Reg2D's 4-bin softmax is flat (its logits vary by
    ~1e-5 across the bins), so the decode's argmax is round-off and the
    card and the CPU pick different windows. Gains on the matching feature
    (x10) and on the prob head (x100) spread it, as the pose head's gain
    gives motion."""
    import torch
    with torch.no_grad():
        models["mvs_encoder"].out.weight.mul_(10.0)
        models["reg3d"].prob.weight.mul_(100.0)


def phase_variant_paths(card):
    """15a: Reg2D (num_depth_bins 4) and the DCN head (dcn), the shipped
    config otherwise (640x192, ResNet18): forward_infer_fused at batch 1,
    float32 on the card against the CPU under phase 4's gates (pose head
    x1e-2) with row 1 launched once; one float32 train_step at batch 2 on
    the card against the CPU under phase 8's gates (pose head x40), and
    rows 2-5 launched as in phase 8. Returns {variant: launches}."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models

    out = {}
    for tag, kw in (("reg2d", dict(num_depth_bins=4)), ("dcn",
                                                        dict(dcn=True))):
        cfg = Config(compute_dtype="float32", **kw)
        base = build_models(cfg, "cpu", torch.Generator().manual_seed(0))
        if tag == "reg2d":
            _spread_reg2d(base)
        cpu_models = {k: copy.deepcopy(m) for k, m in base.items()}
        _temper_pose_head(cpu_models)
        models = {k: copy.deepcopy(m).cuda() for k, m in cpu_models.items()}
        batch = P.synthetic_batch(cfg, 1, seed=0, device="cpu")
        want = P.forward_infer_fused(cpu_models, batch, cfg)
        before = _corr_launches()
        got = P.forward_infer_fused(models, P.as_batch(batch, "cuda"), cfg)
        torch.cuda.synchronize()
        infer = _corr_launches() - before
        if infer != 1:
            raise RuntimeError(f"15a {tag}: sweep_warp_corr launched {infer} "
                               "times in one forward, expected 1")
        _check_gates(f"[15a {tag}]", got, want)
        if got["cost_prob"].shape[1] != cfg.num_depth_bins:
            raise RuntimeError(f"15a {tag}: {got['cost_prob'].shape}")

        _boost_pose_head(base)
        cpu_models = {k: copy.deepcopy(m) for k, m in base.items()}
        one_thread = {k: copy.deepcopy(m) for k, m in base.items()}
        models = {k: copy.deepcopy(m).cuda() for k, m in base.items()}
        batch = P.synthetic_batch(cfg, 2, seed=0, device="cpu")
        draws = P.sample_draws(cfg, 2, torch.Generator().manual_seed(0),
                               device="cpu")
        want, seconds = _f32_step(cfg, cpu_models, batch, draws)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _, seconds1 = _f32_step(cfg, one_thread, batch, draws)
        finally:
            torch.set_num_threads(threads)
        log(f"[15a {tag}] CPU float32 train_step at batch 2: {seconds:.1f} s "
            f"on {threads} threads, {seconds1:.1f} s on 1")
        _zero_launch_counts()
        got, _ = _f32_step(cfg, models, P.as_batch(batch, "cuda"),
                           {"box": draws["box"],
                            "noise": [n.cuda() for n in draws["noise"]]})
        torch.cuda.synchronize()
        launches = _launch_counts()
        log(f"[15a {tag}] kernel launches of one card train_step: "
            f"{launches}")
        if list(launches.values()) != [1, 1, 2, 2, 0, 0]:
            raise RuntimeError(f"15a {tag}: expected sweep_warp 1 + 1 and "
                               "warp_images_border 2 + 2")
        _card_vs_cpu(f"15a {tag}", got, want, models, cpu_models,
                     _grad_rel(one_thread, cpu_models), threads)
        out[tag] = dict(launches, sweep_warp_corr=infer)
    return out


def phase_kernels_d4(card):
    """15a, the kernels at Reg2D's 4 planes: row 1 (batch 16, the
    prior-scale shape of phase 3) and rows 2 and 3 (batch 12, phase 7's
    shape, its exact-bound and out-of-frame coordinates) against their
    plain versions under phase 3's and phase 7's gates, in float32 and
    bfloat16; device ms of each bare bfloat16 launch (row 3: the whole
    backward) beside its bound. Returns {kernel: (ms, bound ms)}."""
    import torch
    from movedepth_tpu_torch.ops import sweep_warp as SW

    d = 4
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    s = KERNEL_SHAPE
    b, r, w, c, g = s["B"], s["R"], s["W"], s["C"], s["G"]
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    ref = torch.randn(b, r, w, c, generator=gen).to(dev)
    sx, sy = (t.to(dev) for t in _sweep_coords(b, r, w, d, gen))
    _check_kernel(src, ref, sx, sy, g)
    out1 = torch.empty((b, d, r, w, g), dtype=torch.bfloat16, device=dev)
    ms1 = device_ms(_bare(SW.kernel_library().sweep_warp_corr_bf16,
                          src.bfloat16(), ref.bfloat16(), sx, sy, out1, b, r,
                          w, d, r, c, g))
    bound1 = bound(*sweep_corr_work(b, r, w, c, d, r, g, 2))["bound_ms"]

    t = TRAIN_SHAPE
    b = t["B"]
    x, y = _sweep_coords(b, r, w, d, gen)
    _edge_cases(x, y, w, r)
    x, y = x.to(dev), y.to(dev)
    src = torch.randn(b, r, w, c, generator=gen).to(dev)
    grad = torch.randn((b, d, r, w, c), generator=gen).to(dev)
    _within("sweep_warp float32 forward, D=4", SW.sweep_warp(src, x, y),
            SW.sweep_warp_reference(src, x, y))
    _within("sweep_warp bfloat16 forward, D=4",
            SW.sweep_warp(src.bfloat16(), x, y),
            SW.sweep_warp_reference(src.bfloat16().float(), x, y), bf16=True)
    _dsrc_check("sweep_warp float32 dsrc, D=4", src, x, y, grad)
    _dsrc_check("sweep_warp bfloat16 dsrc, D=4", src, x, y, grad, True)
    lib = SW.warp_library()
    out2 = torch.empty((b, d, r, w, c), dtype=torch.bfloat16, device=dev)
    ms2 = device_ms(_bare(lib.sweep_warp_fwd_bf16, src.bfloat16(), x, y,
                          out2, b, r, w, d, r, c))
    dsrc32 = torch.zeros((b, r, w, c), device=dev)
    dsrc16 = torch.empty((b, r, w, c), dtype=torch.bfloat16, device=dev)
    launch = _bare(lib.sweep_warp_bwd_bf16, grad.bfloat16(), x, y, dsrc32, b,
                   r, w, d, r, c)

    def whole():
        dsrc32.zero_()
        launch()
        dsrc16.copy_(dsrc32)
    ms3 = device_ms(whole)
    times = {"sweep_warp_corr": (ms1, bound1),
             "sweep_warp": (ms2, bound(*sweep_warp_work(
                 b, r, w, c, d, r, 2))["bound_ms"]),
             "sweep_warp_bwd": (ms3, bound(*sweep_warp_work(
                 b, r, w, c, d, r, 2, True))["bound_ms"])}
    log("[15a kernels] D=4, bfloat16 bare launches, device ms (bound): "
        + ", ".join(f"{k} {ms:.4f} ({bd:.4f})" for k, (ms, bd)
                    in times.items())
        + f"; row 1 at batch {s['B']}, rows 2-3 at batch {b}; {card}")
    return times


def _fresh(base, cfg):
    """Card copies of ``base`` stored as ``cfg.param_dtype``, Adam and its
    schedule."""
    import torch
    from movedepth_tpu_torch.models.storage import (param_dtype,
                                                    store_parameters)
    from movedepth_tpu_torch.train import state as S
    models = {k: copy.deepcopy(m).cuda() for k, m in base.items()}
    if param_dtype(cfg) != torch.float32:
        store_parameters(models, param_dtype(cfg))
    return (models,) + S.create_optimizer(models, cfg)


def _timed_turns(base, cfgs, batch, draws, runs, warmup):
    """ms/step and peak allocated GiB of train_step for each labelled
    config of ``cfgs``, in turns, twice each."""
    import torch
    from movedepth_tpu_torch.train import state as S
    times = {label: [] for label in cfgs}
    peaks = {label: [] for label in cfgs}
    for label in list(cfgs) * 2:
        cfg = cfgs[label]
        models, opt, sched = _fresh(base, cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times[label].append(cuda_ms(lambda: S.train_step(
            models, opt, sched, batch, cfg, True, draws), runs=runs,
            warmup=warmup))
        peaks[label].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        del models, opt, sched
    return times, peaks


def phase_param_storage(card):
    """15b: bfloat16 parameter storage in the shipped bfloat16 kernel_l1
    step at batch 12, 640x192, from the same weights (rounded to bfloat16
    for both): the first step's losses with parameters stored in float32
    (twice: its spread) and in bfloat16, within max(1e-5, twice that
    spread) (autocast runs the convolutions on the same bfloat16 weights);
    the type of every parameter, gradient, Adam state and BatchNorm
    statistic after the bfloat16 step; ms/step and peak memory of both, in
    turns (3 warm-up steps, median of 10)."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.train import state as S

    cfg32 = Config(kernel_l1=True)
    cfgs = {"float32": cfg32, "bfloat16": cfg32.replace(
        param_dtype="bfloat16")}
    base = build_models(cfg32, "cpu", torch.Generator().manual_seed(0))
    _boost_pose_head(base)
    with torch.no_grad():
        for m in base.values():
            for p in m.parameters():
                p.copy_(p.bfloat16())
    bsz = cfg32.batch_size
    batch = P.synthetic_batch(cfg32, bsz, seed=1, device="cuda")
    draws = P.sample_draws(cfg32, bsz, torch.Generator("cuda").manual_seed(1),
                           device="cuda")
    first = []
    for label in ("float32", "float32", "bfloat16"):
        models, opt, sched = _fresh(base, cfgs[label])
        first.append(S.train_step(models, opt, sched, batch, cfgs[label],
                                  True, draws)[0])
    spread = max(_rel(first[1][k], first[0][k]) for k in first[0])
    gap = max(_rel(first[2][k], first[0][k]) for k in first[0])
    types = {"parameters": {p.dtype for m in models.values()
                            for p in m.parameters()},
             "gradients": {p.grad.dtype for m in models.values()
                           for p in m.parameters()},
             "Adam moments": {v.dtype for st in opt.state.values()
                              for k, v in st.items() if k != "step"},
             "Adam steps": {st["step"].dtype for st in opt.state.values()},
             "BatchNorm statistics": {t.dtype for m in models.values()
                                      for n, t in m.named_buffers()
                                      if "running" in n}}
    want = {"parameters": {torch.bfloat16}, "gradients": {torch.bfloat16},
            "Adam moments": {torch.bfloat16}, "Adam steps": {torch.float32},
            "BatchNorm statistics": {torch.float32}}
    log(f"[15b] first step's losses, bfloat16 against float32 storage: "
        f"worst rel {gap:.3e}; two float32 runs {spread:.3e}; types after "
        f"the bfloat16 step {types}")
    if types != want:
        raise RuntimeError(f"15b: types {types}, expected {want}")
    if not gap <= max(1e-5, 2 * spread):
        raise RuntimeError(f"15b: bfloat16 storage moves the losses by "
                           f"{gap:.3e} (float32 runs {spread:.3e})")
    del models, opt, sched
    times, peaks = _timed_turns(base, cfgs, batch, draws, 10, 3)
    log(f"[15b] bfloat16 kernel_l1 train_step batch {bsz}, 640x192, in "
        f"turns: ms/step {times}, peak allocated GiB {peaks} (parameters "
        f"stored float32 / bfloat16); {card}")


def _bn_state(models):
    return {(n, k): t.detach().clone() for n, m in models.items()
            for k, t in m.named_buffers()}


def _train_state(models, opt):
    """Clones of every parameter, buffer and Adam state of ``models``."""
    return ([t.detach().clone() for m in models.values()
             for t in list(m.parameters()) + list(m.buffers())],
            [{k: v.clone() for k, v in opt.state[p].items()}
             if p in opt.state else None
             for m in models.values() for p in m.parameters()])


def _load_train_state(models, opt, state):
    """``models`` and ``opt`` as ``_train_state`` cloned them (a parameter
    without Adam state is given none: a fresh Adam's)."""
    import torch
    tensors, adam = state
    params = [p for m in models.values() for p in m.parameters()]
    with torch.no_grad():
        for t, v in zip([t for m in models.values()
                         for t in list(m.parameters()) + list(m.buffers())],
                        tensors):
            t.copy_(v)
    for p, st in zip(params, adam):
        opt.state.pop(p, None)
        if st is not None:
            opt.state[p] = {k: v.clone() for k, v in st.items()}


def _state_gaps(got, runs):
    """Per model and kind (parameters, buffers, Adam's moments) of ``got``
    against the first of ``runs`` (two eager steps from the same state):
    (tensors, tensors off the first eager step, tensors where the two
    eager steps differ, relative L2 distance of ``got`` from the first
    eager step, the second's). ``got`` and ``runs`` are (model names,
    ``_train_state``) and ``_train_state`` values."""
    import torch
    names, (tensors, adam) = got
    ref, again = runs
    if not ([st is None for st in adam] == [st is None for st in ref[1]]
            == [st is None for st in again[1]]):
        raise RuntimeError("15c: the replay and the eager steps hold Adam "
                           "state for different parameters")
    kinds = [(n, "buffers" if i >= c else "parameters")
             for n, c, total in names for i in range(total)]
    moments = [(n, "Adam moments") for n, c, total in names for i in range(c)]

    def flat(state):
        tens, ad = state
        out = list(tens)
        for st in ad:
            out += [v for k, v in sorted((st or {}).items()) if k != "step"]
        return out

    labels = kinds + [lab for lab, st in zip(moments, adam)
                      for k in sorted(st or {}) if k != "step"]
    gaps = {}
    for lab, g, a, b in zip(labels, flat((tensors, adam)), flat(ref),
                            flat(again)):
        entry = gaps.setdefault(lab, [0, 0, 0, 0.0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += int(not torch.equal(g, a))
        entry[2] += int(not torch.equal(b, a))
        entry[3] += float((g.double() - a.double()).norm() ** 2)
        entry[4] += float((b.double() - a.double()).norm() ** 2)
        entry[5] += float(a.double().norm() ** 2)
    return {lab: (n, off, var, (d / max(s, 1e-300)) ** 0.5,
                  (e / max(s, 1e-300)) ** 0.5)
            for lab, (n, off, var, d, e, s) in gaps.items()}


def _autotune_per_thread():
    """Seconds of a convolution no phase ran before with cuDNN's
    autotuning on: its first call, its second, and its first on another
    thread. A first call times the algorithms; a call that finds the
    choice made does not."""
    import threading
    import torch
    torch.backends.cudnn.benchmark = True
    x = torch.randn(8, 40, 72, 72, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(56, 40, 3, 3, device="cuda", dtype=torch.bfloat16)

    def timed(out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.nn.functional.conv2d(x, w, padding=1)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)

    here, there = [], []
    timed(here)
    timed(here)
    thread = threading.Thread(target=timed, args=(there,))
    thread.start()
    thread.join()
    return here[0], here[1], there[0]


def phase_remat(card):
    """15c: rematerialization at batch REMAT_BATCH (above the threshold of
    24) in the shipped bfloat16 kernel_l1 step: remat_scope "full" and
    "mvs" against no remat (remat_batch_threshold 32), from the same
    weights, batch and draws, with cuDNN's heuristic choice of algorithm,
    as the trainer runs a rematerialized step (its autotuner keeps its
    choices per thread, so the recompute, on autograd's device thread,
    could time another algorithm than its forward took; the same two
    steps with autotuning on, in a key space neither thread has filled,
    are reported beside a new convolution's first call on two threads).
    Step 1: every loss within 1e-5 relative of the no-remat step's, every
    model's gradient within max(5e-3, twice two no-remat runs' spread)
    (row 3's atomics), every BatchNorm running statistic within 1e-6
    relative and every count equal; launches (the recompute runs row 2
    and the frame blocks' row 4b again). ms/step and peak memory of the
    three in turns (2 warm-up steps, median of 3). Then the remat step
    with bfloat16 parameters as a CUDA graph (steps_per_dispatch 2), each
    replay against two eager steps from its state: the losses and every
    buffer bit for bit; the parameters and Adam moments of each model bit
    for bit where the two eager steps agree on all of that model's
    tensors, else within max(5e-3, twice the eager steps' distance)
    relative L2 (row 3's atomics reach them). Returns the remat ("full")
    step's launches."""
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.train import state as S

    cfg = Config(kernel_l1=True, batch_size=REMAT_BATCH)
    cfgs = {"no remat": cfg.replace(remat_batch_threshold=REMAT_BATCH),
            "full": cfg, "mvs": cfg.replace(remat_scope="mvs")}
    base = build_models(cfg, "cpu", torch.Generator().manual_seed(0))
    _boost_pose_head(base)
    batch = P.synthetic_batch(cfg, REMAT_BATCH, seed=2, device="cuda")
    draws = P.sample_draws(cfg, REMAT_BATCH,
                           torch.Generator("cuda").manual_seed(2), "cuda")
    # autotuning off: the trainer's setting for a rematerialized step
    # (train/trainer.py), cuDNN's heuristic choice, the same on every thread
    runs = {}
    for label, key in (("no remat", "no remat"),
                       ("no remat again", "no remat"), ("full", "full"),
                       ("mvs", "mvs"), ("tuned no remat", "no remat"),
                       ("tuned full", "full")):
        # the last two: autotuning on, in a key space of cuDNN's plan
        # caches that neither thread has filled (deterministic algorithms)
        torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic \
            = label.startswith("tuned")
        step_cfg = cfgs[key]
        models, opt, sched = _fresh(base, step_cfg)
        _zero_launch_counts()
        losses = S.train_step(models, opt, sched, batch, step_cfg, True,
                              draws)[0]
        torch.cuda.synchronize()
        runs[label] = (losses, {n: [p.grad.clone() for p in m.parameters()]
                                for n, m in models.items()},
                       _bn_state(models), _launch_counts())
        del models, opt, sched

    def grad_rel(got, want):
        return {n: (sum(float((a.float() - b.float()).norm() ** 2)
                        for a, b in zip(got[n], want[n]))
                    / sum(float(b.float().norm() ** 2) for b in want[n]))
                ** 0.5 for n in want}

    ref = runs["no remat"]
    spread = grad_rel(runs["no remat again"][1], ref[1])
    failed = []
    want_launches = {"no remat": [1, 1, 0, 0, 2, 2],
                     "full": [2, 1, 0, 0, 4, 2], "mvs": [2, 1, 0, 0, 4, 2]}
    for label in ("full", "mvs"):
        losses, grads, stats, launches = runs[label]
        worst = max(_rel(losses[k], ref[0][k]) for k in ref[0])
        gaps = grad_rel(grads, ref[1])
        stat = max(float(((a.double() - b.double()).abs()
                          / b.double().abs().clamp_min(1e-30)).max())
                   if b.is_floating_point() else float((a != b).any())
                   for (a, b) in ((stats[k], ref[2][k]) for k in ref[2]))
        log(f"[15c] {label} against no remat at batch {REMAT_BATCH}, cuDNN "
            f"heuristics: losses worst rel {worst:.3e}; gradient rel L2 "
            "(no-remat spread) "
            + ", ".join(f"{n} {v:.3e} ({spread[n]:.3e})"
                        for n, v in gaps.items())
            + f"; BatchNorm buffers worst rel {stat:.3e}; launches "
            f"{launches} (no remat {ref[3]})")
        if not worst <= 1e-5:
            failed.append(f"{label} losses {worst:.3e}")
        failed += [f"{label} gradient of {n} {v:.3e}" for n, v in gaps.items()
                   if not v <= max(5e-3, 2 * spread[n])]
        if not stat <= 1e-6:
            failed.append(f"{label} BatchNorm buffers {stat:.3e}")
    for label, want in want_launches.items():
        if list(runs[label][3].values()) != want:
            failed.append(f"{label} launches {runs[label][3]}, expected "
                          f"{want}")
    if failed:
        raise RuntimeError("15c gates failed: " + "; ".join(failed))
    tuned = grad_rel(runs["tuned full"][1], runs["tuned no remat"][1])
    first, second, other = _autotune_per_thread()
    log("[15c] why a rematerialized step takes cuDNN's heuristics: with "
        "autotuning on, full against no remat, gradient rel L2 (reported) "
        + ", ".join(f"{n} {v:.3e}" for n, v in tuned.items())
        + f"; a new convolution's first call {first * 1e3:.3f} ms, its "
        f"second {second * 1e3:.3f} ms, its first on another thread "
        f"{other * 1e3:.3f} ms (the autotuner's choices are kept per "
        "thread, and the recompute runs on autograd's device thread)")
    torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic \
        = False
    launches = runs["full"][3]
    del runs, ref

    times, peaks = _timed_turns(base, cfgs, batch, draws, 3, 2)
    log(f"[15c] bfloat16 kernel_l1 train_step batch {REMAT_BATCH}, 640x192, "
        f"in turns: ms/step {times}, peak allocated GiB {peaks}; {card}")

    gcfg = cfg.replace(param_dtype="bfloat16")
    batches = [batch, P.synthetic_batch(cfg, REMAT_BATCH, seed=3,
                                        device="cuda")]
    gen = torch.Generator("cuda").manual_seed(3)
    step_draws = [draws, P.sample_draws(cfg, REMAT_BATCH, gen, "cuda")]
    graphed, (ref_models, ref_opt, ref_sched) = (_fresh(base, gcfg),
                                                 _fresh(base, gcfg))
    names = [(n, len(list(m.parameters())),
              len(list(m.parameters())) + len(list(m.buffers())))
             for n, m in graphed[0].items()]
    multi = S.make_train_multistep(*graphed, gcfg)
    failed = []
    for i in range(2):
        start = _train_state(*graphed[:2])
        eager = []
        for _ in range(2):
            _load_train_state(ref_models, ref_opt, start)
            losses = S.train_step(ref_models, ref_opt, ref_sched, batches[i],
                                  gcfg, True, step_draws[i])[0]
            eager.append((losses, _train_state(ref_models, ref_opt)))
        got = multi(batches[i:i + 1], step_draws[i:i + 1], True)
        exact = all(torch.equal(got[k][0], eager[0][0][k])
                    for k in eager[0][0])
        again = all(torch.equal(eager[1][0][k], eager[0][0][k])
                    for k in eager[0][0])
        gaps = _state_gaps((names, _train_state(*graphed[:2])),
                           [e[1] for e in eager])
        steady = {n for n, _, _ in names
                  if all(v[2] == 0 for (m, _), v in gaps.items() if m == n)}
        log(f"[15c] remat step with bfloat16 parameters as a CUDA graph, "
            f"replay {i + 1} against two eager steps from its state: losses "
            f"bit for bit {exact} (the eager steps' {again}); models whose "
            f"eager steps agree bit for bit {sorted(steady)}; per model and "
            "kind, tensors off the eager step / tensors (where the eager "
            "steps differ), rel L2 (the eager steps'): "
            + "; ".join(f"{n} {kind} {off}/{cnt} ({var}), {d:.3e} ({e:.3e})"
                        for (n, kind), (cnt, off, var, d, e)
                        in gaps.items()))
        if not exact:
            failed.append(f"replay {i + 1} losses")
        for (n, kind), (cnt, off, var, d, e) in gaps.items():
            if kind == "buffers" or n in steady:
                if off:
                    failed.append(f"replay {i + 1} {n} {kind}: {off} of "
                                  f"{cnt} tensors off")
            elif not d <= max(5e-3, 2 * e):
                failed.append(f"replay {i + 1} {n} {kind} rel L2 {d:.3e} "
                              f"(eager {e:.3e})")
    log(f"[15c] launches per replay {multi.graphs[True].counts}")
    if failed:
        raise RuntimeError("15c: a graphed remat replay is off its eager "
                           "step: " + "; ".join(failed))
    return launches


def phase_robust_train(root, card):
    """15d: ``Loader.epoch`` with robust_train's frame offsets on phase
    10a's tree, native against PIL in turns, one pass each
    (``phase_loader``); the train CLI's entry point in this process for
    one epoch of 2 steps (batch 12, 640x192, bfloat16, --kernel_l1) with
    --robust_train --param_dtype bfloat16 --num_depth_bins 4 --dcn, whose
    start-up lines must name the native loader reading the offsets,
    bfloat16 parameters and the remat state, then a resume from ``last``
    that reloads bfloat16 weights and Adam state for a second epoch.
    Returns the first run's kernel launches."""
    import torch
    from movedepth_tpu_torch.config import ALL_MODELS

    phase_loader(root, card, rt=True, passes=1)
    splits = os.path.join(root, "splits")
    os.makedirs(os.path.join(splits, "variants"))
    with open(os.path.join(splits, "variants", "train_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in range(4, 28)))
    with open(os.path.join(splits, "variants", "val_files.txt"), "w") as f:
        f.write("\n".join(f"{DRIVE} {i} l" for i in range(30, 42)))
    log_dir = os.path.join(root, "log_variants")
    common = ["--data_path", root, "--log_dir", log_dir, "--model_name",
              "variants", "--split", "variants", "--splits_dir", splits,
              "--kernel_l1", "--weights_init", "scratch", "--robust_train",
              "--param_dtype", "bfloat16", "--num_depth_bins", "4", "--dcn"]
    lines, epochs, launches = _train_cli_here(common + ["--num_epochs", "1"])
    want = ("data: native loader, route ",
            "it reads train and val (train with robust_train's frame offsets)",
            "parameters bfloat16 (BatchNorm statistics float32); remat off at "
            "batch 12 (remat_batch_threshold 24: heavy=False, "
            "heavy_enc=False, remat_scope full); cuDNN autotuning on")
    missing = [w for w in want if not any(w in ln for ln in lines)]
    if missing:
        raise RuntimeError(f"15d: the start-up lines lack {missing}")
    if {e: n for e, (n, _, _) in epochs.items()} != {0: 2}:
        raise RuntimeError(f"15d: expected one epoch of 2 steps: {epochs}")
    if not all(launches[r] for r in GRAPHED_ROWS):
        raise RuntimeError(f"15d: rows 2, 3 and 4b not launched {launches}")
    models_dir = os.path.join(log_dir, "variants", "models")
    last = os.path.join(models_dir, "last")
    _check_folders(models_dir, ("weights_0", "last"), ALL_MODELS)
    sd = torch.load(os.path.join(last, "mvs_encoder.pth"), weights_only=True)
    adam = torch.load(os.path.join(last, "adam.pth"), weights_only=True)
    kinds = ({sd["out_dcn_0.weight"].dtype, sd["conv0.0.conv.weight"].dtype},
             {s["exp_avg"].dtype for s in adam["optimizer"]["state"].values()})
    if kinds != ({torch.bfloat16}, {torch.bfloat16}):
        raise RuntimeError(f"15d: saved weights and moments {kinds}")
    _, epochs2, launches2 = _train_cli_here(
        common + ["--num_epochs", "2", "--load_weights_folder", last])
    step = _check_folders(models_dir, ("weights_0", "weights_1", "last"),
                          ALL_MODELS)
    log(f"[15d] robust_train CLI with bfloat16 parameters, Reg2D and the DCN "
        f"head: launches {launches}, wall ms/step {epochs}; resume from last "
        f"(bfloat16 weights and moments): epochs {epochs2}, step {step}, "
        f"launches {launches2}; {card}")
    if step != 4 or sorted(epochs2) != [1]:
        raise RuntimeError("15d: the resume did not train epoch 1 from step 2")
    return launches


def _tensors(out):
    """The tensors of a module's output (a tensor, or tuples, lists and
    dicts of them), in a fixed order."""
    if isinstance(out, dict):
        return [t for k in sorted(out, key=str) for t in _tensors(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return [out]


def _module_on_card(name, cpu_fn, card_fn, card, rel=1e-4):
    """Run ``cpu_fn`` and ``card_fn`` (the same module, weights and inputs
    on the CPU and on the card) under no_grad; raise unless every output
    is finite, of the CPU's shape, and within ``rel`` of max(1, |CPU|)
    (tests/test_torch_port_models.py's gate); log the worst difference,
    the tolerance and the card's device ms a call. Returns (the card's
    outputs, the CPU's), flattened by :func:`_tensors`."""
    import torch
    with torch.no_grad():
        want, got = _tensors(cpu_fn()), _tensors(card_fn())
        worst, tol = 0.0, 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise RuntimeError(f"16: {name} gave {tuple(g.shape)} "
                                   f"(CPU {tuple(w.shape)}) or non-finite "
                                   "values on the card")
            t = rel * max(1.0, w.abs().max().item())
            e = (g.cpu().double() - w.double()).abs().max().item()
            if not e <= t:
                raise RuntimeError(f"16: {name} card vs CPU max_abs {e:.3e}"
                                   f" > {t:.3e}")
            worst, tol = max(worst, e), max(tol, t)
        ms = plain_ms(card_fn)
    log(f"[16] {name}: card vs CPU max_abs {worst:.3e}, tolerance "
        f"{tol:.3e} ({rel:g} of max(1, |CPU|)); {ms:.4f} ms a call on the "
        f"card ({card})")
    return got, want


def _to_card(args):
    import torch
    return [[a.cuda() for a in x] if isinstance(x, list) else
            x.cuda() if isinstance(x, torch.Tensor) else x for x in args]


def _ply_points(path):
    import numpy as np
    with open(path) as f:
        lines = f.read().split("end_header\n", 1)[1].splitlines()
    return np.array([[float(v) for v in ln.split()] for ln in lines])


def phase_remaining_modules(cpu_models, card):
    """16: the modules that no pipeline path runs, on the card at 640x192,
    batch 2, float32 (TF32 off), each against the same module with the
    same weights and inputs on the CPU: upsample_nearest_2x; the per-pixel
    transforms, their projection and project_pixel; schedule_depth_bins_v1
    plain, geo-masked and z-scaled; mvs_ssim; update_flow (flowvis's
    images and a point cloud written from the card's outputs on the host);
    ContextEncoder, PoseCNN, FPN3cas and the experimental decoders over
    phase 4's mono encoder's ResNet18 features; ContextAdjustmentLayer."""
    import numpy as np
    import torch
    from movedepth_tpu_torch import Config
    from movedepth_tpu_torch import models as M
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.models import decoders_extra as DX
    from movedepth_tpu_torch.ops import costvolume as CV
    from movedepth_tpu_torch.ops import flowvis as FV
    from movedepth_tpu_torch.ops import geometry as G
    from movedepth_tpu_torch.ops import losses as L
    from movedepth_tpu_torch.ops import pointcloud as PC
    from movedepth_tpu_torch.ops.sampling import upsample_nearest_2x

    cfg = Config(compute_dtype="float32")
    b, h, w = 2, cfg.height, cfg.width
    gen = torch.Generator().manual_seed(16)
    batch = P.synthetic_batch(cfg, b, seed=0, device="cpu")
    frames = batch["color"].permute(0, 1, 4, 2, 3)  # (B, F, 3, H, W)
    img = frames[:, 0].contiguous()
    with torch.no_grad():
        feats = cpu_models["mono_encoder"](img)

    def check(name, fn, *args, rel=1e-4):
        card_args = _to_card(args)
        return _module_on_card(name, lambda: fn(*args),
                               lambda: fn(*card_args), card, rel)

    def module(name, m, *args, rel=1e-4):
        m = m.eval()
        card_m, card_args = copy.deepcopy(m).cuda(), _to_card(args)
        return _module_on_card(name, lambda: m(*args),
                               lambda: card_m(*card_args), card, rel)

    check("upsample_nearest_2x", upsample_nearest_2x, feats[1])
    K = _kitti_K(b, h, w)
    inv_K = torch.linalg.inv(K)
    depth = torch.rand(b, h, w, generator=gen) * 55 + 5
    points = G.backproject(depth, inv_K)
    aa = torch.randn(b, 3, generator=gen) * 5e-3
    trans = torch.randn(b, h, w, 3, generator=gen) * 3e-2
    T_px = check("transformation_from_parameters_v2",
                 G.transformation_from_parameters_v2, aa, trans)[1][0]
    check("project_per_pixel", G.project_per_pixel, points, K, T_px)
    T = _kitti_pose(b, gen)
    check("project_pixel", G.project_pixel, points, K, T, h, w)
    disp = torch.rand(b, h, w, generator=gen) * 0.85 + 0.05
    v1 = (16, 0.5, 0.1, 100.0)
    check("schedule_depth_bins_v1", CV.schedule_depth_bins_v1, disp, *v1)
    check("schedule_depth_bins_v1 geo", lambda d, m: CV.schedule_depth_bins_v1(
        d, *v1, geo_mask=m, damper=2.0), disp,
        torch.rand(b, h, w, generator=gen) < 0.5)
    check("schedule_depth_bins_v1 z", lambda d, z: CV.schedule_depth_bins_v1(
        d, *v1, z_trans=z), disp, torch.tensor([0.5, 1.5]))
    nhwc = batch["color"]
    check("mvs_ssim", L.mvs_ssim, nhwc[:, 0], nhwc[:, 1],
          (torch.rand(b, h, w, 1, generator=gen) < 0.7).float())
    grid = G.project(points, K, T, h, w)
    flow = torch.randn(b, h, w, 2, generator=gen)
    card_flow, cpu_flow = (o[0] for o in check(
        "update_flow", FV.update_flow, flow, grid, w, h))
    t0 = time.perf_counter()
    got = FV.flow_to_image(card_flow[0].cpu().numpy())
    host_ms = (time.perf_counter() - t0) * 1e3
    want = FV.flow_to_image(cpu_flow[0].numpy())
    levels = int(np.abs(got.astype(int) - want.astype(int)).max())
    if got.shape != (h, w, 3) or levels > 1:
        raise RuntimeError(f"16: flow_to_image of the card's flow differs "
                           f"from the CPU's by {levels} levels")
    log(f"[16] flow_to_image (host numpy) of the card's update_flow: "
        f"{levels} levels from the CPU's image (tolerance 1); "
        f"{host_ms:.1f} ms on the host")

    torch.manual_seed(16)  # the modules' default initialization
    chans = M.encoder_channels(cfg.res_arch)
    module("ContextEncoder", M.ContextEncoder(cfg.res_arch), img)
    module("PoseCNN", M.PoseCNN(3), frames.reshape(b, 9, h, w), rel=1e-6)
    module("FPN3cas", M.FPN3cas(8), img)
    _module_on_card("depth_grid", lambda: DX.depth_grid("SID", 96, 0.1, 10.0),
                    lambda: DX.depth_grid("SID", 96, 0.1, 10.0,
                                          device="cuda"), card)
    costvol = torch.rand(b, 16, h // 4, w // 4, generator=gen)
    module("MPMDecoder", M.MPMDecoder(chans, num_bins=16), costvol, feats)
    d3 = module("DepthDecoder3D", M.DepthDecoder3D(chans), feats)
    module("DepthDecoderBin", M.DepthDecoderBin(chans), feats)
    module("DepthDecoder3Head", M.DepthDecoder3Head(chans), feats)
    fused = torch.rand(b, 1, h, w, generator=gen) * 55 + 5
    module("ResBlockWDSR", M.ResBlockWDSR(16),
           torch.randn(b, 16, h, w, generator=gen), fused / 60)
    module("ContextAdjustmentLayer", M.ContextAdjustmentLayer(), fused, img)

    # a point cloud from the card's and the CPU's finest depth maps
    mask = np.zeros((h, w), np.float32)
    mask[::8, ::8] = 1
    rgb = (nhwc[0, 0].numpy() * 255).astype(np.uint8)
    clouds = []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, depths in zip(("card", "cpu"), d3):
            t0 = time.perf_counter()
            PC.generate_pointcloud([rgb], [depths[0][0, 0].cpu().numpy()],
                                   f"{tmp}/{tag}.ply", [K[0].numpy()],
                                   [np.eye(4)], [mask])
            host_ms = (time.perf_counter() - t0) * 1e3
            clouds.append(_ply_points(f"{tmp}/{tag}.ply"))
    got, want = clouds
    worst = float(np.abs(got - want).max())
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    if got.shape != (int(mask.sum()), 7) or not worst <= tol:
        raise RuntimeError(f"16: the card's point cloud {got.shape} differs "
                           f"from the CPU's by {worst:.3e}")
    log(f"[16] generate_pointcloud (host numpy) of the card's DepthDecoder3D "
        f"depths: {len(got)} vertices, max_abs {worst:.3e} from the CPU's "
        f"(tolerance {tol:.3e}); {host_ms:.1f} ms on the host")


def main():
    if sys.argv[1:] == ["--clamp-launches"]:  # phase 7's child process
        _clamp_launches(phase_device())
        return
    if sys.argv[1:2] == ["--ddp-rank"]:  # a rank of phase 12b
        _ddp_rank(int(sys.argv[2]), sys.argv[3])
        return
    t_start = time.perf_counter()

    def done(phase):
        log(f"[time] phase {phase} done after "
            f"{time.perf_counter() - t_start:.1f} s")

    card = phase_device()
    phase_build()
    done("2")
    kernel = phase_kernel(card)
    done("3")
    cpu_models = phase_main_path()
    phase_group_configs()
    done("4b")
    kernel["launches"] = phase_serve(cpu_models)
    done("5")
    kernel["launches_eval"] = phase_eval(cpu_models, card)
    done("5b")
    phase_throughput(cpu_models, card)
    done("6")
    sweep_kernels, gen = phase_sweep_warp(card)
    image_kernels, image_inputs = phase_train_kernels(card, gen)
    train_kernels = sweep_kernels + image_kernels
    l1_kernels = phase_l1_kernel(*image_inputs)
    del image_inputs
    done("7b")
    launches, train_models, phase8 = phase_train_path()
    for rec in train_kernels:
        rec["launches"] = launches[rec["name"]]
    phase_train_path_l1(*phase8)
    done("8b")
    l1_ms = phase_train_throughput(train_models, card)
    done("9")
    cli_launches, cli_warm = phase_train_cli(l1_ms, card)
    done("10")
    with tempfile.TemporaryDirectory() as tmp:
        splits = _write_loader_tree(tmp)
        phase_loader(tmp, card)
        done("10a")
        phase_loader_cli(tmp, splits, l1_ms, card)
        done("10b")
        for rec in l1_kernels:
            rec["launches"] = cli_launches[rec["name"]]
        variants = phase_variants()
        done("11")
        ddp_cli = phase_ddp_cli(cli_warm, card)
        done("12a")
        ddp_ranks = phase_ddp_ranks(card)
        done("12b")
        phase_ddp_overhead(train_models, card)
        done("12c")
        kernel["launches_13"] = phase_export(cpu_models, card)
        done("13")
        graphed = phase_multistep(train_models, card)
        done("14")
        variant_launches = phase_variant_paths(card)
        d4 = phase_kernels_d4(card)
        done("15a")
        phase_param_storage(card)
        done("15b")
        remat = phase_remat(card)
        done("15c")
        rt_cli = phase_robust_train(tmp, card)
        done("15d")
    phase_remaining_modules(cpu_models, card)
    done("16")
    for rec in train_kernels + l1_kernels:
        if rec["name"] in ddp_cli:
            rec["launches_12a"] = ddp_cli[rec["name"]]
        if rec["name"] in ddp_ranks:
            rec["launches_12b"] = ddp_ranks[rec["name"]]
        rec["launches_14"] = graphed[rec["name"]]
        rec["launches_15c"] = remat[rec["name"]]
        rec["launches_15d"] = rt_cli[rec["name"]]
    for rec in [kernel] + train_kernels + l1_kernels:
        for tag, counts in variant_launches.items():
            if rec["name"] in counts:
                rec[f"launches_15a_{tag}"] = counts[rec["name"]]
        if rec["name"] in d4:
            rec["ms_d4"], rec["bound_ms_d4"] = d4[rec["name"]]
    import torch
    log(card)
    log(json.dumps({"kernels": [kernel] + train_kernels + l1_kernels
                    + [variants]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
