"""The MoveDepth pipeline of the port (port of movedepth_tpu/pipeline.py):
inference (``forward_infer``, ``forward_infer_fused``,
``forward_mono_infer``) and the training forward with all losses
(``forward_train``).

Batches and outputs keep the JAX package's layouts and keys: ``color`` and
``color_aug`` are (B, F, H, W, 3) with frames in ``frame_ids`` order
(``matching_ids`` at inference), ``color_pyr_s`` (B, H/2^s, W/2^s, 3),
``K``/``inv_K`` (B, 4, 4), the optional ``relative_pose`` (B, F-1, 4, 4);
depth and disparity maps come back as (B, H, W). Inside, models run in
NCHW.

Models run under ``torch.autocast("cuda", torch.bfloat16)`` when
``cfg.compute_dtype`` is "bfloat16" and the batch is on a CUDA device, and
in float32 otherwise; parameters stored in another type (``param_dtype``)
are cast where they are used (``models.storage``). Geometry, depth bins,
the softmax, the decode, the losses and the image warps always run in
float32, outside autocast.

A training batch of more than ``cfg.remat_batch_threshold`` rows is
rematerialized as the JAX package's is (``torch.utils.checkpoint``): the
MVS trunk and the photometric frame blocks, and with ``remat_scope``
"full" also the encoders (see :func:`forward_train`).
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Dict

import numpy as np
import torch
import torch.utils.checkpoint

from movedepth_tpu_torch import trace
from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.data.synthetic import make_batch
from movedepth_tpu_torch.ops.costvolume import (
    fuse_frames,
    localmax,
    reduce_cost_groups,
    schedule_depth_bins,
    schedule_depth_bins_z,
    sweep_grid,
)
from movedepth_tpu_torch.ops.geometry import (
    backproject,
    disp_to_depth,
    project,
    transformation_from_parameters,
)
from movedepth_tpu_torch.ops.image_warp import warp_images_border
from movedepth_tpu_torch.ops.losses import (
    entropy,
    masked_mean,
    min_reprojection_with_automask,
    reprojection_loss,
    smooth_loss,
    ssim,
)
from movedepth_tpu_torch.ops.masking import (
    geometric_consistency_mask,
    random_image_mask,
    sample_box,
)
from movedepth_tpu_torch.ops.sampling import resize_bilinear
from movedepth_tpu_torch.ops.sweep_warp import (
    grid_to_pixel,
    sweep_warp,
    sweep_warp_corr,
)
from movedepth_tpu_torch.ops.upsample import convex_upsample


# The pinned staging ring of ``as_batch`` on a CUDA device: SLOTS host
# buffers of CHUNK bytes, taken in turn. On H100 hosts the copy into a
# slot (14-34 GB/s on 8 threads) is slower than the transfer out of it
# (~54 GB/s), so three slots keep the host from waiting; chunks of 2-64
# MiB staged a batch within a few ms of each other (PERF.md section 6).
CHUNK = 16 << 20
SLOTS = 3


def chunk_plan(nbytes: int, chunk: int):
    """The byte ranges ``(a, b)`` that cover ``[0, nbytes)`` in order, each
    of at most ``chunk`` bytes; none for an empty array."""
    return [(a, min(a + chunk, nbytes)) for a in range(0, nbytes, chunk)]


class _Ring:
    """SLOTS pinned host buffers of CHUNK bytes for one CUDA device, each
    with the event of the last transfer out of it."""

    def __init__(self):
        self.slots = torch.empty((SLOTS, CHUNK), dtype=torch.uint8,
                                 pin_memory=True)
        self.done = [torch.cuda.Event() for _ in range(SLOTS)]
        self.next = 0
        self.lock = threading.Lock()

    def put(self, src: torch.Tensor, dst: torch.Tensor):
        """Copy the host bytes ``src`` into the device bytes ``dst`` (both
        flat uint8) chunk by chunk on the current stream: the host fills
        the next slot (span ``as_batch.host_copy``) while the transfers out
        of the slots before it run."""
        with self.lock:
            for a, b in chunk_plan(len(src), self.slots.shape[1]):
                i = self.next
                self.next = (i + 1) % len(self.done)
                if not self.done[i].query():
                    trace.count("h2d_staging_waits")
                    self.done[i].synchronize()
                slot = self.slots[i, :b - a]
                with trace.span("as_batch.host_copy"):
                    slot.copy_(src[a:b])
                dst[a:b].copy_(slot, non_blocking=True)
                self.done[i].record()


_rings: Dict[int, _Ring] = {}  # CUDA device index -> its ring
_rings_lock = threading.Lock()


def _ring(index: int) -> _Ring:
    with _rings_lock:
        if index not in _rings:
            _rings[index] = _Ring()
        return _rings[index]


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        # torch warns that a read-only array could be written through the
        # tensor; this one is only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


@trace.traced("pipeline.as_batch")
def as_batch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                         torch.Tensor]:
    """A numpy batch (e.g. from ``make_batch``) as tensors on ``device``,
    one array at a time. Counts the bytes put to the device
    (``h2d_bytes``), those of them from pageable memory
    (``h2d_pageable_bytes``) and those through the staging ring
    (``h2d_staged_bytes``).

    On a CUDA device each array goes through the device's pinned staging
    ring in chunks of at most CHUNK bytes, the host's copy of a chunk
    overlapping the transfer of the one before; the transfers and what
    follows them are queued on the current stream. ``h2d_staging_waits``
    counts the chunks whose slot was still being sent. Elsewhere each
    array is copied (span ``as_batch.host_copy``) and sent from pageable
    memory. Either way the host reads the arrays no more once the call
    returns."""
    device = torch.device(device)
    if device.type != "cuda":
        out = {}
        for k, v in batch.items():
            with trace.span("as_batch.host_copy"):
                host = torch.from_numpy(np.array(v))
            trace.count("h2d_bytes", host.nbytes)
            trace.count("h2d_pageable_bytes", host.nbytes)
            out[k] = host.to(device)
        return out
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = {}
    with torch.cuda.device(index):
        ring = _ring(index)
        for k, v in batch.items():
            v = np.asarray(v)
            src = _from_numpy(np.ascontiguousarray(v))
            dst = torch.empty(v.shape, dtype=src.dtype, device=device)
            ring.put(src.view(-1).view(torch.uint8),
                     dst.view(-1).view(torch.uint8))
            trace.count("h2d_bytes", dst.nbytes)
            trace.count("h2d_pageable_bytes", 0)
            trace.count("h2d_staged_bytes", dst.nbytes)
            out[k] = dst
    return out


def synthetic_batch(cfg: Config, batch_size: int, seed: int = 0,
                    device="cuda", with_pose: bool = False):
    """The JAX package's synthetic batch (smooth random frames, KITTI
    intrinsics) as tensors on ``device`` (the card unless the caller asks
    for the CPU)."""
    return as_batch(make_batch(cfg, batch_size, seed, with_pose), device)


def _models_ctx(cfg: Config, device: torch.device):
    if cfg.compute_dtype == "bfloat16" and device.type == "cuda":
        # autocast's cache of bf16 weights must stay out of a CUDA graph
        return torch.autocast(
            "cuda", dtype=torch.bfloat16,
            cache_enabled=not torch.cuda.is_current_stream_capturing())
    return contextlib.nullcontext()


@contextlib.contextmanager
def _frozen_stats(models):
    """Every BatchNorm of ``models`` keeps its running statistics as they
    are until the block ends: momentum 0 (the update ``(1 - m) * running +
    m * batch`` gives the running value back exactly) and no count (the
    ``num_batches_tracked`` buffer hidden). The call is otherwise the
    same, so it saves the same tensors for the backward (checkpoint's
    check)."""
    bns = [m for model in models.values() for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
           and m.training and m.track_running_stats]
    saved = [(m.momentum, m._buffers["num_batches_tracked"]) for m in bns]
    for m in bns:
        m.momentum = 0.0
        m._buffers["num_batches_tracked"] = None
    try:
        yield
    finally:
        for m, (momentum, count) in zip(bns, saved):
            m.momentum = momentum
            m._buffers["num_batches_tracked"] = count


def _checkpointed(models, fn, *args):
    """``fn(*args)``, rematerialized in the backward: non-reentrant
    ``torch.utils.checkpoint``, which keeps ``fn``'s inputs and outputs
    and runs ``fn`` again where the backward needs what it made. The
    recompute runs with the statistics of every BatchNorm of ``models``
    (those ``fn`` runs) frozen, so a rematerialized step leaves the
    running statistics as the plain step does (the JAX package's
    functional remat never updates them twice).
    Nothing inside draws from a generator, so no RNG state is kept (a
    CUDA graph's capture forbids reading it). ``fn`` enters the models'
    context itself: the recompute may run on another thread."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _frozen_stats(models)))


def _run(models, name, cfg: Config, x, remat: bool = False):
    """``models[name](x)``, called inside the models' context (the
    caller's); with ``remat`` rematerialized in the backward
    (:func:`_checkpointed`), whose recompute enters the context itself."""
    if not remat:
        return models[name](x)

    def fn(x):
        with _models_ctx(cfg, x.device):
            return models[name](x)
    return _checkpointed({name: models[name]}, fn, x)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def scale_intrinsics(K, scale: int):
    """K at pyramid level ``scale``: focal/principal rows divided by 2^s."""
    if scale == 0:
        return K
    K = K.clone()
    K[..., 0:2, :] *= 1.0 / (2 ** scale)
    return K


def _pose(models, color, f, cfg: Config, remat: bool = False):
    """PoseNet on the (frame f, reference) pair of ``color`` (B, F, H, W, 3),
    frames in ``cfg.frame_ids`` order: the 4x4 camera transform (B, 4, 4),
    inverted for a past frame. ``remat``: the encoder is rematerialized."""
    fid_to_idx = {g: i for i, g in enumerate(cfg.frame_ids)}
    pair = (color[:, fid_to_idx[f]], color[:, 0])
    if f > 0:
        pair = pair[::-1]
    with _models_ctx(cfg, color.device):
        feats = _run(models, "pose_encoder", cfg,
                     _nchw(torch.cat(pair, dim=-1)), remat)
        aa, tr = models["pose"]([feats])
    return transformation_from_parameters(aa[:, 0, 0].float(),
                                          tr[:, 0, 0].float(), invert=f < 0)


def predict_poses(models, color, cfg: Config):
    """Relative poses (B, M, 4, 4) of ``matching_ids[1:]`` from PoseNet on
    (frame, reference) pairs of ``color`` (B, F, H, W, 3), frames in
    ``cfg.frame_ids`` order."""
    return torch.stack([_pose(models, color, f, cfg)
                        for f in cfg.matching_ids[1:]], dim=1)


def poses_from_batch(batch, cfg: Config):
    """load_pose mode: the relative poses (B, M, 4, 4) of
    ``matching_ids[1:]`` come from the batch (``frame_ids[1:]`` order),
    not from PoseNet."""
    midx = [cfg.frame_ids[1:].index(f) for f in cfg.matching_ids[1:]]
    return batch["relative_pose"][:, midx]


def mvs_depth_from_features(models, ref_match, src_matches, depth_bins, K_p,
                            invK_p, rel, cfg: Config):
    """Cost volume -> Reg3D -> softmax -> localmax depth (inference; the
    frames fuse over the depth axis, as the reference's eval does).

    ref_match and each of src_matches: (B, C, h, w) FPN matching features.
    Returns (depth_mvs (B, h, w), cost_prob (B, D, h, w)). Reg3D, the
    softmax and the decode are the span ``infer.reg3d``.
    """
    h, w = depth_bins.shape[-2:]
    ref = ref_match.permute(0, 2, 3, 1).contiguous()  # NHWC for the kernel
    costs = []
    for f_idx, src in enumerate(src_matches):
        grid = sweep_grid(depth_bins, K_p, invK_p, rel[:, f_idx])
        sx, sy = grid_to_pixel(grid, h, w)
        costs.append(sweep_warp_corr(
            src.permute(0, 2, 3, 1).contiguous(), ref, sx.contiguous(),
            sy.contiguous(), cfg.reg3d_c))
    cor = fuse_frames(costs, weight_axis="depth")  # (B, D, h, w, G)
    with trace.span("infer.reg3d"):
        with _models_ctx(cfg, cor.device):
            logits = models["reg3d"](cor.permute(0, 4, 1, 2, 3))
        cost_prob = torch.softmax(logits.float(), dim=1)
        depth_mvs = localmax(cost_prob, cfg.norm_radius, cfg.num_depth_bins,
                             1.0 / depth_bins[:, -1], 1.0 / depth_bins[:, 0])
    return depth_mvs, cost_prob


def _mono(models, color0, cfg: Config, remat: bool = False):
    with _models_ctx(cfg, color0.device):
        disps = models["mono_depth"](
            _run(models, "mono_encoder", cfg, _nchw(color0), remat))
    return {k: v[:, 0].float() for k, v in disps.items()}  # (B, Hs, Ws)


@torch.no_grad()
def forward_infer(models, batch, cfg: Config):
    """Eval-protocol inference: mono disparity, MVS depth, cost probs.

    Raw frames, always-z-guided bins with a per-sample z-translation (the
    reference reads batch element 0 only), eval's depth-axis frame
    weighting. The batch carries only the matching frames, so frame
    indexing runs over ``matching_ids``. Spans: ``infer.mono`` (the mono
    encoder and decoder), ``infer.mvs`` (FPN4 through the cost volume,
    Reg3D and the decode).
    """
    cfg = cfg.replace(frame_ids=cfg.matching_ids)
    color = batch["color"]
    with trace.span("infer.mono"):
        disps = _mono(models, color[:, 0], cfg)

    if cfg.load_pose or "relative_pose" in batch:
        rel = poses_from_batch(batch, cfg)
    else:
        rel = predict_poses(models, color, cfg)

    with trace.span("infer.mvs"):
        # one FPN call over all frames (exact at inference: running BN
        # stats)
        b, m = color.shape[0], len(cfg.matching_ids)
        with _models_ctx(cfg, color.device):
            match_all, ctx_all = models["mvs_encoder"](
                _nchw(color[:, :m].reshape((b * m,) + color.shape[2:])))
        match_all = match_all.view((b, m) + match_all.shape[1:])
        ref_ctx = ctx_all.view((b, m) + ctx_all.shape[1:])[:, 0]

        _, depth_prior = disp_to_depth(disps[("disp", cfg.prior_scale)],
                                       cfg.min_depth, cfg.max_depth)
        z = cfg.z_scale * rel[:, 0, 2, 3]
        bins = schedule_depth_bins_z(depth_prior, cfg.num_depth_bins,
                                     cfg.depth_bin_fac, z[:, None, None],
                                     cfg.schedule_type)
        K_p = scale_intrinsics(batch["K"], cfg.prior_scale)
        depth_mvs, cost_prob = mvs_depth_from_features(
            models, match_all[:, 0], [match_all[:, i] for i in range(1, m)],
            bins, K_p, torch.linalg.inv(K_p), rel, cfg)

    if cfg.convex_up:
        with _models_ctx(cfg, color.device):
            up_mask = models["up"](ref_ctx)
        depth_mvs = convex_upsample(depth_mvs, up_mask.float(),
                                    cfg.prior_scale)
    scaled_disp_mono, _ = disp_to_depth(disps[("disp", 0)], cfg.min_depth,
                                        cfg.max_depth)
    return {
        "disp_mono": scaled_disp_mono,  # (B, H, W) scaled disparity
        "disp_mvs": 1.0 / depth_mvs,    # (B, H, W), or low-res without up
        "depth_mvs": depth_mvs,
        "cost_prob": cost_prob,         # (B, D, h, w)
    }


@torch.no_grad()
def forward_infer_fused(models, batch, cfg: Config):
    """forward_infer plus the learned mono/MVS blend: cost-volume entropy
    -> mask_cnn trust map -> blend at full resolution. Adds trust_mono,
    depth_fused and disp_fused, each (B, H, W)."""
    out = forward_infer(models, batch, cfg)
    h, w = batch["color"].shape[2:4]
    ent = entropy(out["cost_prob"], dim=1, keepdim=True)  # (B, 1, h, w)
    with _models_ctx(cfg, ent.device):
        trust = models["mask_cnn"](ent)
    trust_full = resize_bilinear(trust[:, 0].float(), (h, w),
                                 align_corners=True)
    depth_mvs = out["depth_mvs"]
    if depth_mvs.shape[-2:] != (h, w):  # convex_up off: bilinear
        depth_mvs = resize_bilinear(depth_mvs, (h, w), align_corners=True)
    mono_depth0 = 1.0 / out["disp_mono"]
    fused = (1.0 - trust_full) * depth_mvs + trust_full * mono_depth0
    return dict(out, trust_mono=trust_full, depth_fused=fused,
                disp_fused=1.0 / fused)


@torch.no_grad()
def forward_mono_infer(models, batch, cfg: Config):
    """Single-frame mono inference: scaled disparity and depth (B, H, W)."""
    disps = _mono(models, batch["color"][:, 0], cfg)
    scaled_disp, depth = disp_to_depth(disps[("disp", 0)], cfg.min_depth,
                                       cfg.max_depth)
    return {"disp_mono": scaled_disp, "depth_mono": depth}


# ------------------------------------------------------------------ training

def sample_draws(cfg: Config, batch_size: int, generator=None,
                 device="cuda", rank: int = 0, world_size: int = 1):
    """The randomness of one training forward: the masked-augmentation box
    (x0, y0), two 0-d tensors on ``device``, and the automask tiebreak
    noise, one (B, H, W, 1) standard
    normal map per mono scale (none with ``disable_automasking``) and one
    more with ``mask_mvs_auto``, in the order ``forward_train`` uses them.
    ``generator`` (torch's default one if None) must live on ``device``,
    the card unless the caller asks for the CPU.

    Data-parallel ranks seed their generators alike and draw for the
    global batch of ``world_size * batch_size`` rows: one box for all, and
    each rank keeps rows ``[rank * B, (rank + 1) * B)`` of the noise, so
    the ranks together take the draws of one process at the global
    batch."""
    h, w = cfg.height, cfg.width
    box = sample_box(h, w, (h // 3, w // 3), generator, device)
    n = (0 if cfg.disable_automasking else len(cfg.scales)) + int(
        cfg.mask_mvs_auto)
    noise = torch.randn((n, world_size * batch_size, h, w, 1),
                        generator=generator, device=device)
    rows = slice(rank * batch_size, (rank + 1) * batch_size)
    return {"box": box, "noise": list(noise[:, rows])}


def predict_train_poses(models, batch, cfg: Config, remat: bool = False):
    """Training poses: ({frame_id: cam_T_cam (B, 4, 4)} for every
    ``frame_ids[1:]`` frame, with a live gradient, and the detached
    relative poses (B, M, 4, 4) of ``matching_ids[1:]``). ``remat``: the
    pose encoder is rematerialized."""
    if cfg.load_pose:
        rel_all = batch["relative_pose"]
        cam_T_cam = {f: rel_all[:, i] for i, f in enumerate(cfg.frame_ids[1:])}
    else:
        cam_T_cam = {f: _pose(models, batch["color_aug"], f, cfg, remat)
                     for f in cfg.frame_ids[1:]}
    rel = torch.stack([cam_T_cam[f].detach() for f in cfg.matching_ids[1:]],
                      dim=1)
    return cam_T_cam, rel


def compute_depth_bins(disp_prior, rel, use_z_bins: bool, cfg: Config):
    """Depth hypotheses (B, D, h, w) around the detached mono prior: the
    z-guided schedule when ``use_z_bins`` (epoch > ztrans_start_epc), the
    plain one otherwise."""
    _, depth_prior = disp_to_depth(disp_prior, cfg.min_depth, cfg.max_depth)
    if use_z_bins:
        z = cfg.z_scale * rel[:, 0, 2, 3]
        return schedule_depth_bins_z(depth_prior, cfg.num_depth_bins,
                                     cfg.depth_bin_fac, z[:, None, None],
                                     cfg.schedule_type)
    return schedule_depth_bins(depth_prior, cfg.num_depth_bins,
                               cfg.depth_bin_fac, cfg.schedule_type)


def mvs_depth_two_pass(models, ref_a, ref_b, src_matches, depth_bins, K_p,
                       invK_p, rel, cfg: Config):
    """The main and the masked-augmentation cost volumes from ONE sweep
    warp per source frame: the warp depends only on the source features and
    the coordinates, so both reference features correlate with it. Each
    volume goes through Reg3D on its own (own batch statistics).

    ref_a, ref_b and each of src_matches: (B, C, h, w) FPN matching
    features. Returns (depth_a (B, h, w), cost_prob_a (B, D, h, w),
    depth_b (B, h, w)).
    """
    h, w = depth_bins.shape[-2:]
    ref_a = ref_a.permute(0, 2, 3, 1)[:, None]
    ref_b = ref_b.permute(0, 2, 3, 1)[:, None]
    costs_a, costs_b = [], []
    for f_idx, src in enumerate(src_matches):
        grid = sweep_grid(depth_bins, K_p, invK_p, rel[:, f_idx])
        sx, sy = grid_to_pixel(grid, h, w)
        warped = sweep_warp(src.permute(0, 2, 3, 1).contiguous(),
                            sx.contiguous(), sy.contiguous())
        costs_a.append(reduce_cost_groups(warped * ref_a, cfg.reg3d_c))
        costs_b.append(reduce_cost_groups(warped * ref_b, cfg.reg3d_c))
    out = []
    for costs in (costs_a, costs_b):
        cor = fuse_frames(costs, weight_axis="group")  # (B, D, h, w, G)
        with _models_ctx(cfg, cor.device):
            logits = models["reg3d"](cor.permute(0, 4, 1, 2, 3))
        cost_prob = torch.softmax(logits.float(), dim=1)
        depth = localmax(cost_prob, cfg.norm_radius, cfg.num_depth_bins,
                         1.0 / depth_bins[:, -1], 1.0 / depth_bins[:, 0])
        out.append((depth, cost_prob))
    return out[0][0], out[0][1], out[1][0]


def _multi_warp(src, grid, target=None):
    """Warp one source image (B, H, W, 3) by K grids (B, K, H, W, 2) in
    [-1, 1]: (B, K, H, W, 3), border mode, one kernel launch. With
    ``target`` (B, H, W, 3), (warped, l1 (B, K, H, W)) from the kernel's L1
    epilogue."""
    h, w = src.shape[1:3]
    sx, sy = grid_to_pixel(grid, h, w)
    return warp_images_border(src, sx.contiguous(), sy.contiguous(),
                              target=target)


def photometric_losses(disps, depth_mvs_full, fused_depth, batch, cam_T_cam,
                       cfg: Config, noise, mvs_mask=None, group=None,
                       remat: bool = False):
    """All reprojection losses, one multi-warp per source frame.

    The K = num_scales + 2 depth maps (mono scales, MVS, fused) are
    backprojected and warped together. Pose gradients flow through the
    mono scales only: the MVS and fused maps use the detached pose. With
    ``cfg.kernel_l1`` the L1 map comes from the warp's epilogue (on the
    card, the image-warp kernel's; on the CPU, its plain version) and SSIM
    still reads the warped stack; the losses are those of the torch tail.
    ``noise`` holds the automask tiebreaks in use order (``sample_draws``).
    With a process ``group`` the masked means run over the global batch
    (``ops.losses.masked_mean``). With ``remat`` each frame's block
    (backproject, project, warp, SSIM and L1) is rematerialized: only the
    depth maps and the poses are kept for the backward, and the warp runs
    again there. Returns (losses dict, {frame_id: warped scale-0 image}).
    """
    color = batch["color"]
    target = color[:, 0]
    b, h, w = target.shape[:3]
    K0, invK0 = batch["K"], batch["inv_K"]
    fid_to_idx = {f: i for i, f in enumerate(cfg.frame_ids)}
    nsc = cfg.num_scales
    k_all = nsc + 2
    noise = iter(noise)

    depth_scales = []
    for sc in cfg.scales:
        dfull = resize_bilinear(disps[("disp", sc)], (h, w),
                                align_corners=False)
        depth_scales.append(disp_to_depth(dfull, cfg.min_depth,
                                          cfg.max_depth)[1])
    depth_all = torch.stack(depth_scales + [depth_mvs_full, fused_depth],
                            dim=1)  # (B, K, H, W)

    def frame_block(depth_all, T_all, src, pts=None):
        """(reprojection (B, K, H, W, 1), L1 (B, K, H, W, 1), warped scale-0
        image) of one source frame; ``pts`` None: backprojected here, and
        the image is a copy (a view would keep the whole warped stack)."""
        own = pts is None
        if own:
            pts = backproject(depth_all, invK0[:, None])
        grid = project(pts, K0[:, None], T_all, h, w)  # (B, K, H, W, 2)
        if cfg.kernel_l1:
            warped, k_l1 = _multi_warp(src, grid, target=target)
        else:
            warped = _multi_warp(src, grid)
        wf = warped.reshape(b * k_all, h, w, 3)
        tf = target[:, None].expand(b, k_all, h, w, 3).reshape(wf.shape)
        if cfg.kernel_l1:
            l1 = k_l1.reshape(b * k_all, h, w, 1)
        else:
            l1 = torch.mean(torch.abs(tf - wf), dim=-1, keepdim=True)
        rp = l1
        if not cfg.no_ssim:
            sm = torch.mean(ssim(wf, tf), dim=-1, keepdim=True)
            rp = cfg.ssim_lw * sm + (1.0 - cfg.ssim_lw) * l1
        w0 = warped[:, 0]
        return (rp.view(b, k_all, h, w, 1), l1.view(b, k_all, h, w, 1),
                w0.clone() if own else w0)

    pts = None if remat else backproject(depth_all, invK0[:, None])
    mono_reproj, mvs_reproj, fuse_reproj, warped_log = [], [], [], {}
    for f in cfg.frame_ids[1:]:
        T_live = cam_T_cam[f]
        T_det = T_live.detach()
        T_all = torch.stack([T_live] * nsc + [T_det, T_det], dim=1)
        src = color[:, fid_to_idx[f]]
        if remat:
            rp, l1, warped_log[f] = _checkpointed({}, frame_block,
                                                  depth_all, T_all, src)
        else:
            rp, l1, warped_log[f] = frame_block(depth_all, T_all, src, pts)
        mono_reproj.append(rp[:, :nsc])
        mvs_reproj.append(rp[:, nsc])
        fuse_reproj.append(l1[:, nsc + 1])  # fuse: pure L1 (ssim_lw = 0)

    losses = {}
    # mono: per-scale min-reprojection + automask + smoothness
    ident = torch.cat([reprojection_loss(color[:, fid_to_idx[f]], target,
                                         cfg.ssim_lw, not cfg.no_ssim)
                       for f in cfg.frame_ids[1:]], dim=-1)
    if cfg.avg_reprojection:
        ident = torch.mean(ident, dim=-1, keepdim=True)
    total = 0.0
    for k, sc in enumerate(cfg.scales):
        reprojs = torch.cat([m[:, k] for m in mono_reproj], dim=-1)
        if cfg.avg_reprojection:
            reprojs = torch.mean(reprojs, dim=-1, keepdim=True)
        if not cfg.disable_automasking:
            reproj, mask = min_reprojection_with_automask(reprojs, ident,
                                                          next(noise))
        else:
            reproj = torch.amin(reprojs, dim=-1, keepdim=True)
            mask = torch.ones_like(reproj)
        rl = masked_mean(reproj, mask, group=group)
        disp = disps[("disp", sc)][..., None]
        color_s = target if sc == 0 else batch[f"color_pyr_{sc}"]
        mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
        sl = smooth_loss(disp / (mean_disp + 1e-7), color_s)
        losses[f"mono_smooth_loss/{sc}"] = sl
        scale_loss = rl + cfg.disparity_smoothness * sl / (2 ** sc)
        losses[f"loss/{sc}"] = scale_loss
        total = total + scale_loss
    losses["mono_loss"] = total / nsc

    # MVS: min over frames, optional conf/dist/geo masks (the reference's
    # MVS automask is overwritten with ones, so it is not computed)
    reproj = torch.amin(torch.cat(mvs_reproj, dim=-1), dim=-1, keepdim=True)
    mask = torch.ones_like(reproj) if mvs_mask is None else mvs_mask
    losses["mvs_reproj_loss"] = masked_mean(reproj, mask, group=group)
    mvs_total = losses["mvs_reproj_loss"]
    if cfg.mvs_smooth_loss:
        d = depth_mvs_full[..., None]
        mean_d = torch.mean(d, dim=(1, 2), keepdim=True)
        sl = smooth_loss(d / (mean_d + 1e-7), target)
        losses["mvs_smooth_loss/0"] = sl
        mvs_total = mvs_total + cfg.disparity_smoothness * sl
    losses["mvs_loss"] = mvs_total

    # fuse: pure L1, optional automask
    fuse_stack = torch.cat(fuse_reproj, dim=-1)
    if cfg.mask_mvs_auto:
        ident_l1 = torch.cat([reprojection_loss(color[:, fid_to_idx[f]],
                                                target, 0.0, not cfg.no_ssim)
                              for f in cfg.frame_ids[1:]], dim=-1)
        reproj, mask = min_reprojection_with_automask(fuse_stack, ident_l1,
                                                      next(noise))
    else:
        reproj = torch.amin(fuse_stack, dim=-1, keepdim=True)
        mask = torch.ones_like(reproj)
    losses["fuse_reproj_loss"] = masked_mean(reproj, mask,
                                              group=group)
    return losses, warped_log


def compute_mvs_masks(cost_prob, disp0, batch, cam_T_cam, depth_mvs_full,
                      cfg: Config):
    """Optional MVS-loss masks, (B, H, W, 1) float, or None when every flag
    is off. conf: the depth-slice-wise bilinearly upsampled probability
    volume's max over D > photo_conf; dist: full-resolution mono disparity
    > dist_thres; geo: forward-backward consistency per source frame."""
    if not (cfg.mask_mvs_conf or cfg.mask_mvs_dist or cfg.mask_mvs_geo):
        return None
    h, w = cfg.height, cfg.width
    mask = torch.ones((batch["color"].shape[0], h, w, 1),
                      device=cost_prob.device)
    if cfg.mask_mvs_conf:
        up = resize_bilinear(cost_prob, (h, w), align_corners=True)
        mask = mask * (torch.amax(up, dim=1)[..., None] > cfg.photo_conf)
    if cfg.mask_mvs_dist:
        mask = mask * (disp0[..., None] > cfg.dist_thres)
    if cfg.mask_mvs_geo:
        for f in cfg.frame_ids[1:]:
            geo = geometric_consistency_mask(
                depth_mvs_full, batch["K"], cam_T_cam[f].detach(),
                depth_mvs_full, batch["K"], cfg.pixel_thres, cfg.depth_thres)
            mask = mask * geo[..., None]
    return mask


def remat_gate(batch_size: int, cfg: Config, train: bool = True):
    """(heavy, heavy_enc) of a forward at ``batch_size`` rows: the JAX
    package's ``heavy = train and b > remat_batch_threshold`` and
    ``heavy_enc = heavy and remat_scope == "full"``. An unknown scope
    raises."""
    if cfg.remat_scope not in ("full", "mvs"):
        raise ValueError(f"remat_scope {cfg.remat_scope!r}: 'full' or 'mvs'")
    heavy = train and batch_size > cfg.remat_batch_threshold
    return heavy, heavy and cfg.remat_scope == "full"


def forward_train(models, batch, cfg: Config, use_z_bins: bool, draws,
                  group=None):
    """The training forward: every model, both cost-volume passes and all
    losses, with the JAX package's stop-gradients (the relative poses, the
    detached pose of the MVS and fused warps, the depth prior, both inputs
    of the fused depth).

    The models' mode (train or eval) is the caller's; ``draws`` comes from
    :func:`sample_draws`. The three FPN calls (reference, source, masked
    reference) stay separate: in training each normalizes with its own
    batch statistics. With a process ``group`` (data-parallel training:
    ``batch`` and ``draws`` hold this rank's rows) the masked means run
    over the global batch; the BatchNorms do where the models carry
    ``parallel.sync_bn.SyncBatchNorm``. Returns (total loss, losses dict,
    outputs dict); the losses dict has the JAX package's keys. The MVS
    masks and the photometric losses are the span ``train.losses``.

    Rematerialization, the JAX package's gate: in training (models in
    train mode, gradients on) with more than ``cfg.remat_batch_threshold``
    rows (this rank's), ``heavy`` rematerializes the MVS trunk (both cost
    volumes, Reg3D, softmax and decode) and the photometric frame blocks;
    with ``remat_scope`` "full" also ``heavy_enc``: the pose, matching and
    mono encoders (not the decoders). The losses and gradients are the
    plain step's, and so are the BatchNorm running statistics
    (:func:`_checkpointed`).
    """
    color_aug = batch["color_aug"]
    h, w = cfg.height, cfg.width
    fid_to_idx = {f: i for i, f in enumerate(cfg.frame_ids)}
    dev = color_aug.device
    # training: the models in train mode, gradients on
    heavy, heavy_enc = remat_gate(
        color_aug.shape[0], cfg,
        torch.is_grad_enabled() and models["mvs_encoder"].training)

    cam_T_cam, rel = predict_train_poses(models, batch, cfg, heavy_enc)

    with _models_ctx(cfg, dev):
        ref_match, ref_ctx = _run(models, "mvs_encoder", cfg,
                                  _nchw(color_aug[:, 0]), heavy_enc)
        src_matches = [
            _run(models, "mvs_encoder", cfg,
                 _nchw(color_aug[:, fid_to_idx[f]]), heavy_enc)[0]
            for f in cfg.matching_ids[1:]]
    disps = _mono(models, color_aug[:, 0], cfg, heavy_enc)

    disp0_full = resize_bilinear(disps[("disp", 0)], (h, w),
                                 align_corners=False)
    _, mono_depth0 = disp_to_depth(disp0_full, cfg.min_depth, cfg.max_depth)

    bins = compute_depth_bins(disps[("disp", cfg.prior_scale)].detach(), rel,
                              use_z_bins, cfg)
    K_p = scale_intrinsics(batch["K"], cfg.prior_scale)

    masked_img, aug_mask = random_image_mask(color_aug[:, 0],
                                             (h // 3, w // 3), draws["box"])
    with _models_ctx(cfg, dev):
        ref_aug, _ = _run(models, "mvs_encoder", cfg, _nchw(masked_img),
                          heavy_enc)
    # inv_ex: linalg.inv reads its error flag on the host, which a CUDA
    # graph's capture forbids
    trunk_args = (models, ref_match, ref_aug, src_matches, bins, K_p,
                  torch.linalg.inv_ex(K_p).inverse, rel, cfg)
    depth_mvs, cost_prob, depth_mvs_aug = (
        _checkpointed({"reg3d": models["reg3d"]}, mvs_depth_two_pass,
                      *trunk_args) if heavy
        else mvs_depth_two_pass(*trunk_args))
    with _models_ctx(cfg, dev):
        trust_mono = models["mask_cnn"](entropy(cost_prob, dim=1,
                                                keepdim=True))
    low_mask = resize_bilinear(_nchw(aug_mask), depth_mvs_aug.shape[1:],
                               align_corners=True)
    low_mask = (low_mask.sum(dim=1) > 0).to(depth_mvs.dtype)
    diff = torch.abs(depth_mvs_aug - depth_mvs)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    # the reference weights the masked loss by mask_lw twice
    masked_loss = (masked_mean(sl1, low_mask, group=group)
                   * cfg.mask_lw ** 2)

    if cfg.convex_up:
        with _models_ctx(cfg, dev):
            up_mask = models["up"](ref_ctx)
        depth_mvs_full = convex_upsample(depth_mvs, up_mask.float(),
                                         cfg.prior_scale)
    else:
        depth_mvs_full = resize_bilinear(depth_mvs, (h, w),
                                         align_corners=True)

    # fusion: only mask_cnn gets a gradient
    trust_full = resize_bilinear(trust_mono[:, 0].float(), (h, w),
                                 align_corners=True)
    fused = ((1.0 - trust_full) * depth_mvs_full.detach()
             + trust_full * mono_depth0.detach())

    with trace.span("train.losses"):
        mvs_mask = compute_mvs_masks(cost_prob, disp0_full, batch,
                                     cam_T_cam, depth_mvs_full, cfg)
        losses, warped_log = photometric_losses(
            disps, depth_mvs_full, fused, batch, cam_T_cam, cfg,
            draws["noise"], mvs_mask=mvs_mask, group=group, remat=heavy)
    losses["masked_loss"] = masked_loss
    total = (losses["mono_loss"] + losses["masked_loss"]
             + losses["mvs_loss"] + losses["fuse_reproj_loss"])
    losses["loss"] = total
    outputs = {
        "disp_0": disps[("disp", 0)],
        "depth_mono": mono_depth0,
        "depth_mvs": depth_mvs_full,
        "trust_mono_mask": trust_full,
        "fused_depth": fused,
        "warped": warped_log,
        "cam_T_cam": cam_T_cam,
    }
    return total, losses, outputs
