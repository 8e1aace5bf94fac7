"""Online depth from one camera: a closed loop over the consecutive frames
of one synthetic drive, one frame at a time.

Each unit is the serving entry's step (``cli/infer.run``): the frame and
the one before it stacked into a batch of one, ``pipeline.as_batch``,
``pipeline.forward_infer_fused``, and the fused depth to the host. A
frame's latency runs from the stacking to the depth on the host. Traffic
parameters: ``batch`` (1), ``drive_frames`` (the drive's length; the loop
walks it and starts over), ``warmup``, ``samples`` (frames checked, drawn
from the seed among the window's first ``sample_within``),
``trace_units``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from mdbench import build, check, inputs
from mdbench.reference import pipeline as RP
from mdbench.reference import precision


def setup(run):
    from movedepth_tpu_torch import pipeline as P
    t = run.traffic
    cfg = build.program_config(run)
    wts = build.weights(run, "infer")
    gen = inputs.generator(run.seed, run.device, 2)
    drive = inputs.drives(1, t["drive_frames"], cfg.height, cfg.width, gen,
                          run.device)[0].cpu().numpy()
    K = inputs.kitti_K(cfg.height, cfg.width)
    rng = np.random.default_rng(run.seed)
    state = SimpleNamespace(
        P=P, cfg=cfg, weights=wts, drive=list(drive), K=K[None],
        inv_K=np.linalg.inv(K)[None], sampled={},
        models=build.program_models(run, cfg, wts),
        sample_at=set(rng.choice(t["sample_within"], t["samples"],
                                 replace=False).tolist()))
    run.stage("models built, drive made")
    for i in range(t["warmup"]):
        unit(run, state, i)
    return state


def _frames(state, i):
    """The i-th pair of the loop: (frame t, frame t - 1) of the drive."""
    t = 1 + i % (len(state.drive) - 1)
    return state.drive[t], state.drive[t - 1]


def unit(run, state, i):
    P = state.P
    t0 = time.perf_counter()
    with record_function("mdbench.put"):
        color = np.stack(_frames(state, i))[None]
        batch = P.as_batch({"color": color, "K": state.K,
                            "inv_K": state.inv_K}, run.device)
    t1 = time.perf_counter()
    with record_function("mdbench.forward"):
        out = P.forward_infer_fused(state.models, batch, state.cfg)
    t2 = time.perf_counter()
    with record_function("mdbench.readback"):
        out["depth_fused"][0].float().cpu().numpy()
    t3 = time.perf_counter()
    if run.recording:
        run.latencies_ms.append((t3 - t0) * 1e3)
        run.span("issue_ms", (t2 - t1) * 1e3)
        run.items += 1
        if i in state.sample_at:
            state.sampled[i] = out


def drain(run, state):
    pass  # every unit ends on the host


def compare(run, state, control):
    """Each sampled frame against the reference; with ``control`` the
    reference at fp8 stands in for the program."""
    sampled = state.sampled
    build.free("models", state=state)
    ref = state.ref = build.reference_models(run, state.weights)
    errors, stats, bad = [], {}, 0
    for i, out in sorted(sampled.items()):
        color = torch.from_numpy(np.stack(_frames(state, i))[None]).to(
            run.device)
        K = torch.from_numpy(state.K).to(run.device)
        with RP.float32():
            want = RP.forward_infer_fused(ref, color, K, run.ref_cfg, stats)
            if control:
                with precision.fp8(run.device):
                    out = RP.forward_infer_fused(ref, color, K, run.ref_cfg)
        bad += check.nonfinite_frames(out)
        errors.append(check.frame_errors(out, want))
    if not errors:
        return {}, run.items, 0
    run.notes.append(f"plane-sweep samples inside the source frame: "
                     f"{np.mean(stats['in_frame']):.4f} over "
                     f"{len(errors)} checked frames")
    return check.worst_frames(errors), run.items, bad


def flops_per_item(run, state):
    """Model FLOPs of one frame's forward, counted on the reference."""
    color = torch.from_numpy(np.stack(_frames(state, 0))[None]).to(run.device)
    K = torch.from_numpy(state.K).to(run.device)
    with RP.float32():
        return build.flops(lambda: RP.forward_infer_fused(
            state.ref, color, K, run.ref_cfg))
