"""Offline labeling of recorded drives: a closed loop over host batches.

Each unit is one batch as the evaluation entry runs it: the eval loader's
float32 NumPy batch (frames 0 and -1, K, inv_K) to the device with
``pipeline.as_batch``, ``pipeline.forward_infer_fused``, and the mono, MVS
and fused disparities back to the host as ``eval.evaluate._disparities``
reads them (without the flip). cuDNN's settings stay as the evaluation
entry leaves them. Traffic parameters: ``batch``, ``pool`` (distinct host
batches, cycled), ``warmup`` (units before the window), ``sample_within``
(the checked batch is one of the window's first units, drawn from the
seed), ``ref_block`` (rows per reference call), ``trace_units``.
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
    state = SimpleNamespace(P=P, cfg=cfg, weights=wts, sample=None,
                            last=None,
                            models=build.program_models(run, cfg, wts))
    run.stage("models built and loaded")
    gen = inputs.generator(run.seed, run.device, 2)
    state.pool = [inputs.infer_batch(t["batch"], cfg.height, cfg.width, gen,
                                     run.device) for _ in range(t["pool"])]
    state.sample_at = int(np.random.default_rng(run.seed).integers(
        t["sample_within"]))
    run.stage("host batches made")
    for i in range(t["warmup"]):
        unit(run, state, i)
    return state


def unit(run, state, i):
    P, host = state.P, state.pool[i % len(state.pool)]
    t0 = time.perf_counter()
    with record_function("mdbench.put"):
        batch = P.as_batch(host, run.device)
    run.span("put_ms", (time.perf_counter() - t0) * 1e3)
    with record_function("mdbench.forward"):
        out = P.forward_infer_fused(state.models, batch, state.cfg)
    with record_function("mdbench.readback"):
        torch.stack([out["disp_mono"].float(), 1.0 / out["depth_mvs"].float(),
                     out["disp_fused"].float()]).cpu().numpy()
    if run.recording:
        run.items += len(host["color"])
        state.last = (host, out)
        if i == state.sample_at:
            state.sample = (host, out)


def drain(run, state):
    pass  # every unit ends on the host


def compare(run, state, control):
    """Every frame of the checked batch against the reference, in blocks
    of rows; with ``control`` the reference at fp8 stands in for the
    program."""
    host, out = state.sample = state.sample or state.last
    build.free("models", "pool", "last", state=state)
    ref = build.reference_models(run, state.weights)
    state.ref = ref
    color = torch.from_numpy(host["color"]).to(run.device)
    K = torch.from_numpy(host["K"]).to(run.device)
    errors, stats, bad = [], {}, 0
    step = int(run.traffic["ref_block"])
    for s in range(0, len(color), step):
        with RP.float32():
            want = RP.forward_infer_fused(ref, color[s:s + step],
                                          K[s:s + step], run.ref_cfg, stats)
            if control:
                with precision.fp8(run.device):
                    got = RP.forward_infer_fused(ref, color[s:s + step],
                                                 K[s:s + step], run.ref_cfg)
            else:
                got = {k: v[s:s + step] for k, v in out.items()}
        bad += check.nonfinite_frames(got)
        errors.append(check.frame_errors(got, want))
    run.notes.append(f"plane-sweep samples inside the source frame: "
                     f"{np.mean(stats['in_frame']):.4f} of the checked "
                     f"batch")
    return check.worst_frames(errors), run.items, bad


def flops_per_item(run, state):
    """Model FLOPs of one frame's forward, counted on the reference."""
    h = state.sample[0]
    color = torch.from_numpy(h["color"][:1]).to(run.device)
    K = torch.from_numpy(h["K"][:1]).to(run.device)
    with RP.float32():
        return build.flops(lambda: RP.forward_infer_fused(
            state.ref, color, K, run.ref_cfg))
