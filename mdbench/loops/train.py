"""Self-supervised training: the trainer's step in a loop, eager.

Each unit is ``Trainer._single_step`` without its logging: the host
batch to the device key by key (``Trainer._put``), the draws of the
masked augmentation and the automask tiebreaks made from the run's seed,
and ``train.state.train_step`` at z-guided bins. No unit waits for the
device; the losses are read once, after the window. cuDNN's autotuning is
set as the trainer sets it. Set-up builds the models and the optimizer
and takes the first ``checked_steps`` steps through the same unit, on
distinct batches: those steps warm every shape up and are the ones the
reference follows. Traffic parameters: ``batch``, ``pool`` (distinct host
batches, cycled; at least ``checked_steps``), ``checked_steps``,
``trace_units``.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from mdbench import build, check, inputs
from mdbench.reference import pipeline as RP
from mdbench.reference import precision


def _leaves(models):
    """Leaf name -> parameter, over every model, in a fixed order."""
    return {f"{name}.{k}": p for name in sorted(models)
            for k, p in models[name].named_parameters()}


def _norms(tensors):
    """name -> float norm, read from the device once."""
    names = list(tensors)
    vals = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, vals.cpu().tolist()))


def setup(run):
    from movedepth_tpu_torch import pipeline as P
    from movedepth_tpu_torch.train import state as S
    t = run.traffic
    cfg = build.program_config(run)
    if torch.device(run.device).type == "cuda":
        # as Trainer.__init__: cuDNN times its algorithms unless the step
        # is rematerialized
        torch.backends.cudnn.benchmark = not P.remat_gate(t["batch"], cfg)[0]
    wts = build.weights(run, "train")
    models = build.program_models(run, cfg, wts)
    opt, sched = S.create_optimizer(models, cfg)
    run.stage("models and optimizer built")
    gen = inputs.generator(run.seed, run.device, 2)
    state = SimpleNamespace(
        S=S, cfg=cfg, weights=wts, models=models, opt=opt, sched=sched,
        pool=[inputs.train_batch(t["batch"], cfg.height, cfg.width, gen,
                                 run.device) for _ in range(t["pool"])],
        gen=inputs.generator(run.seed, run.device, 3), losses=[],
        checked_draws=[], offset=0)
    run.stage("host batches made")
    n = int(t["checked_steps"])
    if n > len(state.pool):
        raise ValueError("the checked steps need distinct batches")
    leaves = _leaves(models)
    start = {k: p.detach().clone() for k, p in leaves.items()}
    for i in range(n):
        draws = unit(run, state, i)
        state.checked_draws.append(
            {"box": tuple(v.clone() for v in draws["box"]),
             "noise": [x.clone() for x in draws["noise"]]})
        if i == 0:  # Adam's first moment after one step is 0.1 * gradient
            first = _norms({k: opt.state[p]["exp_avg"] / 0.1
                            if "exp_avg" in opt.state.get(p, {})
                            else torch.zeros_like(p)
                            for k, p in leaves.items()})
    state.prog = {
        "losses": torch.stack(state.losses).cpu().tolist(),
        "grad": first,
        "change": _norms({k: p - start[k] for k, p in leaves.items()})}
    run.stage("checked steps taken")
    state.losses, state.offset = [], n
    return state


def unit(run, state, i):
    cfg, t = state.cfg, run.traffic
    host = state.pool[(i + state.offset) % len(state.pool)]
    with record_function("mdbench.put"):
        batch = {k: torch.from_numpy(v).to(run.device)
                 for k, v in host.items()}
    draws = inputs.draws(t["batch"], cfg.height, cfg.width, len(cfg.scales),
                         state.gen, run.device)
    with record_function("mdbench.step"):
        losses, _ = state.S.train_step(state.models, state.opt, state.sched,
                                       batch, cfg, True, draws)
    state.losses.append(losses["loss"])
    if run.recording:
        run.items += t["batch"]
    return draws


def drain(run, state):
    """At the window's end: read its losses (one transfer) and count the
    steps whose loss is not finite."""
    if run.recording and state.losses:
        vals = torch.stack(state.losses).float()
        state.nonfinite = int((~torch.isfinite(vals)).sum())


def _reference_steps(run, state, lower=False):
    """The reference's readings over the checked steps from the same
    weights, batches and draws: losses, first gradient and change by
    leaf; ``lower``: the forward at fp8 (the control; its backward takes
    the forward's results as they were held)."""
    models = build.reference_models(run, state.weights)
    for m in models.values():
        m.train()
    adam = RP.Adam(models, run.ref_cfg)
    leaves = _leaves(models)
    start = {k: p.detach().clone() for k, p in leaves.items()}
    losses = []
    for i, draws in enumerate(state.checked_draws):
        batch = {k: torch.from_numpy(v).to(run.device)
                 for k, v in state.pool[i].items()}
        with RP.float32():
            with (precision.fp8(run.device) if lower
                  else contextlib.nullcontext()):
                total, _ = RP.forward_train(models, batch, run.ref_cfg,
                                            draws)
            total.backward()
        if i == 0:
            grad = _norms({k: p.grad for k, p in leaves.items()})
        adam.step()
        for p in leaves.values():
            p.grad = None
        losses.append(float(total.detach()))
    change = _norms({k: p - start[k] for k, p in leaves.items()})
    return {"losses": losses, "grad": grad, "change": change}, models


def compare(run, state, control):
    """The checked steps against the reference; with ``control`` the
    reference at fp8 stands in for the program."""
    attempted = run.units
    failed = getattr(state, "nonfinite", 0)
    build.free("models", "opt", "sched", "losses", state=state)
    want, state.ref = _reference_steps(run, state)
    got = state.prog
    if control:
        got, _ = _reference_steps(run, state, lower=True)
    for key in ("grad", "change"):
        g, w = got[key], want[key]
        med = sorted(w.values())[len(w) // 2]
        worst = sorted(w, key=lambda k: -abs(g[k] - w[k]) / max(w[k], med,
                                                                  1e-30))[:3]
        run.notes.append(f"worst {key} leaves (program, reference): "
                         + "; ".join(f"{k} {g[k]:.4g} {w[k]:.4g}"
                                     for k in worst))
    return check.train_numbers(got, want), attempted, failed


def flops_per_item(run, state):
    """Model FLOPs of one example's forward and backward (no recompute),
    counted on the reference at batch 1."""
    batch = {k: torch.from_numpy(v[:1]).to(run.device)
             for k, v in state.pool[0].items()}
    d = state.checked_draws[0]
    draws = {"box": d["box"], "noise": [x[:1] for x in d["noise"]]}

    def step():
        total, _ = RP.forward_train(state.ref, batch, run.ref_cfg, draws)
        total.backward()

    with RP.float32():
        n = build.flops(step)
    for m in state.ref.values():
        m.zero_grad(set_to_none=True)
    return n
