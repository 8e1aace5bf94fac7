"""Optimizer, learning-rate schedule, the train step and the multi-step
dispatch (port of movedepth_tpu/train/state.py).

Adam with two learning-rate groups: the MVS group (mask_cnn, mvs_encoder,
reg3d) runs at ``learning_rate * lr_fac``, the rest at ``learning_rate``.
The rate drops x0.1 every ``scheduler_step_size`` epochs before
``num_epochs``, counted in optimizer steps, as the JAX package's optax
piecewise-constant schedule does. Each group's rate is a 0-d tensor on the
parameters' device that :class:`StepSchedule` overwrites in place, and on
the card Adam is ``capturable``: one train step can then be captured as a
CUDA graph, which is how :func:`make_train_multistep` ports the JAX
package's multi-step scan (``steps_per_dispatch``); a rematerialized step
(``remat_batch_threshold``, pipeline.py) captures too. The XLA-only levers
of the JAX package (compiler options, scoped-VMEM limits) have no
counterpart.
"""

from __future__ import annotations

import bisect
from typing import Dict

import torch
import torch.distributed as dist

from movedepth_tpu_torch import trace
from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.parallel.dist import all_reduce_grads
from movedepth_tpu_torch.pipeline import forward_train

# the models updated at learning_rate * lr_fac (the JAX package's MVS_GROUP)
MVS_GROUP = ("mask_cnn", "mvs_encoder", "reg3d")
# eager steps before a capture (PyTorch's whole-network capture recipe):
# cuDNN's autotuning, Adam's state and NCCL's communicators exist by then
WARMUP_STEPS = 3


def lr_milestones(cfg: Config, steps_per_epoch: int):
    """Optimizer steps at which the learning rate drops x0.1."""
    step = cfg.scheduler_step_size
    return [e * steps_per_epoch for e in range(step, cfg.num_epochs, step)]


class StepSchedule:
    """Each of the optimizer's groups at its base rate times ``gamma`` per
    milestone passed, at optimizer step ``last_epoch``; call ``step()``
    after each optimizer step. The rate is a float on the host, written
    into the group's lr tensor in place (``fill_``: no read of the device),
    so that a captured Adam reads the new rate on its next replay."""

    def __init__(self, optimizer, base_lrs, milestones, gamma: float = 0.1):
        self.optimizer = optimizer
        self.base_lrs = [float(r) for r in base_lrs]
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.lrs = [g["lr"] for g in optimizer.param_groups]
        self.last_epoch = 0

    def rates(self, step: int):
        drops = bisect.bisect_right(self.milestones, step)
        return [base * self.gamma ** drops for base in self.base_lrs]

    def set_step(self, step: int):
        """The rates of optimizer step ``step`` under the milestones, as a
        run that took ``step`` steps has them (a resume). A loaded
        optimizer state may have put other lr objects in the groups: the
        schedule's own tensors go back in."""
        self.last_epoch = step
        for group, lr, rate in zip(self.optimizer.param_groups, self.lrs,
                                   self.rates(step)):
            group["lr"] = lr
            lr.fill_(rate)

    def step(self):
        self.set_step(self.last_epoch + 1)

    def state_dict(self):
        return {"base_lrs": self.base_lrs, "milestones": self.milestones,
                "gamma": self.gamma, "last_epoch": self.last_epoch}


def create_optimizer(models: Dict[str, torch.nn.Module], cfg: Config,
                     steps_per_epoch: int = 1000):
    """(Adam over every model's parameters in the two groups, its
    step-based :class:`StepSchedule`). Each group's rate is a float32 0-d
    tensor on the parameters' device; on the card Adam is ``capturable``
    (its step count and bias corrections stay on the device). Adam's
    moments take each parameter's type, bfloat16 with ``param_dtype``
    "bfloat16", as optax's do. Call the schedule's ``step()`` after each
    optimizer step."""
    device = next(p.device for m in models.values() for p in m.parameters())
    rates = (cfg.learning_rate, cfg.learning_rate * cfg.lr_fac)
    groups = [
        {"params": [p for name in sorted(models) if (name in MVS_GROUP) == mvs
                    for p in models[name].parameters()],
         "lr": torch.tensor(rate, dtype=torch.float32, device=device)}
        for mvs, rate in zip((False, True), rates)]
    optimizer = torch.optim.Adam(groups, lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 capturable=device.type == "cuda")
    return optimizer, StepSchedule(optimizer, rates,
                                   lr_milestones(cfg, steps_per_epoch))


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def _step_body(models, optimizer, batch, cfg, use_z_bins, draws, group,
               check_grads=True):
    """forward_train, backward, the gradient all-reduce, Adam: the part of
    a step that a CUDA graph captures (``check_grads=False``: the
    all-reduce's host check of which gradients exist stays out). Each
    phase is a span: ``train.forward``, ``train.backward``,
    ``train.all_reduce``, ``train.optimizer``."""
    with trace.span("train.forward"):
        total, losses, outputs = forward_train(models, batch, cfg,
                                               use_z_bins, draws, group)
    with trace.span("train.backward"):
        total.backward()
    if group is not None:
        with trace.span("train.all_reduce"):
            all_reduce_grads(models, group, check_grads)
    with trace.span("train.optimizer"):
        optimizer.step()
    return losses, outputs


@trace.traced("train.step")
def train_step(models, optimizer, schedule, batch, cfg: Config,
               use_z_bins: bool, draws, group=None):
    """One optimizer step: the models in train mode, ``forward_train``,
    ``backward()``, Adam, the schedule. The gradients of this step stay in
    each parameter's ``.grad`` until the next step. With a process
    ``group`` (data-parallel training: ``batch`` and ``draws`` hold this
    rank's rows) the masked means cover the global batch and the gradients
    are averaged over the ranks before Adam, so every rank takes the step
    of one process at the global batch. Returns (the losses dict, the
    outputs dict), detached. The whole call is the span ``train.step``."""
    for m in models.values():
        m.train()
    optimizer.zero_grad(set_to_none=True)
    losses, outputs = _step_body(models, optimizer, batch, cfg, use_z_bins,
                                 draws, group)
    schedule.step()
    return _detached(losses), _detached(outputs)


def _copy_in(dst, src):
    """Copy a step's input into a graph's static buffer on the device."""
    if not isinstance(src, torch.Tensor):
        dst.fill_(src)
        return
    if src.shape != dst.shape:
        raise ValueError(f"a captured step takes {tuple(dst.shape)}; got "
                         f"{tuple(src.shape)}")
    dst.copy_(src)


def _static_draws(draws, device):
    return {"box": tuple(torch.as_tensor(v, device=device).clone()
                         for v in draws["box"]),
            "noise": [n.clone() for n in draws["noise"]]}


class _StepGraph:
    """One train step captured as a CUDA graph: its static inputs (a batch
    and its draws), the stacked losses it writes, the gradients it owns,
    and what the tracer's counters count in one replay (``counts``, read
    at capture, taken back off the counters then and added per replay:
    the kernel wrappers and the all-reduce count in Python, which a
    replay does not run)."""

    def __init__(self, models, optimizer, cfg, use_z_bins, group, batch,
                 draws, stream):
        device = batch["color"].device
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.draws = _static_draws(draws, device)
        self.params = [p for name in sorted(models)
                       for p in models[name].parameters()]
        optimizer.zero_grad(set_to_none=True)  # backward allocates in the pool
        before = trace.counters()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                losses, _ = _step_body(models, optimizer, self.batch, cfg,
                                       use_z_bins, self.draws, group,
                                       check_grads=False)
                self.keys = list(losses)
                self.losses = torch.stack([losses[k].detach().float()
                                           for k in self.keys])
        finally:
            self.counts = {k: n - before.get(k, 0)
                           for k, n in trace.counters().items()
                           if n != before.get(k, 0)}
            for k, n in self.counts.items():
                trace.count(k, -n)
        self.grads = [p.grad for p in self.params]

    def replay(self, batch, draws):
        """One step on ``batch`` and ``draws``: copy them in, replay.
        Returns the losses (len(keys),) on the device."""
        for k, dst in self.batch.items():
            _copy_in(dst, batch[k])
        for dst, src in zip(self.draws["box"], draws["box"]):
            _copy_in(dst, src)
        if len(draws["noise"]) != len(self.draws["noise"]):
            raise ValueError("the draws do not match the captured step's")
        for dst, src in zip(self.draws["noise"], draws["noise"]):
            _copy_in(dst, src)
        self.graph.replay()
        for k, n in self.counts.items():
            trace.count(k, n)
        return self.losses.clone()

    def restore_grads(self):
        """Point each parameter's ``.grad`` at the graph's gradients (an
        eager step in between may have replaced them)."""
        for p, g in zip(self.params, self.grads):
            p.grad = g


class _TrainMultistep:
    """K train steps per call: ``(batches, draws, use_z_bins) -> losses``,
    each loss stacked (K,) on the device, the steps exactly K sequential
    :func:`train_step` calls on the same batches and draws (the image
    outputs are not materialized).

    On the card one step is captured as a CUDA graph, once per value of
    ``use_z_bins`` (the graph of the other value is dropped), and each call
    copies every batch and its draws into the graph's static inputs and
    replays it, with the schedule's rate written in between: no host read
    of the device inside a call. Before the capture, WARMUP_STEPS eager
    steps on the first batch run on the capture's side stream and the
    models, their statistics and Adam's state are put back as they were, so
    they take no step. A step that cannot be captured raises; the card
    never falls back to eager steps. On the CPU a call is K eager
    :func:`train_step` calls."""

    def __init__(self, models, optimizer, schedule, cfg: Config, group=None):
        self.models, self.optimizer = models, optimizer
        self.schedule, self.cfg, self.group = schedule, cfg, group
        self.device = next(p.device for m in models.values()
                           for p in m.parameters())
        self.graphs: Dict[bool, _StepGraph] = {}
        self.stream = None
        if self.device.type == "cuda":
            if group is not None and dist.get_backend(group) != "nccl":
                raise ValueError(
                    "steps_per_dispatch > 1 on the card captures the step as "
                    "a CUDA graph, which needs an nccl group: gloo "
                    f"collectives cannot be captured (got "
                    f"{dist.get_backend(group)})")
            self.stream = torch.cuda.Stream(self.device)

    def __call__(self, batches, draws, use_z_bins: bool):
        if len(batches) != len(draws):
            raise ValueError(f"{len(batches)} batches, {len(draws)} draws")
        if self.device.type != "cuda":
            steps = [train_step(self.models, self.optimizer, self.schedule,
                                b, self.cfg, use_z_bins, d, self.group)[0]
                     for b, d in zip(batches, draws)]
            return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        use_z_bins = bool(use_z_bins)
        for m in self.models.values():
            m.train()
        graph = self.graphs.get(use_z_bins)
        if graph is None:
            self.graphs.clear()
            self._warm_up(batches[0], draws[0], use_z_bins)
            graph = self.graphs[use_z_bins] = _StepGraph(
                self.models, self.optimizer, self.cfg, use_z_bins,
                self.group, batches[0], draws[0], self.stream)
        rows = []
        for batch, draw in zip(batches, draws):
            rows.append(graph.replay(batch, draw))
            self.schedule.step()
        graph.restore_grads()
        stacked = torch.stack(rows, dim=1)
        return dict(zip(graph.keys, stacked.unbind()))

    def _warm_up(self, batch, draws, use_z_bins):
        """WARMUP_STEPS eager steps on the capture stream, then the models'
        parameters and buffers and Adam's state as they were (Adam's state
        that the warm-up created is zeroed: a fresh Adam's)."""
        params = [p for m in self.models.values() for p in m.parameters()]
        buffers = [b for m in self.models.values() for b in m.buffers()]
        state = {p: {k: v.clone() for k, v in self.optimizer.state[p].items()}
                 for p in params if p in self.optimizer.state}
        saved = [t.detach().clone() for t in params + buffers]
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                self.optimizer.zero_grad(set_to_none=True)
                _step_body(self.models, self.optimizer, batch, self.cfg,
                           use_z_bins, draws, self.group)
            with torch.no_grad():
                for t, s in zip(params + buffers, saved):
                    t.copy_(s)
                for p in params:
                    for k, v in self.optimizer.state.get(p, {}).items():
                        if p in state:
                            v.copy_(state[p][k])
                        else:
                            v.zero_()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)


def make_train_multistep(models, optimizer, schedule, cfg: Config,
                         group=None) -> _TrainMultistep:
    """K real train steps per dispatch (the JAX package's
    ``make_train_multistep``, an on-device ``lax.scan``), called as
    ``(batches, draws, use_z_bins)`` with K batches and K draws; see
    :class:`_TrainMultistep`. With a process group on the card, that group
    must be nccl's (raises otherwise)."""
    return _TrainMultistep(models, optimizer, schedule, cfg, group)
