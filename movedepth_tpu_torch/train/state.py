"""Optimizer, learning-rate schedule and the train step (port of
movedepth_tpu/train/state.py).

Adam with two learning-rate groups: the MVS group (mask_cnn, mvs_encoder,
reg3d) runs at ``learning_rate * lr_fac``, the rest at ``learning_rate``.
The rate drops x0.1 every ``scheduler_step_size`` epochs before
``num_epochs``, counted in optimizer steps, as the JAX package's optax
piecewise-constant schedule does. Each group's rate is a 0-d tensor on the
parameters' device that :class:`StepSchedule` overwrites in place, and on
the card Adam is ``capturable``: one train step (forward, losses,
backward, Adam) is captured as a CUDA graph and replayed. On the card and
without a process group, :func:`train_step` replays that graph, one step
a call, as the JAX package dispatches one compiled step; on the CPU and
under any process group it runs the step eagerly. A rematerialized step
(``remat_batch_threshold``, pipeline.py) captures too. The JAX package's
multi-step scan (``steps_per_dispatch``) and its XLA-only levers
(compiler options, scoped-VMEM limits) have no counterpart: every step is
one :func:`train_step` call.

How often each path ran is counted in the tracer's counters
(:func:`step_counts`): ``train.step_graph_captures``,
``train.step_graph_replays`` and ``train.step_eager``.
"""

from __future__ import annotations

import bisect
import weakref
from typing import Dict

import torch

from movedepth_tpu_torch import trace
from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.parallel.dist import all_reduce_grads
from movedepth_tpu_torch.pipeline import forward_train

# the models updated at learning_rate * lr_fac (the JAX package's MVS_GROUP)
MVS_GROUP = ("mask_cnn", "mvs_encoder", "reg3d")
# eager steps before a capture (PyTorch's whole-network capture recipe):
# cuDNN's autotuning, Adam's state and NCCL's communicators exist by then
WARMUP_STEPS = 3
# the tracer's counters of the step's paths (see step_counts)
STEP_COUNTERS = ("train.step_graph_captures", "train.step_graph_replays",
                 "train.step_eager")


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


def _step_body(models, optimizer, batch, cfg, use_z_bins, draws,
               group=None):
    """forward_train, backward, the gradient all-reduce (with a process
    ``group``), Adam: the part of a step that a CUDA graph captures (with
    no group). Each phase is a span: ``train.forward``, ``train.backward``,
    ``train.all_reduce``, ``train.optimizer``."""
    with trace.span("train.forward"):
        total, losses, outputs = forward_train(models, batch, cfg,
                                               use_z_bins, draws, group)
    with trace.span("train.backward"):
        total.backward()
    if group is not None:
        with trace.span("train.all_reduce"):
            all_reduce_grads(models, group)
    with trace.span("train.optimizer"):
        optimizer.step()
    return losses, outputs


def step_graphed(device: torch.device, group) -> bool:
    """Whether :func:`train_step` replays a captured CUDA graph of the step:
    the parameters on the card (``device``) and no process group. Every
    group stays eager: gloo collectives cannot be captured, and a capture
    at world > 1 has never run."""
    return device.type == "cuda" and group is None


def step_counts() -> dict:
    """How many steps took each path in this process (since the tracer's
    last reset): the tracer's counters ``train.step_graph_captures``,
    ``train.step_graph_replays`` and ``train.step_eager``."""
    return {k: trace.counter(k) for k in STEP_COUNTERS}


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
    outputs dict), detached; a later call overwrites neither. The whole
    call is the span ``train.step``.

    On the card without a group (:func:`step_graphed`) the step is a
    replay of the optimizer's captured step (:func:`_step_graph`): the
    batch and the draws are copied into the graph's inputs, the graph
    replays, and the losses and outputs are copied out of it; ``.grad``
    holds the graph's gradients. The first call, and a call whose
    ``use_z_bins``, config or input shapes and dtypes the held capture
    does not take, captures (the models take no step for it). On the CPU
    and under any process group the step runs eagerly
    (:func:`_eager_train_step`)."""
    device = next(p.device for m in models.values() for p in m.parameters())
    if not step_graphed(device, group):
        return _eager_train_step(models, optimizer, schedule, batch, cfg,
                                 use_z_bins, draws, group)
    for m in models.values():
        if not m.training:  # the graph runs in train mode whatever the flag
            m.train()
    graph = _step_graph(models, optimizer, cfg, bool(use_z_bins), batch,
                        draws)
    losses = graph.replay(batch, draws)
    schedule.step()
    graph.restore_grads()
    return dict(zip(graph.keys, losses.unbind())), _cloned(graph.outputs)


def _eager_train_step(models, optimizer, schedule, batch, cfg: Config,
                      use_z_bins: bool, draws, group=None):
    """:func:`train_step` issued op by op: the CPU's and every process
    group's path, and the card's eager baseline. Counts
    ``train.step_eager``."""
    trace.count("train.step_eager")
    for m in models.values():
        m.train()
    optimizer.zero_grad(set_to_none=True)
    losses, outputs = _step_body(models, optimizer, batch, cfg, use_z_bins,
                                 draws, group)
    schedule.step()
    return _detached(losses), _detached(outputs)


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone()


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


def _signature(use_z_bins, batch, draws):
    """What a capture is keyed on besides the config:
    ``use_z_bins`` and the shapes and dtypes of the batch and the draws."""
    def sig(v):
        return ((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                else type(v))
    return (use_z_bins, tuple((k, sig(v)) for k, v in batch.items()),
            tuple(sig(v) for v in draws["box"]),
            tuple(sig(v) for v in draws["noise"]))


class _StepGraph:
    """One train step captured as a CUDA graph: its static inputs (a batch
    and its draws), the stacked losses and the outputs it writes, the
    gradients it owns, and what the tracer's counters count in one replay
    (``counts``, read at capture, taken back off the counters then and
    added per replay: the kernel wrappers count in Python, which a replay
    does not run). ``serves`` says whether it takes a step of the given
    key, config and optimizer state."""

    def __init__(self, models, optimizer, cfg, use_z_bins, batch, draws,
                 stream):
        device = batch["color"].device
        self.key = _signature(use_z_bins, batch, draws)
        self.cfg, self.state = cfg, optimizer.state
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.draws = _static_draws(draws, device)
        self.params = [p for name in sorted(models)
                       for p in models[name].parameters()]
        optimizer.zero_grad(set_to_none=True)  # backward allocates in the pool
        before = trace.counters()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                losses, outputs = _step_body(models, optimizer, self.batch,
                                             cfg, use_z_bins, self.draws)
                self.keys = list(losses)
                self.losses = torch.stack([losses[k].detach().float()
                                           for k in self.keys])
                self.outputs = _detached(outputs)
        finally:
            self.counts = {k: n - before.get(k, 0)
                           for k, n in trace.counters().items()
                           if n != before.get(k, 0)}
            for k, n in self.counts.items():
                trace.count(k, -n)
        self.grads = [p.grad for p in self.params]

    def serves(self, key, cfg, optimizer) -> bool:
        """The same inputs' shapes and dtypes and config, and the optimizer
        state the graph updates (a ``load_state_dict`` puts in new
        tensors)."""
        return (key == self.key and optimizer.state is self.state
                and (cfg is self.cfg or cfg == self.cfg))

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
        trace.count("train.step_graph_replays")
        for k, n in self.counts.items():
            trace.count(k, n)
        return self.losses.clone()

    def restore_grads(self):
        """Point each parameter's ``.grad`` at the graph's gradients (an
        eager step in between may have replaced them)."""
        for p, g in zip(self.params, self.grads):
            p.grad = g


# the captured step of each optimizer on the card, dropped with it
_captured: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _step_graph(models, optimizer, cfg, use_z_bins, batch, draws):
    """The optimizer's captured step, the one :func:`train_step` replays.
    One capture is held per optimizer. A call it does not serve (another
    ``use_z_bins``, config, batch or draw shape or dtype, or optimizer
    state) drops it, so that its memory
    pool is freed, and captures anew: WARMUP_STEPS eager steps on this
    batch on a side stream, the models' parameters and buffers and Adam's
    state put back as they were (:func:`_warm_up`), then the capture,
    which runs nothing. A step that cannot be captured raises; there is no
    fallback to eager steps. Counts ``train.step_graph_captures``."""
    key = _signature(use_z_bins, batch, draws)
    graph = _captured.get(optimizer)
    if graph is not None and graph.serves(key, cfg, optimizer):
        return graph
    if graph is not None:
        del _captured[optimizer], graph
        optimizer.zero_grad(set_to_none=True)  # its gradients go with it
    stream = torch.cuda.Stream(batch["color"].device)
    _warm_up(models, optimizer, cfg, use_z_bins, batch, draws, stream)
    graph = _captured[optimizer] = _StepGraph(
        models, optimizer, cfg, use_z_bins, batch, draws, stream)
    trace.count("train.step_graph_captures")
    return graph


def _warm_up(models, optimizer, cfg, use_z_bins, batch, draws, stream):
    """WARMUP_STEPS eager steps on ``stream``, then the models' parameters
    and buffers and Adam's state as they were (Adam's state that the
    warm-up created is zeroed: a fresh Adam's)."""
    params = [p for m in models.values() for p in m.parameters()]
    buffers = [b for m in models.values() for b in m.buffers()]
    state = {p: {k: v.clone() for k, v in optimizer.state[p].items()}
             for p in params if p in optimizer.state}
    saved = [t.detach().clone() for t in params + buffers]
    device = batch["color"].device
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(WARMUP_STEPS):
            optimizer.zero_grad(set_to_none=True)
            _step_body(models, optimizer, batch, cfg, use_z_bins, draws)
        with torch.no_grad():
            for t, s in zip(params + buffers, saved):
                t.copy_(s)
            for p in params:
                for k, v in optimizer.state.get(p, {}).items():
                    if p in state:
                        v.copy_(state[p][k])
                    else:
                        v.zero_()
    torch.cuda.current_stream(device).wait_stream(stream)
