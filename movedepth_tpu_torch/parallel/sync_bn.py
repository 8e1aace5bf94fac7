"""A synchronized BatchNorm of the port's own: training statistics over the
global batch of every rank, as the JAX package's ``TorchBatchNorm`` has
them under the mesh (``movedepth_tpu/models/layers.py``: the pmean of the
mean and of the mean of squares).

``torch.nn.SyncBatchNorm`` cannot carry the port: it refuses CPU tensors
once a process group exists, and it gathers with
``all_gather_into_tensor``, which gloo lacks (the CPU tests and two ranks
sharing one card run on gloo).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from movedepth_tpu_torch.models.storage import batch_norm
from movedepth_tpu_torch.parallel.dist import is_distributed


def _per_channel(t, dim):
    """A per-channel vector shaped to broadcast over (N, C, ...)."""
    return t.view((1, -1) + (1,) * (dim - 2))


class _GlobalBatchNorm(torch.autograd.Function):
    """Normalization by given global statistics, whose backward adds the
    statistics' share of the gradient over the global batch.

    Forward: ``F.batch_norm`` with the global ``mean`` and biased ``var``
    as its running statistics (one fused kernel; the input's type out).
    Backward: BatchNorm's training backward on this rank's rows with the
    global statistics as the saved ones (one fused kernel), which gives
    ``dx`` for the local batch and this rank's ``sum dy`` and ``sum dy *
    xhat`` (the bias and weight gradients); one all-reduce of the two
    sums; then ``dx += w * invstd * (sum dy / n_local - sum dy / n) + w *
    invstd * xhat * (sum dy xhat / n_local - sum dy xhat / n)``, the
    gradient of a BatchNorm over the global batch of ``n`` rows.
    ``coef`` holds ``[w * invstd, w * invstd^2] / n_local`` and ``share``
    ``n_local / n``. The weight and bias keep this rank's sums, which the
    gradient all-reduce averages."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, invstd, coef, share, eps,
                group):
        ctx.eps, ctx.group = eps, group
        ctx.grads = (weight is not None, bias is not None)
        ctx.save_for_backward(x, weight, mean, invstd, coef, share)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, coef, share = ctx.saved_tensors
        if weight is None:
            weight = torch.ones_like(mean)
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy.contiguous(), x, weight, None, None, mean, invstd, True,
            ctx.eps, [True, True, True])
        local = torch.cat([db, dw])
        sums = local.clone()
        torch.distributed.all_reduce(sums, group=ctx.group)
        k0, k1 = torch.addcmul(local, sums, share, value=-1).mul_(
            coef).view(2, -1)
        d = x.dim()
        dx = torch.addcmul(
            _per_channel(torch.addcmul(k0, k1, mean, value=-1), d), x,
            _per_channel(k1, d)).add_(dx).to(x.dtype)
        return (dx, dw if ctx.grads[0] else None,
                db if ctx.grads[1] else None) + (None,) * 7


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over any (N, C, ...) input whose training statistics cover
    the batch of every rank of ``process_group`` (the world if None).

    In train mode with a process group, each call makes one all-reduce of
    the packed per-channel ``[sum x, sum x^2, count]`` (from each rank's
    ``var_mean``, in float32, float64 for float64 input), takes the global
    mean and the biased variance ``E[x^2] - E[x]^2`` from it and
    normalizes with them (``_GlobalBatchNorm``, whose backward makes one
    more all-reduce); the output has the input's type (bfloat16 under
    autocast, as ``nn.BatchNorm`` gives there; bfloat16-stored weight and
    bias are cast to float32 for it). Running statistics follow
    torch's rule: an update on every call, momentum ``momentum``, the
    unbiased variance over the global count. In eval mode, or with no
    process group, it is ``nn.BatchNorm`` bit for bit. Parameter and
    buffer names are ``nn.BatchNorm``'s, so state_dicts and checkpoints
    carry over. Each call issues some twenty small tensor operations
    beside its two all-reduces: its cost is host time (PERF.md).
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None, device=None,
                 dtype=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device, dtype)
        self.process_group = process_group

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {input.dim()}D "
                             "input)")

    def forward(self, x):
        self._check_input_dim(x)
        if not (self.training and is_distributed()):
            if self.weight.dtype != self.running_mean.dtype:  # param_dtype
                return batch_norm(self, x)
            return super().forward(x)
        c = x.shape[1]
        n_local = x.numel() // c
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(acc), dims, correction=0)
            stats = torch.cat([mean, torch.addcmul(var, mean, mean),
                               mean.new_ones(1)]).mul_(n_local)
            torch.distributed.all_reduce(stats, group=self.process_group)
            n = stats[2 * c:]
            mean, ex2 = (stats[:2 * c].view(2, c) / n).unbind()
            var = torch.addcmul(ex2, mean, mean, value=-1)
            if self.track_running_stats:
                if self.num_batches_tracked is not None:  # torch's rule
                    self.num_batches_tracked.add_(1)
                # momentum None reads the count on the host, which a CUDA
                # graph's capture forbids; the port's BatchNorms have 0.1
                m = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                torch._foreach_lerp_(
                    [self.running_mean, self.running_var],
                    [mean.to(self.running_mean.dtype),
                     (var * (n / (n - 1))).to(self.running_var.dtype)], m)
            invstd = torch.rsqrt(var + self.eps)
            w = self.weight if self.weight is not None else 1.0
            scaled = torch.mul(w, invstd).div_(n_local)
            coef = torch.cat([scaled, scaled * invstd])
            share = n_local / n
        # parameters stored in a narrower type (param_dtype) join the
        # statistics' type here; their gradients go back through the cast
        weight, bias = (None if t is None else t.to(acc)
                        for t in (self.weight, self.bias))
        return _GlobalBatchNorm.apply(x, weight, bias, mean, var, invstd,
                                      coef, share, self.eps,
                                      self.process_group)


def convert_sync_batchnorm(models: Mapping[str, nn.Module],
                           process_group=None):
    """Swap every ``BatchNorm2d`` and ``BatchNorm3d`` of ``models`` (a dict
    of modules) for a :class:`SyncBatchNorm` in place. The new module takes
    over the old one's parameters and buffers themselves (an optimizer made
    before keeps them), its mode and its settings. Returns ``models``."""
    for model in models.values():
        for parent in list(model.modules()):
            for name, child in list(parent.named_children()):
                if isinstance(child, (nn.BatchNorm2d, nn.BatchNorm3d)):
                    setattr(parent, name, _synced(child, process_group))
    return models


def _synced(bn, process_group):
    new = SyncBatchNorm(bn.num_features, bn.eps, bn.momentum, bn.affine,
                        bn.track_running_stats, process_group,
                        device="meta")
    new.weight, new.bias = bn.weight, bn.bias
    for key in ("running_mean", "running_var", "num_batches_tracked"):
        setattr(new, key, getattr(bn, key))
    new.train(bn.training)
    return new
