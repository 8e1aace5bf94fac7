"""Parameter storage in another type than the compute (``param_dtype``;
port of the JAX package's cast in ``train/state.py:init_variables``).

With ``param_dtype`` "bfloat16" every parameter of every model is stored
in that type, and the BatchNorm running statistics stay float32, as the
JAX package keeps its ``batch_stats``. Gradients and Adam's moments then
take the parameters' type too (optax's rule).

A flax module casts its parameters to its compute type where it uses
them; a torch module does not (``F.conv2d`` of a float32 input and a
bfloat16 weight raises). :func:`store_parameters` therefore gives every
convolution and BatchNorm of the models a subclass whose ``forward``
casts at the point of use, keeping no second copy of the parameters: a
convolution's weight and bias to its input's type (under autocast, which
casts them itself, they pass as they are), a BatchNorm's weight and bias
to its running statistics' type (float32, which ``batch_norm`` on the
card needs next to a bfloat16 input). The cast is an autograd op: the
gradient arrives in the parameter's own type. The subclasses add nothing
but ``forward``, so parameter and buffer names, and state_dicts, are
torch's.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg) -> torch.dtype:
    """The torch type of ``cfg.param_dtype``; raises on a value the port
    does not store."""
    try:
        return PARAM_DTYPES[cfg.param_dtype]
    except KeyError:
        raise ValueError(f"param_dtype {cfg.param_dtype!r}: the port stores "
                         f"parameters as one of {sorted(PARAM_DTYPES)}"
                         ) from None


def _to(t, dtype):
    return None if t is None else t.to(dtype)


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x):
    """``bn(x)`` with its weight and bias in its running statistics' type,
    for the port's BatchNorms (affine, tracking, a momentum): the running
    statistics and the count update in train mode as torch's do."""
    if bn.training and bn.num_batches_tracked is not None:
        bn.num_batches_tracked.add_(1)
    acc = bn.running_mean.dtype
    return F.batch_norm(x, bn.running_mean, bn.running_var,
                        _to(bn.weight, acc), _to(bn.bias, acc), bn.training,
                        bn.momentum, bn.eps)


class _CastConv:
    def forward(self, x):
        if torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _to(self.bias, x.dtype))


class _Conv2d(_CastConv, nn.Conv2d):
    pass


class _Conv3d(_CastConv, nn.Conv3d):
    pass


class _ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x):  # the models give no output_size
        if torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        return F.conv_transpose3d(x, self.weight.to(x.dtype),
                                  _to(self.bias, x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class _BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        self._check_input_dim(x)
        return batch_norm(self, x)


class _BatchNorm3d(nn.BatchNorm3d):
    def forward(self, x):
        self._check_input_dim(x)
        return batch_norm(self, x)


_CAST_AT_USE = {nn.Conv2d: _Conv2d, nn.Conv3d: _Conv3d,
                nn.ConvTranspose3d: _ConvTranspose3d,
                nn.BatchNorm2d: _BatchNorm2d, nn.BatchNorm3d: _BatchNorm3d}


def store_parameters(models: Mapping[str, nn.Module], dtype: torch.dtype):
    """Every parameter of ``models`` in ``dtype``, in place (the same
    ``Parameter`` objects); buffers, the running statistics among them,
    keep their type. For a ``dtype`` other than float32 every convolution
    and BatchNorm takes its casting subclass (the module docstring)."""
    with torch.no_grad():
        for model in models.values():
            for m in model.modules():
                if dtype != torch.float32 and type(m) in _CAST_AT_USE:
                    m.__class__ = _CAST_AT_USE[type(m)]
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)
    return models
