"""The control of the comparison that decides ``correct``: the reference
computed one precision step below the bf16 compute that the
configurations state.

The program runs its models under bf16 autocast: the tensors autocast
computes in bf16 (convolutions, and what follows them until an op in
autocast's float32 list) are held in bf16. :func:`fp8` runs the reference
under the same autocast and rounds every bf16 result to float8 e4m3, each
tensor under its own scale, which maps its largest magnitude to the
format's largest: the program's precision policy at fp8.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8_round(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in t's
    dtype."""
    scale = t.abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(t.dtype)


class _Fp8Results(TorchDispatchMode):
    """Every bf16 floating-point result of an operator, rounded to fp8."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out  # views and in-place results keep their aliasing
        return tree_map(lambda t: fp8_round(t) if isinstance(t, torch.Tensor)
                        and t.dtype == torch.bfloat16 and t.numel() else t,
                        out)


@contextlib.contextmanager
def fp8(device):
    """The block under bf16 autocast with its bf16 results held at fp8."""
    kind = torch.device(device).type
    with torch.autocast(kind, dtype=torch.bfloat16), _Fp8Results():
        yield
