"""Data-parallel training across processes: the torch counterpart of the
``data`` axis of ``movedepth_tpu/parallel/mesh.py``.

One process per card, started by ``torchrun`` (the reference trains so:
``torch.distributed.launch``, one process per GPU). Each process reads its
rank-strided shard of the data at ``cfg.batch_size`` rows (the JAX
package's multi-process contract, ``mesh.py`` ``shard_batch``), so the
global batch is ``world_size * cfg.batch_size``. What the JAX mesh gets
from GSPMD is made explicit here:

  * the models start identical on every rank: ``broadcast_models`` sends
    rank 0's parameters and buffers (the JAX ``replicate`` assumes it);
  * BatchNorm sees the global batch (``parallel/sync_bn.py``, whose
    backward all-reduces the statistics' gradient terms), and so do the
    masked means of the losses (``ops/losses.masked_mean`` with a group,
    through :func:`all_reduce_sum`, whose backward sums the cotangents
    across ranks);
  * gradients are averaged across ranks by ``all_reduce_grads`` between
    ``backward()`` and the optimizer step: one coalesced all-reduce, not a
    ``DistributedDataParallel`` wrapper (the train forward calls some
    models several times before one backward).

When a process group exists every collective runs, even at world size 1.
Without one, each function here is the identity (or a no-op), so the
single-process paths do not change. The cost volume's ``model`` axis
(``mesh.py`` ``constrain``) is not ported, by design.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from movedepth_tpu_torch import trace


def is_distributed() -> bool:
    """True once this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def default_group():
    """The world group, or None without a process group."""
    return dist.group.WORLD if is_distributed() else None


def initialize_distributed(device: str = "cuda",
                           backend: Optional[str] = None,
                           init_method: str = "env://"):
    """Join the process group that ``torchrun`` describes (the counterpart
    of ``mesh.py`` ``initialize_distributed``); returns (rank, world size,
    this rank's device).

    Rank, world size and local rank come from torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``. On ``device="cuda"`` the rank trains
    on ``cuda:LOCAL_RANK`` and the backend defaults to ``nccl``; on
    ``"cpu"`` to ``gloo``. ``gloo`` may be asked for CUDA tensors too (two
    ranks sharing one card, which NCCL refuses). ``init_method`` is
    torchrun's ``env://`` unless the caller gives another, such as a
    ``file://`` rendezvous. A process already in a group keeps it. Raises
    without a card when asked for cuda, and when the group cannot form.
    """
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"{', '.join(missing)} not set: start the "
                           "processes with torchrun")
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank_}: no CUDA device; pass "
                               "--device cpu to train on the CPU")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device(kind)
    if not is_distributed():
        dist.init_process_group(
            backend or ("nccl" if kind == "cuda" else "gloo"),
            init_method=init_method, rank=rank_, world_size=world)
    if (dist.get_rank(), dist.get_world_size()) != (rank_, world):
        raise RuntimeError(
            f"the process group has rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the environment {rank_} of {world}")
    return rank_, world, dev


def _host_device(group):
    """Where a collective of host values runs: the card for NCCL, which
    takes CUDA tensors only, the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the cotangents over ranks: the
    semantics of ``torch.distributed.nn.functional.all_reduce`` with
    ``SUM``, which warns on every process that it is deprecated."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of ``group`` (the world if
    None), differentiable: the gradient reaching each rank's input is the
    sum of every rank's cotangent."""
    return _AllReduceSum.apply(tensor, group)


def broadcast_models(models: Mapping[str, torch.nn.Module], group=None):
    """Give every rank rank 0's parameters and buffers (BatchNorm
    statistics included), once after init or load; no-op without a
    process group."""
    if not is_distributed():
        return
    tensors = [t for name in sorted(models)
               for t in (*models[name].parameters(), *models[name].buffers())]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, group=group, group_src=0)
        with torch.no_grad():
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))


def all_reduce_grads(models: Mapping[str, torch.nn.Module], group=None,
                     check: bool = True):
    """Average every parameter's ``.grad`` over the ranks: one coalesced
    all-reduce (per gradient dtype), divided by the world size; call it
    after ``backward()`` and before the optimizer step. A parameter whose
    ``.grad`` is None must be None on every rank (every rank runs the same
    graph): with ``check`` the all-reduce carries one slot a parameter
    counting the ranks that hold a gradient, and a count other than 0 or
    the world size raises. That check reads the counts on the host, which
    a CUDA graph's capture forbids (the counts are exact in bfloat16 up to
    256 ranks, so bfloat16 gradients carry them in their own all-reduce):
    a captured step passes ``check=False``,
    and the eager warm-up steps before its capture make the check (a
    replay cannot change which gradients exist). The bytes all-reduced
    are counted as ``all_reduce_bytes``. No-op without a process
    group."""
    if not is_distributed():
        return
    world = dist.get_world_size(group)
    params = [p for name in sorted(models)
              for p in models[name].parameters()]
    for dtype in sorted({p.dtype for p in params}, key=str):
        same = [p for p in params if p.dtype == dtype]
        slots = len(same) if check else 0
        flat = torch.cat(
            [p.grad.reshape(-1) if p.grad is not None
             else p.new_zeros(p.numel()) for p in same]
            + ([torch.tensor([p.grad is not None for p in same], dtype=dtype,
                             device=same[0].device)] if check else []))
        dist.all_reduce(flat, group=group)
        trace.count("all_reduce_bytes", flat.numel() * flat.element_size())
        if check:
            counts = flat[-slots:].tolist()
            if any(c not in (0, world) for c in counts):
                raise RuntimeError(
                    "ranks disagree on which parameters have a gradient: "
                    f"{sum(c not in (0, world) for c in counts)} parameters")
        parts = flat[:flat.numel() - slots].div_(world).split(
            [p.numel() for p in same])
        held = [(p.grad, part.view_as(p)) for p, part in zip(same, parts)
                if p.grad is not None]
        torch._foreach_copy_([g for g, _ in held], [v for _, v in held])


def all_reduce_host(values: Sequence[float], group=None) -> list:
    """The sums over ranks of host numbers, in float64; the numbers
    themselves without a process group."""
    if not is_distributed():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_host_device(group))
    dist.all_reduce(t, group=group)
    return t.tolist()


def reduce_mean_scalars(scalars: Mapping[str, float],
                        group=None) -> Dict[str, float]:
    """The mean over ranks of each scalar, for logging. Every rank must
    pass the same keys; they are reduced in sorted order and returned in
    the caller's. Without a process group, the scalars as floats."""
    keys = sorted(scalars)
    world = dist.get_world_size(group) if is_distributed() else 1
    sums = dict(zip(keys, all_reduce_host([scalars[k] for k in keys],
                                          group)))
    return {k: sums[k] / world for k in scalars}


def barrier(group=None):
    """Wait for every rank; no-op without a process group."""
    if not is_distributed():
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
