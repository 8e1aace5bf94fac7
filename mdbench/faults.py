"""Faults planted in the program for the comparison's own checks: each
must turn ``correct`` false. Used by the tests under ``mdbench/tests``
and by ``calibrate.py``, never by a benchmark run.

Each fault is a context manager that patches one module of the program
and puts it back: a step that leaves its state unchanged, half of the
batch left out (the rest computed on the other half's rows), and an
answer altered where it is produced.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def _half(batch):
    """Each tensor's first half of rows, repeated to the full batch."""
    def cut(v):
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            return v
        h = max(1, v.shape[0] // 2)
        return torch.cat([v[:h], v[:h]])[:v.shape[0]]
    return {k: cut(v) for k, v in batch.items()}


def infer_fault(kind):
    """A fault of ``pipeline.forward_infer_fused``."""
    from movedepth_tpu_torch import pipeline as P

    def wrap(real):
        last = {}

        def fn(models, batch, cfg):
            if kind == "half_batch":
                return real(models, _half(batch), cfg)
            out = real(models, batch, cfg)
            if kind == "altered":
                out = dict(out)
                out["depth_fused"] = out["depth_fused"].clone()
                out["depth_fused"][0] *= 1.05
                return out
            if kind == "unchanged":  # the previous call's outputs
                prev = last.get("out", out)
                last["out"] = out
                return prev
            raise ValueError(kind)
        return fn
    return _patched(P, "forward_infer_fused", wrap)


def train_fault(kind):
    """A fault of the train step (``train.state``)."""
    from movedepth_tpu_torch.train import state as S

    if kind == "unchanged":
        def wrap(real):
            def fn(models, optimizer, schedule, batch, cfg, use_z, draws,
                   group=None):
                with torch.no_grad():
                    _, losses, outputs = S.forward_train(models, batch, cfg,
                                                         use_z, draws)
                return losses, outputs
            return fn
        return _patched(S, "train_step", wrap)

    def wrap(real):
        def fn(models, batch, cfg, use_z, draws, group=None):
            if kind == "half_batch":
                batch = _half(batch)
                draws = dict(draws, noise=[_half({"n": n})["n"]
                                           for n in draws["noise"]])
                return real(models, batch, cfg, use_z, draws, group)
            if kind == "altered":
                total, losses, outputs = real(models, batch, cfg, use_z,
                                              draws, group)
                losses = dict(losses, loss=total * 1.5)
                return total * 1.5, losses, outputs
            raise ValueError(kind)
        return fn
    return _patched(S, "forward_train", wrap)
