"""Rematerialization of the port's train step (``remat_batch_threshold``,
``remat_scope``; the JAX package's ``heavy`` / ``heavy_enc`` gate), on the
CPU: the rematerialized step against the plain step from the same weights,
batch and draws.

As in the JAX package's own check (tests/test_pipeline.py), automasking is
off: its mask is a discrete comparison of near-tied values. Both steps run
on one thread. The forward is the same arithmetic, so the losses are equal;
the gradients sum the recomputed pieces' contributions in another order,
within 1e-5 relative L2 per model (one bfloat16 rounding, 2**-8, with
bfloat16 parameters, whose gradients are bfloat16); every BatchNorm
running statistic and count is equal (the recompute leaves them alone),
and nothing draws from a generator.
"""

import pytest
import torch

from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.train import state as S
from test_torch_port_pipeline import B, CFG

BASE = CFG.replace(disable_automasking=True)
CASES = {"full": BASE, "mvs": BASE.replace(remat_scope="mvs"),
         # the slice's other variants under remat: Reg2D, the DCN head and
         # bfloat16 parameters
         "full_variants": BASE.replace(num_depth_bins=4, dcn=True,
                                       param_dtype="bfloat16")}


def _step(cfg, counts, monkeypatch):
    """One train step on one thread from seeded weights; counts the warps
    that run (forward and recompute)."""
    for name in ("sweep_warp", "warp_images_border"):
        fn = getattr(P, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(P, name, counted)
    models = build_models(cfg, "cpu")
    opt, sched = S.create_optimizer(models, cfg)
    batch = P.synthetic_batch(cfg, B, seed=5, device="cpu")
    draws = P.sample_draws(cfg, B, torch.Generator().manual_seed(1), "cpu")
    kept = [t.clone() for t in draws["box"]]
    rng = torch.get_rng_state()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, _ = S.train_step(models, opt, sched, batch, cfg, True, draws)
    finally:
        torch.set_num_threads(threads)
        monkeypatch.undo()
    assert torch.equal(torch.get_rng_state(), rng)
    assert all(torch.equal(a, b) for a, b in zip(kept, draws["box"]))
    return losses, models


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_step_matches_the_plain_step(case, monkeypatch):
    cfg = CASES[case]
    plain_counts, remat_counts = {}, {}
    want, plain = _step(cfg, plain_counts, monkeypatch)
    got, remat = _step(cfg.replace(remat_batch_threshold=B - 1),
                       remat_counts, monkeypatch)
    # the recompute runs the MVS trunk's warp and each frame block's again
    assert remat_counts == {k: 2 * n for k, n in plain_counts.items()}
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for name, model in plain.items():
        other = dict(remat[name].named_parameters())
        num = den = 0.0
        for k, p in model.named_parameters():
            num += float((other[k].grad.float() - p.grad.float()).norm() ** 2)
            den += float(p.grad.float().norm() ** 2)
        tol = 1e-5 if cfg.param_dtype == "float32" else 2 ** -8
        assert (num / den) ** 0.5 <= tol, (name, (num / den) ** 0.5)
        buffers = dict(remat[name].named_buffers())
        for k, t in model.named_buffers():
            assert torch.equal(buffers[k], t), (name, k)


def test_remat_gate_follows_the_jax_package():
    """heavy = train and b > remat_batch_threshold; heavy_enc = heavy and
    remat_scope == 'full'. An unknown scope raises. forward_train trains
    when the models are in train mode with gradients on."""
    assert P.remat_gate(32, CFG, train=False) == (False, False)
    assert P.remat_gate(24, CFG) == (False, False)
    assert P.remat_gate(32, CFG) == (True, True)
    assert P.remat_gate(32, CFG.replace(remat_scope="mvs")) == (True, False)
    with pytest.raises(ValueError, match="remat_scope"):
        P.remat_gate(32, CFG.replace(remat_scope="some"))
