"""bfloat16 parameter storage (``param_dtype``) in the port against the
JAX package, on the CPU: the parameters' and statistics' types, one train
step against the JAX package's bf16-parameter step and optax's Adam, and a
checkpoint round trip; the modules that cast the stored parameters where
they are used. Tolerances are stated at each test."""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu.train import state as JS
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.models.storage import store_parameters
from movedepth_tpu_torch.parallel.sync_bn import SyncBatchNorm
from movedepth_tpu_torch.train import checkpoints as C
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.weights import (load_reference_folder,
                                         state_dict_from_jax)
from test_torch_port_pipeline import B, CFG
from test_torch_port_variants import (_grad_errors, _jax_value_and_grad,
                                      _port_step, _weights)

BF16 = CFG.replace(param_dtype="bfloat16")


def test_param_dtype_bfloat16_storage():
    """The counterpart of tests/test_pipeline.py's bf16-storage test:
    every parameter bfloat16, every BatchNorm statistic float32, and the
    forward finite on the CPU's float32 compute."""
    models = build_models(BF16, "cpu")
    for name, m in models.items():
        for k, p in m.named_parameters():
            assert p.dtype == torch.bfloat16, (name, k)
        for k, t in m.named_buffers():
            if "running" in k:
                assert t.dtype == torch.float32, (name, k)
    out = P.forward_infer_fused(models, P.synthetic_batch(BF16, 1,
                                                          device="cpu"), BF16)
    assert torch.isfinite(out["depth_fused"]).all()
    with pytest.raises(ValueError, match="param_dtype"):
        build_models(CFG.replace(param_dtype="int8"), "cpu")


def test_bf16_train_step_matches_jax():
    """One train step with bfloat16-stored parameters against the JAX
    package's (its params cast at init, the step's gradients and optax's
    Adam on bf16 leaves). Both compute in float32 from the same bf16
    values, so the losses keep the float32 step's tolerances (rtol 2e-4,
    1e-3 for the mono keys and the total); the gradients, rounded to
    bfloat16 on both sides, take one bf16 ulp more (2**-8) on the float32
    bounds; Adam's moments and the parameters after the step are bfloat16
    as optax's are, and the parameters within 2 bf16 ulps of optax's
    (rtol 2**-7) plus 1e-3 (the lr's step, where a moment's rounding flips
    the sign of a tiny update)."""
    states, variables = _weights(BF16)
    batch = make_batch(BF16, B, seed=11)
    params, want, grads = _jax_value_and_grad(BF16, variables, batch)
    for leaf in jax.tree.leaves(grads):
        assert leaf.dtype == jnp.bfloat16
    models, opt, got = _port_step(BF16, states, batch)
    for key, value in want.items():
        rtol = 1e-3 if key.startswith(("loss/", "mono_loss", "loss")) else 2e-4
        np.testing.assert_allclose(float(got[key]), value, rtol=rtol,
                                   atol=2e-6, err_msg=key)
    for name, err in _grad_errors(BF16, models, grads).items():
        tol = (2.5e-2 if name in ("mvs_encoder", "reg3d") else 5e-3) + 2 ** -8
        assert err <= tol, (name, err)

    tx = JS.create_optimizer(BF16, 1000, params)
    opt_state = tx.init(params)
    upd, opt_state = tx.update(grads, opt_state, params)
    new = optax.apply_updates(params, upd)
    mus = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    assert {leaf.dtype for s in mus for leaf in jax.tree.leaves(s.mu)
            + jax.tree.leaves(s.nu)} == {jnp.dtype(jnp.bfloat16)}
    for name, model in models.items():
        want_p = state_dict_from_jax(name, {"params": jax.tree.map(
            np.asarray, new[name])}, BF16.scales)
        for k, p in model.named_parameters():
            state = opt.state[p]
            assert p.dtype == state["exp_avg"].dtype == torch.bfloat16
            assert state["exp_avg_sq"].dtype == torch.bfloat16
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       want_p[k].float().numpy(),
                                       rtol=2 ** -7, atol=1e-3,
                                       err_msg=f"{name}.{k}")


def test_bf16_checkpoint_round_trip(tmp_path):
    """Saved bfloat16 weights and Adam state load back with their types
    and values; a float32 reference folder loads into bfloat16 parameters,
    cast on load, statistics float32."""
    cfg = BF16.replace(num_depth_bins=4, reg3d_c=8, dcn=True)
    models = build_models(cfg, "cpu")
    opt, sched = S.create_optimizer(models, cfg)
    draws = P.sample_draws(cfg, B, torch.Generator().manual_seed(0), "cpu")
    S.train_step(models, opt, sched, P.synthetic_batch(cfg, B, device="cpu"),
                 cfg, True, draws)
    folder = C.save_checkpoint(str(tmp_path), models, opt, sched, 1, cfg,
                               last=True)
    sd = torch.load(f"{folder}/mvs_encoder.pth", weights_only=True)
    assert sd["out_dcn_0.weight"].dtype == torch.bfloat16
    assert sd["out_dcn_0.bn.running_var"].dtype == torch.float32

    fresh = build_models(cfg, "cpu", torch.Generator().manual_seed(9))
    fopt, _ = S.create_optimizer(fresh, cfg)
    C.load_models(folder, fresh, list(fresh))
    assert C.load_optimizer(folder, fopt, "cpu") == 1
    for name in models:
        for (k, a), b in zip(models[name].state_dict().items(),
                             fresh[name].state_dict().values()):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k)
    for p, q in zip(opt.param_groups[0]["params"],
                    fopt.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq"):
            got = fopt.state[q][key]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, opt.state[p][key])
        assert fopt.state[q]["step"].dtype == torch.float32

    f32 = build_models(cfg.replace(param_dtype="float32"), "cpu")
    ref = tmp_path / "f32"
    ref.mkdir()
    for name, m in f32.items():
        torch.save(m.state_dict(), ref / f"{name}.pth")
    assert sorted(load_reference_folder(str(ref), fresh)) == sorted(fresh)
    for name in f32:
        for (k, a), b in zip(f32[name].state_dict().items(),
                             fresh[name].state_dict().values()):
            want = a.to(torch.bfloat16) if "running" not in k and (
                a.is_floating_point()) else a
            assert b.dtype == want.dtype and torch.equal(b, want), (name, k)


_MODULES = {
    "conv2d": lambda: torch.nn.Conv2d(3, 4, 3, padding=1),
    "conv3d": lambda: torch.nn.Conv3d(3, 4, (1, 3, 3), padding=(0, 1, 1)),
    "conv_transpose3d": lambda: torch.nn.ConvTranspose3d(
        3, 4, 3, stride=2, padding=1, output_padding=1, bias=False),
    "batchnorm2d": lambda: torch.nn.BatchNorm2d(3),
    "batchnorm3d": lambda: torch.nn.BatchNorm3d(3),
    "sync_batchnorm": lambda: SyncBatchNorm(3),  # no process group
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", sorted(_MODULES))
def test_modules_cast_at_use(kind, train):
    """Each module the models hold, stored bfloat16 by store_parameters,
    against the same module in float32 holding the same (bf16-rounded)
    values, on float32 inputs: the output, the input gradient and the
    running statistics bit for bit, each parameter gradient bfloat16 and
    bit for bit the float32 one rounded to bfloat16; state_dict keys
    unchanged."""
    gen = torch.Generator().manual_seed(1)
    ref = _MODULES[kind]()
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_((torch.rand(p.shape, generator=gen) + 0.5).bfloat16())
        for k, b in ref.named_buffers():
            if "running" in k:
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    mod = copy.deepcopy(ref)
    store_parameters({"m": mod}, torch.bfloat16)
    assert list(mod.state_dict()) == list(ref.state_dict())
    assert {p.dtype for p in mod.parameters()} == {torch.bfloat16}
    ref.train(train)
    mod.train(train)
    shape = (2, 3, 5, 6) if kind.endswith(("2d", "sync_batchnorm")) else (
        2, 3, 2, 5, 6)
    x = torch.randn(shape, generator=gen)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = mod(xa), ref(xb)
    g = torch.randn(want.shape, generator=gen)
    (got * g).sum().backward()
    (want * g).sum().backward()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(xa.grad, xb.grad)
    for (k, a), b in zip(mod.named_buffers(), ref.buffers()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for (k, p), q in zip(mod.named_parameters(), ref.parameters()):
        assert p.grad.dtype == torch.bfloat16, k
        assert torch.equal(p.grad, q.grad.bfloat16()), k


def test_sync_batchnorm_with_bf16_parameters(tmp_path):
    """The synchronized BatchNorm's group path (a world-1 gloo group) with
    bfloat16-stored weight and bias: the output, the input gradient and
    the running statistics of nn.BatchNorm2d holding the same values in
    float32 (within 1e-5), and the parameter gradients in bfloat16, that
    BatchNorm's rounded to bfloat16 (within one bf16 ulp, rtol 2**-7)."""
    import torch.distributed as dist

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 5, 6, generator=gen) * 2 + 1
    weight = torch.rand(3, generator=gen).bfloat16() + 0.5
    bias = torch.randn(3, generator=gen).bfloat16()
    ref = torch.nn.BatchNorm2d(3).train()
    bn = SyncBatchNorm(3).train()
    with torch.no_grad():
        ref.weight.copy_(weight.float())
        ref.bias.copy_(bias.float())
        bn.weight.data, bn.bias.data = weight.clone(), bias.clone()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        g = torch.randn(x.shape, generator=gen)
        got, want = bn(xa), ref(xb)
        (got * g).sum().backward()
        (want * g).sum().backward()
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bn, k), getattr(ref, k),
                                   rtol=1e-5, atol=1e-6)
    for p, q in ((bn.weight, ref.weight), (bn.bias, ref.bias)):
        assert p.grad.dtype == torch.bfloat16
        torch.testing.assert_close(p.grad.float(), q.grad.bfloat16().float(),
                                   rtol=2 ** -7, atol=1e-5)


def test_all_reduce_grads_with_bf16_parameters(tmp_path):
    """The gradient all-reduce on bfloat16 gradients (a world-1 gloo
    group): their own coalesced all-reduce, whose presence slots count in
    bfloat16, a missing gradient left missing, the rest unchanged."""
    import torch.distributed as dist
    from movedepth_tpu_torch.parallel.dist import all_reduce_grads

    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Conv2d(
        4, 2, 1)).bfloat16()
    grads = [torch.randn(p.shape).bfloat16() for p in model.parameters()]
    for p, g in zip(model.parameters(), grads):
        p.grad = g.clone()
    model[1].bias.grad = None
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        all_reduce_grads({"m": model})
    finally:
        dist.destroy_process_group()
    assert model[1].bias.grad is None
    for p, g in list(zip(model.parameters(), grads))[:3]:
        assert p.grad.dtype == torch.bfloat16 and torch.equal(p.grad, g)
