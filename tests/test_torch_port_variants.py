"""The port's model variants against the JAX package, on the CPU: Reg2D
(fewer than 8 depth bins), the deformable FPN head (``dcn``) and its
``deform_conv2d``. bfloat16 parameter storage is in
tests/test_torch_port_bf16.py, which uses this file's helpers.

Weights go from the JAX package's variables into the port through
``weights.state_dict_from_jax`` (the JAX package's ``torch_import`` has
no mapping for the DCN leaves). Inputs come from a numpy seed. Tolerances:
single modules atol 1e-4 of the output's range in eval mode (the models
test's); the pipelines those of tests/test_torch_port_pipeline.py and
tests/test_torch_port_train.py, whose draws and gradient measure this file
reuses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movedepth_tpu import models as JM
from movedepth_tpu import pipeline as JP
from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu.ops.deform import deform_conv2d as jax_deform_conv2d
from movedepth_tpu.train import state as JS
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch import models as TM
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops.deform import deform_conv2d
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.weights import state_dict_from_jax
from test_torch_port_models import _nchw, _perturb_bn, _round_trip
from test_torch_port_pipeline import B, CFG, H, W, _state_dicts
from test_torch_port_train import GRAD_TOL, LOOSE, RNG_SEED, _draws

F32 = jnp.float32
VARIANTS = {"reg2d": dict(num_depth_bins=4), "dcn": dict(dcn=True)}


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _port(name, variables, module):
    module.load_state_dict(state_dict_from_jax(name, variables))
    return module.eval()


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=rel * max(1.0, np.abs(want).max()))


# ------------------------------------------------------------- the modules

@pytest.mark.parametrize("train", [False, True])
def test_reg2d_matches_jax(rng, train):
    """Eval (running statistics) and train mode (batch statistics), and the
    state_dict back through the JAX package's converter exactly."""
    vol = rng.normal(0, 1, (2, 4, 8, 16, 8)).astype(np.float32)  # BDHWG
    jm = JM.Reg2D(base_channels=8, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(4), vol, False), rng)
    want = (jm.apply(v, vol, True, mutable=["batch_stats"])[0] if train
            else jm.apply(v, vol, False))
    port = _port("reg3d", v, TM.Reg2D(8))
    _round_trip("reg3d", port, v)
    with torch.no_grad():
        port.train(train)
        got = port(torch.from_numpy(vol.transpose(0, 4, 1, 2, 3).copy()))
    assert got.shape == (2, 4, 8, 16)
    _close(got, want)
    assert port.prob.bias is not None


def _vjp_errors(jax_fn, params, module, port_fn, x, c, perm, name):
    """Train mode: the relative L2 distance, per parameter, of the port's
    gradients of sum(out * c) from the JAX package's; ``c`` is the
    cotangent in the JAX layout, ``perm`` takes it to the port's."""
    g = jax.grad(lambda p: jnp.sum(jax_fn(p) * c))(params)
    want = state_dict_from_jax(name, {"params": jax.tree.map(np.asarray, g)})
    module.train()
    (port_fn(x) * torch.from_numpy(c.transpose(perm).copy())).sum().backward()
    return {k: float((p.grad - want[k]).norm() / want[k].norm())
            for k, p in module.named_parameters()}


def test_reg2d_gradients_match_jax(rng):
    """Train-mode gradients of every Reg2D parameter within 1e-3 relative
    L2 of the JAX package's."""
    vol = rng.normal(0, 1, (2, 4, 8, 16, 8)).astype(np.float32)
    jm = JM.Reg2D(base_channels=8, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(4), vol, False), rng)
    port = _port("reg3d", v, TM.Reg2D(8))
    errs = _vjp_errors(
        lambda p: jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                           vol, True, mutable=["batch_stats"])[0],
        v["params"], port, port,
        torch.from_numpy(vol.transpose(0, 4, 1, 2, 3).copy()),
        rng.normal(0, 1, vol.shape[:4]).astype(np.float32), (0, 1, 2, 3),
        "reg3d")
    assert max(errs.values()) < 1e-3, errs


def test_fpn4_dcn_gradients_match_jax(rng):
    """Train-mode gradients of every FPN4 parameter, the DCN head's
    included (its offset convs given weights), within 1e-3 relative L2."""
    x = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    jm = JM.FPN4(base_channels=8, scale=2, dcn=True, dtype=F32)
    v = _nonzero_offsets(_perturb_bn(jm.init(jax.random.PRNGKey(3), x,
                                             False), rng), rng)
    port = _port("mvs_encoder", v, TM.FPN4(8, scale=2, dcn=True))
    errs = _vjp_errors(
        lambda p: jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                           x, True, mutable=["batch_stats"])[0][0],
        v["params"], port, lambda t: port(t)[0], _nchw(x),
        rng.normal(0, 1, (2, 8, 12, 32)).astype(np.float32), (0, 3, 1, 2),
        "mvs_encoder")
    assert max(errs.values()) < 1e-3, errs


def _deform_inputs(rng, b=2, h=9, w=11, cin=5, cout=6, k=3, scale=1.5):
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    off = rng.normal(0, scale, (b, h, w, 2 * k * k)).astype(np.float32)
    gates = rng.uniform(0, 1, (b, h, w, k * k)).astype(np.float32)
    weight = rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)
    return x, off, gates, weight


@pytest.mark.parametrize("gated", [True, False])
def test_deform_conv2d_matches_jax(rng, gated):
    """Random offsets of a few pixels (taps outside the image read zeros),
    with and without gates (DCNv2, DCNv1)."""
    x, off, gates, weight = _deform_inputs(rng)
    bias = rng.normal(0, 1, (6,)).astype(np.float32)
    want = jax_deform_conv2d(x, off, gates if gated else None, weight, bias)
    got = deform_conv2d(_nchw(x), _nchw(off), _nchw(gates) if gated else None,
                        torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5)


def test_deform_conv2d_zero_offsets_equals_conv(rng):
    """Zero offsets and unit gates: a plain 'same' conv (tests/test_extras.py
    holds the JAX function to the same)."""
    x, off, gates, weight = _deform_inputs(rng)
    wt = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy())
    got = deform_conv2d(_nchw(x), torch.zeros(_nchw(off).shape),
                        torch.ones(_nchw(gates).shape), wt)
    want = torch.nn.functional.conv2d(_nchw(x), wt, padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def _nonzero_offsets(v, rng):
    """conv_offset starts at zero on both sides: give it weights, so the
    taps move and the gates differ from 1/2."""
    v = jax.tree.map(np.array, v)

    def walk(t):
        for k, sub in t.items():
            if k == "conv_offset":
                sub["kernel"] = rng.normal(0, 0.2, sub["kernel"].shape)
                sub["bias"] = rng.normal(0, 0.5, sub["bias"].shape)
            elif isinstance(sub, dict):
                walk(sub)

    walk(v["params"])
    return jax.tree.map(lambda a: np.asarray(a, np.float32), v)


@pytest.mark.parametrize("train", [False, True])
def test_dcn_conv2d_matches_jax(rng, train):
    x = rng.normal(0, 1, (2, 12, 16, 8)).astype(np.float32)
    jm = JM.DCNConv2d(8, dtype=F32)
    v = _nonzero_offsets(_perturb_bn(jm.init(jax.random.PRNGKey(5), x,
                                             False), rng), rng)
    want = (jm.apply(v, x, True, mutable=["batch_stats"])[0] if train
            else jm.apply(v, x, False))
    port = TM.DCNConv2d(8, 8)
    sd = state_dict_from_jax("mvs_encoder", {"params": {"out_dcn_0": v[
        "params"]}, "batch_stats": {"out_dcn_0": v["batch_stats"]}})
    assert sorted(sd) == sorted("out_dcn_0." + k for k in port.state_dict())
    port.load_state_dict({k[len("out_dcn_0."):]: t for k, t in sd.items()})
    with torch.no_grad():
        got = port.train(train)(_nchw(x))
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


def test_fpn4_dcn_head_matches_jax(rng):
    """FPN4 with the deformable head: out_dcn_0/1 with BN and ReLU,
    out_dcn_2 without; both outputs in eval mode."""
    x = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    jm = JM.FPN4(base_channels=8, scale=2, dcn=True, dtype=F32)
    v = _nonzero_offsets(_perturb_bn(jm.init(jax.random.PRNGKey(3), x,
                                             False), rng), rng)
    want = jm.apply(v, x, False)
    port = _port("mvs_encoder", v, TM.FPN4(8, scale=2, dcn=True))
    assert port.out_dcn_2.bn is None and not port.out_dcn_2.relu
    assert "out_dcn_1.conv_offset.weight" in port.state_dict()
    with torch.no_grad():
        got = port(_nchw(x))
    for g, w in zip(got, want):
        _close(g, np.asarray(w).transpose(0, 3, 1, 2))


def test_build_models_builds_reg2d_and_the_dcn_head():
    """The factory's choice of regularizer follows the JAX package's, and
    the DCN head's offset convs start at zero."""
    base = CFG.replace(reg3d_c=8)
    models = build_models(base.replace(num_depth_bins=4), "cpu")
    assert type(models["reg3d"]) is TM.Reg2D
    assert type(build_models(base.replace(num_depth_bins=8),
                             "cpu")["reg3d"]) is TM.Reg3D
    fpn = build_models(base.replace(dcn=True), "cpu")["mvs_encoder"]
    for i in range(3):
        block = getattr(fpn, f"out_dcn_{i}")
        assert not block.conv_offset.weight.any()
        assert block.weight.abs().sum() > 0


# ------------------------------------------------------------- pipelines

def _dcn_to_jax(sd, prefix):
    """The flax variables of one port DCNConv2d (``prefix`` its state_dict
    prefix): the inverse of ``state_dict_from_jax`` for these leaves."""
    k = lambda w: w.float().numpy().transpose(2, 3, 1, 0)
    offset = f"{prefix}.conv_offset"
    params = {"conv_offset": {"kernel": k(sd[f"{offset}.weight"]),
                              "bias": sd[f"{offset}.bias"].float().numpy()},
              "kernel": k(sd[f"{prefix}.weight"])}
    stats = {}
    if f"{prefix}.bn.weight" in sd:
        params["bn"] = {"scale": sd[f"{prefix}.bn.weight"].float().numpy(),
                        "bias": sd[f"{prefix}.bn.bias"].float().numpy()}
        stats["bn"] = {"mean": sd[f"{prefix}.bn.running_mean"].numpy(),
                       "var": sd[f"{prefix}.bn.running_var"].numpy()}
    return params, stats


def _weights(cfg, seed=42, offset_std=0.2):
    """The port's seeded weights as tests/test_torch_port_pipeline.py makes
    them (BN statistics perturbed, pose head x40), the DCN offset convs
    given weights (N(0, ``offset_std``), biases N(0, 0.5); they start at
    zero), and the same weights as the JAX
    package's variables: through its own converter, and the DCN leaves,
    which it has no mapping for, by hand. bfloat16 parameters go over as
    bfloat16 leaves."""
    rng = np.random.default_rng(seed)
    states = _state_dicts(cfg, seed)
    sd = states["mvs_encoder"]
    for key in [k for k in sd if ".conv_offset." in k]:
        sd[key] = torch.from_numpy(rng.normal(
            0, offset_std if key.endswith("weight") else 0.5,
            tuple(sd[key].shape))).to(sd[key].dtype)
    variables = {}
    for name, sd in states.items():
        plain = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
                 for k, v in sd.items() if not k.startswith("out_dcn_")}
        v = TI.convert_state_dict(name, plain)
        for i in range(3 if name == "mvs_encoder" and cfg.dcn else 0):
            params, stats = _dcn_to_jax(sd, f"out_dcn_{i}")
            v["params"][f"out_dcn_{i}"] = params
            if stats:
                v["batch_stats"][f"out_dcn_{i}"] = stats
        v["params"] = jax.tree.map(lambda a: jnp.asarray(
            a, jnp.dtype(cfg.param_dtype)), v["params"])
        variables[name] = v
    return states, variables


def _port_models(cfg, states):
    models = build_models(cfg, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
    return models


# both variants at once: each forward compiles the JAX pipeline once
VARIANT = CFG.replace(num_depth_bins=4, dcn=True)


@pytest.fixture(scope="module")
def variant():
    states, variables = _weights(VARIANT)
    return states, variables, make_batch(VARIANT, B, seed=11)


def test_variant_weights_carry_over(variant):
    """``state_dict_from_jax`` gives the port's weights back from the JAX
    variables, Reg2D's and the DCN leaves included."""
    states, variables, _ = variant
    for name, sd in states.items():
        back = state_dict_from_jax(name, variables[name], VARIANT.scales)
        assert sorted(back) == sorted(k for k in sd
                                      if not k.endswith("num_batches_tracked")
                                      ) or sorted(back) == sorted(sd), name
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(),
                                          err_msg=f"{name}.{k}")


def _tie_free(got_prob, want_prob, scale):
    """Full-resolution pixels whose decode cannot differ by a tie: the
    decode's argmax may pick either of two bins whose probabilities tie
    (to 1e-5; with 4 bins and random weights exact ties occur, e.g. where
    every bin's warp leaves the image), and the convex upsampling mixes a
    3x3 low-resolution neighbourhood. Asserts that every argmax that
    differs is such a tie; returns the (B, H, W) mask of the rest."""
    want_prob = np.asarray(want_prob)
    flips = got_prob.argmax(1).numpy() != want_prob.argmax(1)
    top = np.sort(want_prob, axis=1)
    assert (top[:, -1] - top[:, -2])[flips].max(initial=0.0) < 1e-5
    near = torch.nn.functional.max_pool2d(
        torch.from_numpy(flips.astype(np.float32))[:, None], 3, 1, 1)
    near = near.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return ~near[:, 0].bool().numpy()


def test_forward_infer_matches_jax(variant):
    """forward_infer_fused with Reg2D (4 bins) and the DCN head under
    tests/test_torch_port_pipeline.py's tolerances; the depth maps where
    no argmax tie reaches them (``_tie_free``)."""
    states, variables, batch = variant
    jmodels = JM.build_models(VARIANT)
    want = jax.jit(lambda v, b: JP.forward_infer_fused(
        jmodels, v, b, VARIANT))(
        variables, {k: jnp.asarray(a) for k, a in batch.items()})
    models = _port_models(VARIANT, states)
    assert type(models["reg3d"]) is TM.Reg2D and models["mvs_encoder"].dcn
    got = P.forward_infer_fused(models, P.as_batch(batch, "cpu"), VARIANT)
    assert got["cost_prob"].shape == (B, 4, H // 4, W // 4)
    keep = _tie_free(got["cost_prob"], want["cost_prob"], 4)
    assert keep.mean() > 0.5
    for key, tol in (("disp_mono", dict(atol=2e-5)),
                     ("cost_prob", dict(atol=1e-4)),
                     ("disp_mvs", dict(atol=1e-4)),
                     ("trust_mono", dict(atol=1e-4)),
                     ("depth_fused", dict(rtol=1e-4, atol=1e-3))):
        g, w = got[key].numpy(), np.asarray(want[key])
        if key in ("disp_mvs", "depth_fused"):
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, err_msg=key, **tol)


def _jax_value_and_grad(cfg, variables, batch):
    """The JAX package's loss and gradients of one step (z-guided bins,
    the draws of tests/test_torch_port_train.py)."""
    jmodels = JM.build_models(cfg)
    params, stats = JS.split_variables(variables)

    def loss_fn(p):
        total, (losses, _, _) = JP.forward_train(
            jmodels, JS.combine_variables(p, stats),
            {k: jnp.asarray(a) for k, a in batch.items()}, cfg,
            jax.random.PRNGKey(RNG_SEED), jnp.asarray(True))
        return total, losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return params, {k: float(v) for k, v in losses.items()}, grads


def _port_step(cfg, states, batch, threads=1):
    """One port train step on ``threads`` threads (one summation order)."""
    models = _port_models(cfg, states)
    opt, sched = S.create_optimizer(models, cfg)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        losses, _ = S.train_step(models, opt, sched, P.as_batch(batch, "cpu"),
                                 cfg, True, _draws())
    finally:
        torch.set_num_threads(before)
    return models, opt, losses


def _grad_errors(cfg, models, grads):
    """Per model, the relative L2 distance of the port's gradients from
    ``grads``: the JAX package's gradient tree, or a dict of port models
    (test_torch_port_train's measure)."""
    errs = {}
    for name, model in models.items():
        if isinstance(grads[name], torch.nn.Module):
            want = {k: p.grad for k, p in grads[name].named_parameters()}
        else:
            want = state_dict_from_jax(name, {"params": grads[name]},
                                       cfg.scales)
        got = dict(model.named_parameters())
        assert sorted(want) == sorted(got), name
        num = sum(float((got[k].grad.float() - want[k].float()).norm() ** 2)
                  for k in want)
        den = sum(float(want[k].float().norm() ** 2) for k in want)
        errs[name] = (num / den) ** 0.5
    return errs


@pytest.mark.parametrize("tag", sorted(VARIANTS))
def test_forward_train_matches_jax(tag):
    """One step (z-guided bins) of each variant, the test config otherwise:
    Reg2D (4 bins) and the DCN head (16 bins), automasking off as in the
    JAX package's own remat parity test (its mask flips on ~1e-7 changes).
    Every loss within tests/test_torch_port_train.py's tolerances (rtol
    2e-4, 1e-3 for the mono keys and the total). Every model's gradient
    within that file's tolerance (5e-3 relative L2, 2.5e-2 for the two
    cost-volume models) or twice the port's own distance between 1 and 4
    CPU threads, whichever is larger: at random init the cost softmax is
    nearly flat, and a float32 gradient through its decode is fixed only
    up to the order of its sums (Reg2D's reg3d moves by 3.3e-2 and
    mask_cnn by 1.5e-2 between thread counts, the DCN variant's mono
    encoder by 1.2e-2, and the JAX package lies as far away). The DCN
    offset convs take weights N(0, 0.05): with N(0, 0.2) each deformable
    layer multiplies the train-mode round-off by ~4 (7e-6 -> 4.7e-4
    relative over the three) and the port's own gradients move by up to
    16% between thread counts, so no float32 comparison holds there."""
    cfg = CFG.replace(disable_automasking=True, **VARIANTS[tag])
    states, variables = _weights(cfg, offset_std=0.05)
    batch = make_batch(cfg, B, seed=11)
    _, want, grads = _jax_value_and_grad(cfg, variables, batch)
    models, _, got = _port_step(cfg, states, batch)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        rtol = 1e-3 if key.startswith(LOOSE) else 2e-4
        np.testing.assert_allclose(float(got[key]), value, rtol=rtol,
                                   atol=2e-6, err_msg=key)
    spread = _grad_errors(cfg, _port_step(cfg, states, batch, 4)[0], models)
    errs = _grad_errors(cfg, models, grads)
    assert sorted(errs) == sorted(models)
    for name, err in errs.items():
        tol = max(GRAD_TOL.get(name, 5e-3), 2 * spread[name])
        assert err <= tol, (name, err, tol)


def test_reg2d_state_dict_through_the_jax_converter():
    """A port Reg2D's state_dict through the JAX package's converter and
    back through the port's: the same tensors."""
    port = build_models(CFG.replace(num_depth_bins=4), "cpu")["reg3d"]
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back = state_dict_from_jax("reg3d", TI.convert_state_dict("reg3d", state))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                          err_msg=k)
