"""The port's train step against the JAX package's, on the CPU.

Both sides take the same weights (the port's seeded models through the JAX
package's converter, as tests/test_torch_port_pipeline.py does), the same
``make_batch`` batch and the same randomness: the masked-augmentation box
and the automask noise are re-derived from ``forward_train``'s
``jax.random`` split chain, as tests/test_e2e_parity.py does. The JAX side
is ``jax.value_and_grad(forward_train)`` on its XLA path
(``pallas_warp=False``) in float32 and one optax update from its
``create_optimizer``; it runs once per module.

Tolerances: the loss keys take test_e2e_parity's. Gradients are compared
per model as a relative L2 distance, after ``state_dict_from_jax``: 5e-3,
except for the two cost-volume models. Their float32 gradients at this size
lie up to 1.7e-2 from the same step computed in float64 by the port itself,
and the port's own float32 gradients move by up to 1.7e-2 between 1 and 8
CPU threads (a 1e-6 relative change of the input images moves them by
1e-2: the masked-augmentation loss compares two nearly equal depth maps),
so two float32 backends cannot agree on them more closely; they take
2.5e-2. The port's side runs on one thread, so that its sums are ordered
the same on every host.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from movedepth_tpu import pipeline as JP
from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu.models import build_models as jax_build_models
from movedepth_tpu.train import state as JS
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.weights import state_dict_from_jax
from test_torch_port_pipeline import B, CFG, H, W, _state_dicts

GRAD_TOL = {"mvs_encoder": 2.5e-2, "reg3d": 2.5e-2}
RNG_SEED = 123


def _draws():
    """forward_train's draws from PRNGKey(RNG_SEED): split 1 -> the box,
    split 2 -> the photometric key, then one split per mono scale."""
    rng, sub_mask = jax.random.split(jax.random.PRNGKey(RNG_SEED))
    kx, ky = jax.random.split(sub_mask)
    fh, fw = H // 3, W // 3
    box = (int(jax.random.randint(kx, (), 0, W - fw)),
           int(jax.random.randint(ky, (), 0, H - fh)))
    _, r = jax.random.split(rng)
    noise = []
    for _ in CFG.scales:
        r, s = jax.random.split(r)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(s, (B, H, W, 1)))))
    return {"box": box, "noise": noise}


@pytest.fixture(scope="module")
def jax_side():
    """Per use_z_bins: (losses, grads, batch_stats updates); plus the
    params and one optax update of the use_z_bins=False gradients."""
    states = _state_dicts()
    variables = {name: TI.convert_state_dict(
        name, {k: v.numpy() for k, v in sd.items()})
        for name, sd in states.items()}
    params, stats = JS.split_variables(variables)
    jmodels = jax_build_models(CFG)
    batch = make_batch(CFG, B, seed=11)

    def loss_fn(p, b, rng, z):
        total, (losses, _, updates) = JP.forward_train(
            jmodels, JS.combine_variables(p, stats), b, CFG, rng, z)
        return total, (losses, updates)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for z in (False, True):
        (_, (losses, updates)), grads = vg(
            params, jbatch, jax.random.PRNGKey(RNG_SEED), jnp.asarray(z))
        out[z] = ({k: float(v) for k, v in losses.items()},
                  jax.tree.map(np.asarray, grads),
                  jax.tree.map(np.asarray, updates))
    tx = JS.create_optimizer(CFG, 1000, params)
    upd, _ = tx.update(out[False][1], tx.init(params), params)
    new_params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
    return states, batch, out, new_params


def _port_models(states):
    models = build_models(CFG, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
    return models


class _BatchStats:
    """Forward hooks on every BatchNorm: each call's per-channel batch
    mean, unbiased variance and element count, in call order."""

    def __init__(self, models):
        self.calls = {}
        for name, model in models.items():
            for path, mod in model.named_modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.register_forward_hook(self._hook((name, path)))

    def _hook(self, key):
        def hook(mod, args, _):
            x = args[0].detach().double().transpose(0, 1).flatten(1)
            self.calls.setdefault(key, []).append(
                (x.mean(1), x.var(1, unbiased=True), x.shape[1]))
        return hook


@pytest.fixture(scope="module")
def port_side(jax_side):
    """Per use_z_bins: the port's train step from the same weights, with
    its losses, its models (gradients in .grad) and its BatchNorm calls."""
    states, batch, _, _ = jax_side
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one summation order, on any host
    try:
        for z in (False, True):
            models = _port_models(states)
            bn = _BatchStats(models)
            opt, sched = S.create_optimizer(models, CFG)
            losses, _ = S.train_step(models, opt, sched,
                                     P.as_batch(batch, "cpu"), CFG, z,
                                     _draws())
            out[z] = (losses, models, bn.calls)
    finally:
        torch.set_num_threads(threads)
    return out


# the loss keys and tolerances of tests/test_e2e_parity.py
LOOSE = ("loss/", "mono_loss", "loss")


@pytest.mark.parametrize("use_z_bins", [False, True])
def test_train_step_losses_match_jax(jax_side, port_side, use_z_bins):
    want = jax_side[2][use_z_bins][0]
    got = port_side[use_z_bins][0]
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        rtol = 1e-3 if key.startswith(LOOSE) else 2e-4
        np.testing.assert_allclose(float(got[key]), value, rtol=rtol,
                                   atol=2e-6, err_msg=key)


@pytest.mark.parametrize("use_z_bins", [False, True])
def test_train_step_gradients_match_jax(jax_side, port_side, use_z_bins):
    grads = jax_side[2][use_z_bins][1]
    models = port_side[use_z_bins][1]
    assert sorted(grads) == sorted(models)
    for name, model in models.items():
        want = state_dict_from_jax(name, {"params": grads[name]}, CFG.scales)
        got = dict(model.named_parameters())
        assert sorted(want) == sorted(got), name
        num = sum(float((got[k].grad - want[k]).norm() ** 2) for k in want)
        den = sum(float(want[k].norm() ** 2) for k in want)
        err = (num / den) ** 0.5
        assert err <= GRAD_TOL.get(name, 5e-3), (name, err)


def test_optimizer_step_matches_optax(jax_side):
    """Adam with two rate groups, fed JAX's gradients: the same updated
    parameters as optax's multi_transform."""
    states, _, out, new_params = jax_side
    grads = out[False][1]
    models = _port_models(states)
    for name, model in models.items():
        g = state_dict_from_jax(name, {"params": grads[name]}, CFG.scales)
        for k, p in model.named_parameters():
            p.grad = g[k].clone()
    opt, sched = S.create_optimizer(models, CFG)
    opt.step()
    sched.step()
    for name, model in models.items():
        want = state_dict_from_jax(name, {"params": new_params[name]},
                                   CFG.scales)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       atol=1e-6, err_msg=f"{name}.{k}")


def test_lr_schedule_matches_jax():
    """Both groups' rates over the steps of 6 epochs: x0.1 at every
    scheduler_step_size epochs, in optimizer steps."""
    cfg = CFG.replace(num_epochs=6, scheduler_step_size=2, lr_fac=0.5)
    models = {"mono_encoder": torch.nn.Linear(1, 1),
              "reg3d": torch.nn.Linear(1, 1)}
    opt, sched = S.create_optimizer(models, cfg, steps_per_epoch=3)
    main = JS.lr_schedule(cfg, 3, cfg.learning_rate)
    mvs = JS.lr_schedule(cfg, 3, cfg.learning_rate * cfg.lr_fac)
    for step in range(20):
        got = [g["lr"] for g in opt.param_groups]
        np.testing.assert_allclose(got, [float(main(step)), float(mvs(step))],
                                   rtol=1e-6)
        opt.step()
        sched.step()


def _bn_state(model, path):
    mod = dict(model.named_modules())[path]
    return mod.running_mean.double(), mod.running_var.double()


def test_bn_running_stats_follow_torch_rule(jax_side, port_side):
    """Every BatchNorm call of the step updates the running statistics in
    turn with the unbiased variance (torch's rule, which the reference
    trained with): mvs_encoder runs three times per step, reg3d and
    pose_encoder twice."""
    states = jax_side[0]
    _, models, calls = port_side[False]
    counts = {}
    for (name, path), seq in calls.items():
        counts[name] = max(counts.get(name, 0), len(seq))
        sd = states[name]
        mean, var = (sd[f"{path}.running_mean"].double(),
                     sd[f"{path}.running_var"].double())
        for mu, v, _ in seq:
            mean = 0.9 * mean + 0.1 * mu
            var = 0.9 * var + 0.1 * v
        got_mean, got_var = _bn_state(models[name], path)
        np.testing.assert_allclose(got_mean, mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_var, var, rtol=1e-5, atol=1e-6)
    assert counts == {"mono_encoder": 1, "mask_cnn": 1, "mvs_encoder": 3,
                      "reg3d": 2, "pose_encoder": 2}


@pytest.mark.parametrize("name", ["mono_encoder", "mask_cnn"])
def test_bn_running_stats_against_jax(jax_side, port_side, name):
    """A model called once per step: the running mean as the JAX
    package's; the running variance takes the batch variance times
    n/(n-1) where the JAX package takes it biased."""
    states, _, out, _ = jax_side
    updates = out[False][2][name]
    jstate = state_dict_from_jax(name, {"params": jax_side[3][name],
                                        "batch_stats": updates}, CFG.scales)
    _, models, calls = port_side[False]
    for (model_name, path), ((_, _, n),) in (
            (k, v) for k, v in calls.items() if k[0] == name):
        v0 = states[name][f"{path}.running_var"].double()
        jvar = jstate[f"{path}.running_var"].double()
        batch_var = (jvar - 0.9 * v0) / 0.1  # the JAX package's, biased
        got_mean, got_var = _bn_state(models[name], path)
        np.testing.assert_allclose(
            got_mean, jstate[f"{path}.running_mean"].double(), rtol=1e-4,
            atol=1e-5, err_msg=path)
        np.testing.assert_allclose(got_var, 0.9 * v0 + 0.1 * batch_var
                                   * n / (n - 1), rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_state_dict_from_jax_converts_a_gradient_tree(jax_side):
    """A params-only tree (here the gradient of 0.5 * sum(p^2), which is p
    itself) converts without BatchNorm statistics, with Reg3D's transposed
    convs flipped back to torch's layout."""
    states = jax_side[0]
    variables = TI.convert_state_dict(
        "reg3d", {k: v.numpy() for k, v in states["reg3d"].items()})
    grads = jax.grad(lambda p: 0.5 * sum(
        jnp.sum(x * x) for x in jax.tree.leaves(p)))(variables["params"])
    got = state_dict_from_jax("reg3d", {"params": grads})
    params = dict(_port_models(states)["reg3d"].named_parameters())
    assert sorted(got) == sorted(params)
    for k, p in params.items():
        np.testing.assert_allclose(got[k].numpy(), p.detach().numpy(),
                                   rtol=1e-6, err_msg=k)
    flipped = got["conv7.0.weight"]
    assert flipped.shape == params["conv7.0.weight"].shape
    assert not torch.equal(flipped, flipped.flip(2, 3, 4))
