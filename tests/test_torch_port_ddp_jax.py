"""The port's data-parallel train step against the JAX package's
single-device step at the global batch, on the CPU.

The JAX side is tests/test_torch_port_train.py's ``jax_side``: ``CFG``,
``B = 2``, 64x96, float32, ``make_batch(seed=11)`` and the draws of the
``_draws()`` chain, one ``value_and_grad(forward_train)`` per
``use_z_bins``; that single-device step is what the JAX mesh computes
(tests/test_sharding.py ``test_dp_matches_single_device``). The port runs
it as 2 gloo ranks of 1 sample each (tests/test_torch_port_ddp.py's
``run_ranks``), with synchronized BatchNorm, global masked means and the
gradient all-reduce. Tolerances are test_torch_port_train.py's: the loss
keys', ``GRAD_TOL`` for the gradients read after the all-reduce, and
1e-6 for one Adam step against optax's fed the same gradients.
"""

import numpy as np
import optax
import pytest

import jax

from movedepth_tpu.train import state as JS
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch.weights import state_dict_from_jax
from test_torch_port_ddp import LOOSE, rel_l2, run_ranks
from test_torch_port_pipeline import CFG
from test_torch_port_train import GRAD_TOL, _draws, jax_side  # noqa: F401


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):  # noqa: F811
    """Each rank's result of one port step per use_z_bins (False, True)
    at 2 ranks x 1 sample."""
    states, batch, _, _ = jax_side
    spec = {"cfg": CFG.to_json(), "states": states, "batch": batch,
            "jobs": [{"use_z": z, "draws": _draws()} for z in (False,
                                                                True)]}
    return run_ranks(tmp_path_factory.mktemp("ddp_jax"), "step", spec)


@pytest.mark.parametrize("use_z_bins", [False, True])
def test_ddp_step_losses_match_jax(jax_side, ranks, use_z_bins):  # noqa
    """The mean over the ranks of each loss (what the trainer logs)
    against the JAX step's; the masked means are the same on both ranks."""
    want = jax_side[2][use_z_bins][0]
    got = [res["jobs"][use_z_bins]["losses"] for res in ranks]
    assert sorted(got[0]) == sorted(want)
    for key, value in want.items():
        rtol = 1e-3 if key.startswith(LOOSE) else 2e-4
        np.testing.assert_allclose(np.mean([g[key] for g in got]), value,
                                   rtol=rtol, atol=2e-6, err_msg=key)
    for key in ("mvs_reproj_loss", "fuse_reproj_loss", "masked_loss"):
        assert got[0][key] == got[1][key], key


@pytest.mark.parametrize("use_z_bins", [False, True])
def test_ddp_step_gradients_match_jax(jax_side, ranks, use_z_bins):  # noqa
    """Each model's gradient after the all-reduce, the same on both
    ranks, against the JAX step's within GRAD_TOL (relative L2)."""
    grads = jax_side[2][use_z_bins][1]
    got = [ranks[0]["jobs"][use_z_bins]["grads"]]
    assert sorted(grads) == sorted(got[0])
    for name in grads:
        want = state_dict_from_jax(name, {"params": grads[name]}, CFG.scales)
        assert sorted(want) == sorted(got[0][name]), name
        err = rel_l2(got[0][name], want)
        assert err <= GRAD_TOL.get(name, 5e-3), (name, err)
    assert ranks[1]["jobs"][use_z_bins]["grad_gap"] == 0.0


@pytest.mark.parametrize("use_z_bins", [False, True])
def test_ddp_step_adam_matches_optax(jax_side, ranks, use_z_bins):  # noqa
    """The parameters after the ranks' step, the same on both, are optax's
    update (the JAX package's create_optimizer) of the same weights by the
    ranks' averaged gradients, within 1e-6."""
    states = jax_side[0]
    variables = {name: TI.convert_state_dict(
        name, {k: v.numpy() for k, v in sd.items()})
        for name, sd in states.items()}
    params, _ = JS.split_variables(variables)
    job = [res["jobs"][use_z_bins] for res in ranks]
    # the gradients through the weights' converter (the running statistics
    # ride along and are dropped)
    grads = {name: TI.convert_state_dict(name, {
        **{k: v.numpy() for k, v in states[name].items()},
        **{k: g.numpy() for k, g in job[0]["grads"][name].items()}})[
            "params"] for name in params}
    tx = JS.create_optimizer(CFG, 1000, params)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
    assert job[1]["state_gap"] == 0.0
    for name in params:
        want = state_dict_from_jax(name, {"params": new[name]}, CFG.scales)
        for k, w in want.items():
            got = job[0]["params"][name][k]
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-6,
                                       err_msg=f"{name}.{k}")
