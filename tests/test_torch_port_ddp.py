"""Data-parallel training of the port on the CPU: ranks are real ``gloo``
processes (this file run as a script, one process a rank), joined through
a ``file://`` rendezvous in the test's own directory, on one torch thread
each, and each given 300 s: a hang fails its test.

Checked here: the synchronized BatchNorm against ``nn.BatchNorm`` on the
concatenated batch (float64, 1e-10), the global ``masked_mean`` at unequal
mask counts, the port's 2-rank train step against its 1-process step at
the global batch, the sharded draws, and the CLI's refusal of several
cards without torchrun. The trainer and the train CLI at 2 ranks are in
tests/test_torch_port_ddp_trainer.py, the 2-rank step against the JAX
package's single-device step in tests/test_torch_port_ddp_jax.py; both
start their ranks through this file.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank's script
    sys.path.insert(0, REPO)

from movedepth_tpu_torch import Config  # noqa: E402
from movedepth_tpu_torch import pipeline as P  # noqa: E402
from movedepth_tpu_torch.models import build_models  # noqa: E402
from movedepth_tpu_torch.ops.losses import masked_mean  # noqa: E402
from movedepth_tpu_torch.parallel import dist as D  # noqa: E402
from movedepth_tpu_torch.parallel.sync_bn import (  # noqa: E402
    SyncBatchNorm, convert_sync_batchnorm)
from movedepth_tpu_torch.train import state as S  # noqa: E402

RANK_TIMEOUT = 300  # seconds a rank may take
WORLD = 2
DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
CFG = Config(height=64, width=96, batch_size=2, compute_dtype="float32")
# the loss keys and tolerances of tests/test_torch_port_train.py
LOOSE = ("loss/", "mono_loss", "loss")


# ------------------------------------------------------------ the ranks

def run_ranks(workdir, case, spec=None, world=WORLD):
    """Run ``case`` as ``world`` gloo ranks, each a process of its own;
    returns each rank's result. ``spec`` goes to every rank through
    ``<workdir>/spec.pt``. A rank that exits non-zero or outlives
    RANK_TIMEOUT fails the test, with every rank's stderr."""
    workdir = str(workdir)
    if spec is not None:
        torch.save(spec, os.path.join(workdir, "spec.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(world),
               LOCAL_RANK="0", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, workdir],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1] for p in procs]
        pytest.fail(f"{case}: a rank outlived {RANK_TIMEOUT} s:\n"
                    + "\n".join(e[-3000:] for e in errs))
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{case} rank {r}:\n{err[-6000:]}"
    results = []
    for r in range(world):
        path = os.path.join(workdir, f"out{r}.pt")
        results.append(dict(torch.load(path, weights_only=False),
                            stdout=outs[r][0]))
        os.remove(path)  # a step's results take hundreds of MB
    if spec is not None:
        os.remove(os.path.join(workdir, "spec.pt"))
    return results


def _bn_inputs(dim):
    """A float64 global batch of 4 with per-channel offsets and scales and
    a rank-1 half far from the rank-0 half, its cotangent, and the
    BatchNorm's seeded weight, bias and running statistics."""
    rng = np.random.default_rng(dim)
    shape = (4, 3, 5, 6) + (4,) * (dim - 2)
    x = rng.normal(size=shape) * rng.uniform(0.5, 3, (1, 3) + (1,) * dim)
    x += rng.uniform(-2, 2, (1, 3) + (1,) * dim)
    x[2:] = 4.0 * x[2:] + np.array([7.0, -5.0, 0.5]).reshape(
        (1, 3) + (1,) * dim)
    g = rng.normal(size=shape)
    state = {k: torch.from_numpy(rng.uniform(lo, hi, 3)) for k, lo, hi in
             (("weight", 0.5, 1.5), ("bias", -1, 1),
              ("running_mean", -0.5, 0.5), ("running_var", 0.5, 1.5))}
    return torch.from_numpy(x), torch.from_numpy(g), state


def _plain_bn(dim, state):
    bn = (torch.nn.BatchNorm2d if dim == 2 else torch.nn.BatchNorm3d)(3)
    bn.double().load_state_dict(dict(state,
                                     num_batches_tracked=torch.tensor(0)))
    return bn


def _case_syncbn(spec, rank, world):
    out = {}
    for dim in (2, 3):
        x, g, state = _bn_inputs(dim)
        rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
        models = convert_sync_batchnorm({"bn": torch.nn.Sequential(
            _plain_bn(dim, state))})
        bn = models["bn"][0]
        assert isinstance(bn, SyncBatchNorm)
        bn.train()
        xl = x[rows].clone().requires_grad_(True)
        y = bn(xl)
        (y * g[rows]).sum().backward()
        D.all_reduce_grads(models)
        plain = _plain_bn(dim, state)
        plain.load_state_dict(bn.state_dict())
        bn.eval()
        plain.eval()
        out[dim] = {"y": y.detach(), "dx": xl.grad,
                    "dw": bn.weight.grad, "db": bn.bias.grad,
                    "mean": bn.running_mean.clone(),
                    "var": bn.running_var.clone(),
                    "tracked": int(bn.num_batches_tracked),
                    "eval_equal": torch.equal(bn(x[rows]), plain(x[rows]))}
    return out


def _mask_inputs():
    """x (4, 40, 50, 1) float64 and a mask with 10 set pixels in the rank-0
    half and 1000 in the rank-1 half."""
    rng = np.random.default_rng(7)
    x = rng.normal(2.0, 1.0, (4, 40, 50, 1))
    mask = np.zeros(x.shape)
    for half, count in ((0, 10), (1, 1000)):
        flat = mask[2 * half:2 * half + 2].reshape(-1)
        flat[rng.choice(flat.size, count, replace=False)] = 1.0
    x[2:] += 3.0  # the two halves' means differ
    return torch.from_numpy(x), torch.from_numpy(mask)


def _case_masked_mean(spec, rank, world):
    x, mask = _mask_inputs()
    rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
    xl = x[rows].clone().requires_grad_(True)
    value = masked_mean(xl, mask[rows], group=D.default_group())
    value.backward()
    return {"value": value.detach(), "dx": xl.grad,
            "local": masked_mean(x[rows], mask[rows])}


def _gap_to_rank0(tensors):
    """The largest absolute difference of these tensors from rank 0's."""
    flat = torch.cat([t.detach().double().reshape(-1) for t in tensors])
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0)
    return float((flat - ref).abs().max())


def _case_step(spec, rank, world):
    """One train_step per job on this rank's rows of the spec's global
    batch, with the models' BatchNorms synchronized: the losses; rank 0's
    gradients after the all-reduce and state (parameters after Adam,
    BatchNorm statistics); each rank's largest difference from rank 0 in
    both."""
    cfg = Config.from_json(spec["cfg"])
    out = []
    for job in spec["jobs"]:
        models = build_models(cfg, "cpu")
        for name, m in models.items():
            m.load_state_dict(spec["states"][name])
        convert_sync_batchnorm(models, D.default_group())
        D.broadcast_models(models)
        b = len(spec["batch"]["color"]) // world
        rows = slice(rank * b, (rank + 1) * b)
        batch = P.as_batch({k: v[rows] for k, v in spec["batch"].items()},
                           "cpu")
        if job["draws"] is None:
            draws = P.sample_draws(cfg, b, torch.Generator().manual_seed(
                job["seed"]), "cpu", rank, world)
        else:
            draws = dict(job["draws"], noise=[n[rows] for n in
                                              job["draws"]["noise"]])
        opt, sched = S.create_optimizer(models, cfg)
        losses, _ = S.train_step(models, opt, sched, batch, cfg,
                                 job["use_z"], draws, D.default_group())
        grads = {n: {k: p.grad for k, p in m.named_parameters()}
                 for n, m in models.items()}
        state = {n: m.state_dict() for n, m in models.items()}
        out.append({
            "losses": {k: float(v) for k, v in losses.items()},
            "grad_gap": _gap_to_rank0([g for d in grads.values()
                                       for g in d.values()]),
            "state_gap": _gap_to_rank0([v for d in state.values()
                                        for v in d.values()]),
            # only rank 0's: the files are hundreds of MB a job
            "grads": grads if rank == 0 else None,
            "params": state if rank == 0 else None})
    return {"jobs": out}


def _state(trainer):
    """Every tensor of a trainer's models (BatchNorm statistics included)
    and of Adam's state, in a fixed order."""
    adam = trainer.optimizer.state_dict()["state"]
    return ([v for n in sorted(trainer.models)
             for v in trainer.models[n].state_dict().values()]
            + [v for i in sorted(adam) for _, v in sorted(adam[i].items())])


def _case_trainer(spec, rank, world):
    """A tiny tree at 2 ranks: one epoch, a restore from ``last`` for a
    second, then a val list with one line."""
    from movedepth_tpu_torch.train import checkpoints as C
    from movedepth_tpu_torch.train.trainer import Trainer
    sys.modules["tensorboardX"] = None  # the logger's jsonl writer
    saves = []
    save = C.save_checkpoint

    def spy(*args, **kw):
        saves.append(kw)
        return save(*args, **kw)

    C.save_checkpoint = spy
    group = D.default_group()
    cfg = Config.from_json(spec["cfg"])
    trainer = Trainer(cfg, split_dir=spec["splits"] + "/tiny", device="cpu",
                      rank=rank, world_size=world, group=group)
    logged = []
    host_losses = trainer._host_losses

    def record(*args):
        logged.append(host_losses(*args))
        return logged[-1]

    trainer._host_losses = record
    trainer.train()
    out = {"train_shard": trainer.train_loader.sampler.epoch_indices(0),
           "val_shard": trainer.val_loader.sampler.epoch_indices(0),
           "loader_len": len(trainer.train_loader),
           "steps_per_epoch": trainer.steps_per_epoch,
           "step": trainer.step, "logged": logged, "saves": list(saves),
           "trained_gap": _gap_to_rank0(_state(trainer))}
    trained = [t.clone() for t in _state(trainer)]
    last = os.path.join(cfg.log_dir, cfg.model_name, "models", "last")
    resumed = Trainer(cfg.replace(load_weights_folder=last, num_epochs=2,
                                  model_name="resumed"),
                      split_dir=spec["splits"] + "/tiny", device="cpu",
                      rank=rank, world_size=world, group=group)
    out["resumed_step"] = resumed.step
    restored = _state(resumed)
    out["resumed_gap"] = _gap_to_rank0(restored)
    out["adam_states"] = len(resumed.optimizer.state)
    out["restored_diff"] = max(float((a.double() - b.double()).abs().max())
                               for a, b in zip(restored, trained))
    out["restored_count"] = (len(restored), len(trained))
    resumed.train()
    out["final_step"] = resumed.step
    out["final_gap"] = _gap_to_rank0(_state(resumed))
    try:
        Trainer(cfg.replace(model_name="oneval"),
                split_dir=spec["splits"] + "/oneval", device="cpu",
                rank=rank, world_size=world, group=group)
    except ValueError as e:
        out["oneval_error"] = str(e)
    # last: the train CLI, which leaves the process group at its end
    from movedepth_tpu_torch.cli import train as cli_train
    cli = cli_train.main(spec["cli_argv"])
    out["cli"] = {"step": cli.step, "rank": cli.rank}
    return out


CASES = {"syncbn": _case_syncbn, "masked_mean": _case_masked_mean,
         "step": _case_step, "trainer": _case_trainer}


def _rank_main(case, workdir):
    torch.set_num_threads(1)
    D.initialize_distributed(
        "cpu", init_method=f"file://{os.path.join(workdir, 'rendezvous')}")
    spec_path = os.path.join(workdir, "spec.pt")
    spec = (torch.load(spec_path, weights_only=False)
            if os.path.exists(spec_path) else None)
    rank, world = D.rank(), D.world_size()
    out = CASES[case](spec, rank, world)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    if D.is_distributed():  # the CLI leaves the group itself
        D.barrier()
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ helpers

def port_states(cfg=CFG, seed=42):
    """Seeded port weights with the pose head x40 (a few-pixel motion, as
    tests/test_torch_port_pipeline.py conditions it)."""
    models = build_models(cfg, "cpu", torch.Generator().manual_seed(seed))
    states = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in models.items()}
    for k in list(states["pose"]):
        if k.startswith("net.3."):
            states["pose"][k] = states["pose"][k] * 40.0
    return states


def rel_l2(got, want):
    """Relative L2 distance over the tensors of two name -> tensor maps."""
    num = sum(float((got[k].double() - want[k].double()).norm() ** 2)
              for k in want)
    den = sum(float(want[k].double().norm() ** 2) for k in want)
    return (num / den) ** 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ SyncBN

@pytest.fixture(scope="module")
def syncbn_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("syncbn"), "syncbn")


@pytest.mark.parametrize("dim", [2, 3])
def test_sync_batchnorm_matches_batchnorm_on_the_global_batch(syncbn_ranks,
                                                              dim):
    """2 ranks, whose halves differ in every channel's mean and scale,
    against nn.BatchNorm on the concatenated batch in float64: outputs,
    input gradients, weight and bias gradients (the ranks' average times
    the world size) and running statistics within 1e-10; in eval mode
    nn.BatchNorm bit for bit."""
    x, g, state = _bn_inputs(dim)
    bn = _plain_bn(dim, state).train()
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * g).sum().backward()
    for r, res in enumerate(syncbn_ranks):
        got = res[dim]
        rows = slice(r * 2, r * 2 + 2)
        for key, want in (("y", y[rows]), ("dx", xg.grad[rows]),
                          ("dw", bn.weight.grad / WORLD),
                          ("db", bn.bias.grad / WORLD),
                          ("mean", bn.running_mean),
                          ("var", bn.running_var)):
            np.testing.assert_allclose(got[key].numpy(),
                                       want.detach().numpy(), rtol=0,
                                       atol=1e-10, err_msg=f"rank {r} {key}")
        assert got["tracked"] == 1
        assert got["eval_equal"]


def test_sync_batchnorm_without_a_group_is_batchnorm():
    """No process group: train and eval mode, outputs, gradients and
    running statistics bit for bit nn.BatchNorm's; the swap keeps the
    parameter and buffer objects and the state_dict keys."""
    x, g, state = _bn_inputs(2)
    plain = _plain_bn(2, state)
    models = convert_sync_batchnorm({"m": torch.nn.Sequential(
        _plain_bn(2, state))})
    sync = models["m"][0]
    assert isinstance(sync, SyncBatchNorm)
    assert list(sync.state_dict()) == list(plain.state_dict())
    for train in (True, False):
        plain.train(train)
        sync.train(train)
        xa = x.clone().requires_grad_(True)
        xb = x.clone().requires_grad_(True)
        ya, yb = plain(xa), sync(xb)
        (ya * g).sum().backward()
        (yb * g).sum().backward()
        assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
        for k, v in plain.state_dict().items():
            assert torch.equal(v, sync.state_dict()[k]), k
    assert torch.equal(plain.weight.grad, sync.weight.grad)
    bn = torch.nn.BatchNorm2d(3)
    swapped = convert_sync_batchnorm({"m": torch.nn.Sequential(bn)})["m"][0]
    assert swapped.weight is bn.weight
    assert swapped.running_var is bn.running_var


# ------------------------------------------------------------ masked mean

def test_masked_mean_with_a_group_is_the_global_batch_mean(tmp_path):
    """Mask counts of 10 and 1000 on the two ranks: every rank holds the
    global value, a per-rank mean does not, and each rank's gradient is
    the world size times its rows of the global gradient (the scale the
    gradient all-reduce divides out)."""
    x, mask = _mask_inputs()
    xg = x.clone().requires_grad_(True)
    want = masked_mean(xg, mask)
    want.backward()
    ranks = run_ranks(tmp_path, "masked_mean")
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["value"]), float(want.detach()),
                                   rtol=1e-12)
        np.testing.assert_allclose(res["dx"].numpy() / WORLD,
                                   xg.grad[2 * r:2 * r + 2].numpy(),
                                   rtol=1e-12, atol=0)
    per_rank = np.mean([float(res["local"]) for res in ranks])
    assert abs(per_rank - float(want.detach())) > 0.5


# ------------------------------------------------------------ train step

def test_sample_draws_shard_the_global_draws():
    """Rank r's draws are rows [r*B, (r+1)*B) of one process's draws at
    the global batch, with the same box; at world 1 the default call."""
    cfg = CFG

    def draws(*args):
        return P.sample_draws(cfg, *args[:1], torch.Generator().manual_seed(
            3), "cpu", *args[1:])

    whole = draws(4)
    assert [n.shape[0] for n in whole["noise"]] == [4] * len(cfg.scales)
    for r in range(2):
        part = draws(2, r, 2)
        assert part["box"] == whole["box"]
        for a, b in zip(part["noise"], whole["noise"]):
            assert torch.equal(a, b[2 * r:2 * r + 2])
    single = draws(4, 0, 1)
    assert single["box"] == whole["box"]
    assert all(torch.equal(a, b) for a, b in zip(single["noise"],
                                                  whole["noise"]))


def test_train_step_without_a_group_is_unchanged():
    """SyncBatchNorm in the models but no process group: the train step's
    losses, gradients and updated parameters are the plain models' bit for
    bit."""
    states = port_states()
    batch = P.synthetic_batch(CFG, 2, seed=5, device="cpu")
    results = []
    for sync in (False, True):
        models = build_models(CFG, "cpu")
        for name, m in models.items():
            m.load_state_dict(states[name])
        if sync:
            convert_sync_batchnorm(models)
        opt, sched = S.create_optimizer(models, CFG)
        draws = P.sample_draws(CFG, 2, torch.Generator().manual_seed(1),
                               "cpu")
        losses, _ = S.train_step(models, opt, sched, batch, CFG, False,
                                 draws)
        results.append((losses, models))
    (la, ma), (lb, mb) = results
    assert all(torch.equal(la[k], lb[k]) for k in la)
    for name in ma:
        for (k, p), q in zip(ma[name].named_parameters(),
                             mb[name].parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k


def _one_process_step(states, batch, threads=1):
    """The 1-process train step at the global batch of 4 on ``threads``
    torch threads: (losses, models with their gradients)."""
    models = build_models(CFG, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
    opt, sched = S.create_optimizer(models, CFG)
    draws = P.sample_draws(CFG, 4, torch.Generator().manual_seed(4), "cpu")
    torch.set_num_threads(threads)
    try:
        losses, _ = S.train_step(models, opt, sched, batch, CFG, False,
                                 draws)
    finally:
        torch.set_num_threads(1)
    return {k: float(v) for k, v in losses.items()}, models


@pytest.fixture(scope="module")
def port_2rank(tmp_path_factory):
    """The port at 2 ranks x 2 rows and in one process at 4 rows: the same
    weights, batch and draws (the ranks draw their rows of the global
    draws from the same seed); and the 1-process step on 4 threads."""
    states = port_states()
    batch = P.synthetic_batch(CFG, 4, seed=9, device="cpu")
    spec = {"cfg": CFG.to_json(), "states": states,
            "batch": {k: v.numpy() for k, v in batch.items()},
            "jobs": [{"use_z": False, "draws": None, "seed": 4}]}
    ranks = run_ranks(tmp_path_factory.mktemp("port_step"), "step", spec)
    losses, models = _one_process_step(states, batch)
    _, threaded = _one_process_step(states, batch, threads=4)
    return states, ranks, losses, models, threaded


def test_two_rank_step_matches_one_process_losses(port_2rank):
    """The mean over ranks of each loss against the 1-process step at the
    global batch, under tests/test_torch_port_train.py's tolerances."""
    _, ranks, want, _, _ = port_2rank
    for key, value in want.items():
        got = np.mean([res["jobs"][0]["losses"][key] for res in ranks])
        rtol = 1e-3 if key.startswith(LOOSE) else 2e-4
        np.testing.assert_allclose(got, value, rtol=rtol, atol=2e-6,
                                   err_msg=key)


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


def test_two_rank_step_matches_one_process_gradients(port_2rank):
    """Every model's averaged gradient, equal on both ranks, against the
    1-process one within tests/test_torch_port_train.py's GRAD_TOL or
    twice the distance between the 1-process gradients on 1 and 4 threads,
    whichever is larger: a float32 gradient of the cost-volume models is
    fixed only up to the order of its sums (3.5e-2 between 1 and 8
    threads here), and two ranks sum in another order."""
    _, ranks, _, models, threaded = port_2rank
    tol = {"mvs_encoder": 2.5e-2, "reg3d": 2.5e-2}
    for name, model in models.items():
        want = _grads(model)
        got = ranks[0]["jobs"][0]["grads"][name]
        spread = rel_l2(_grads(threaded[name]), want)
        gap = rel_l2(got, want)
        assert gap <= max(tol.get(name, 5e-3), 2 * spread), (name, gap,
                                                              spread)
    assert ranks[1]["jobs"][0]["grad_gap"] == 0.0


def test_two_rank_step_updates_with_the_averaged_gradients(port_2rank):
    """The parameters and BatchNorm statistics after the step are equal on
    both ranks, and the parameters are Adam's step from the averaged
    gradients."""
    states, ranks, _, _, _ = port_2rank
    a = ranks[0]["jobs"][0]
    assert ranks[1]["jobs"][0]["state_gap"] == 0.0
    models = build_models(CFG, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
        for k, p in m.named_parameters():
            p.grad = a["grads"][name][k].clone()
    opt, sched = S.create_optimizer(models, CFG)
    opt.step()
    for name, m in models.items():
        pa = a["params"][name]
        for k, p in m.named_parameters():
            np.testing.assert_allclose(pa[k].numpy(), p.detach().numpy(),
                                       rtol=0, atol=1e-7,
                                       err_msg=f"{name}.{k}")


# ------------------------------------------------------------ CLI

def test_cli_refuses_several_cards_without_torchrun(monkeypatch):
    from movedepth_tpu_torch.cli import train as cli_train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit) as e:
        cli_train.main(["--data_path", "unused"])
    msg = str(e.value)
    assert "torchrun --nproc_per_node 2 -m movedepth_tpu_torch.cli.train" \
        in msg, msg
    assert "--no-multichip" in msg


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
