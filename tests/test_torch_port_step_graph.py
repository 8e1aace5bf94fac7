"""Which path ``train.state.train_step`` takes, on the CPU: the decision
between a replay of the captured step and an eager step, the counters of
both, and the key a capture is held under. The replays themselves run
only on the card (``tests/test_torch_port_cuda.py::
test_train_step_graph_matches_eager_steps`` and its neighbours)."""

import pytest
import torch

from movedepth_tpu_torch import Config
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch import trace
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.train import state as S

CFG = Config(height=64, width=96, num_depth_bins=8, compute_dtype="float32")
GROUP = object()  # stands for a process group: the decision only tests None


@pytest.fixture(autouse=True)
def tracer():
    trace.disable()
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("device, group, graphed", [
    ("cpu", None, False),
    ("cpu", GROUP, False),
    ("cuda", GROUP, False),
    ("cuda:0", GROUP, False),
    ("cuda", None, True),
    ("cuda:0", None, True),
])
def test_step_graphed_on_the_card_without_a_group(device, group, graphed):
    assert S.step_graphed(torch.device(device), group) is graphed


@pytest.fixture(scope="module")
def step_inputs():
    models = build_models(CFG, "cpu", torch.Generator().manual_seed(0))
    batches = [P.synthetic_batch(CFG, 2, seed=s, device="cpu")
               for s in (1, 2)]
    gen = torch.Generator().manual_seed(0)
    draws = [P.sample_draws(CFG, 2, gen, "cpu") for _ in batches]
    return models, batches, draws


def test_cpu_steps_are_eager_and_counted(step_inputs):
    """On the CPU no step is captured or replayed: a train_step call counts
    one eager step."""
    models, batches, draws = step_inputs
    opt, sched = S.create_optimizer(models, CFG)
    S.train_step(models, opt, sched, batches[0], CFG, True, draws[0])
    assert S.step_counts() == {"train.step_graph_captures": 0,
                               "train.step_graph_replays": 0,
                               "train.step_eager": 1}
    assert not S._captured.get(opt)


def _resized(batch, rows):
    return {k: v[:1].repeat(rows, *([1] * (v.dim() - 1)))
            for k, v in batch.items()}


@pytest.mark.parametrize("change", [
    "use_z_bins", "batch_rows", "batch_dtype", "noise_maps", "noise_shape"])
def test_capture_key_tells_inputs_apart(step_inputs, change):
    """A capture is keyed on use_z_bins and the shapes and dtypes of the
    batch and the draws: another batch of the same shapes shares the key,
    and each change here gives another."""
    _, batches, draws = step_inputs
    key = S._signature(True, batches[0], draws[0])
    assert S._signature(True, batches[1], draws[1]) == key
    batch, draw = batches[0], dict(draws[0])
    use_z = True
    if change == "use_z_bins":
        use_z = False
    elif change == "batch_rows":
        batch = _resized(batch, 3)
    elif change == "batch_dtype":
        batch = dict(batch, color=batch["color"].double())
    elif change == "noise_maps":
        draw["noise"] = draw["noise"][:-1]
    else:
        draw["noise"] = [n[:1] for n in draw["noise"]]
    assert S._signature(use_z, batch, draw) != key
