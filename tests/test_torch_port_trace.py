"""The port's tracer (``movedepth_tpu_torch/trace.py``): spans and
counters at the layer boundaries, on the CPU at 64x96; the cases that
need CUDA events or a CUDA graph are marked ``cuda`` and skip without a
card. This file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_trace.py
"""

import copy
import time

import pytest
import torch

from movedepth_tpu_torch import Config
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch import trace
from movedepth_tpu_torch.cli import export_model as EM
from movedepth_tpu_torch.data.synthetic import make_batch
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops import TRAIN_KERNELS, kernel_launches
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.train import trainer as T

CFG = Config(height=64, width=96, num_depth_bins=8, compute_dtype="float32")
INFER_SPANS = {"pipeline.as_batch": [None],
               "as_batch.host_copy": ["pipeline.as_batch"],
               "infer.mono": [None], "infer.mvs": [None],
               "infer.reg3d": ["infer.mvs"]}
TRAIN_SPANS = {"train.step": [None], "train.forward": ["train.step"],
               "train.losses": ["train.forward"],
               "train.backward": ["train.step"],
               "train.optimizer": ["train.step"]}


@pytest.fixture(autouse=True)
def tracer():
    """Each test starts from an empty tracer, off, and leaves it so."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def models():
    return build_models(CFG, "cpu", torch.Generator().manual_seed(0))


def _infer(models, device="cpu"):
    host = make_batch(CFG.replace(frame_ids=CFG.matching_ids), 2, 0)
    batch = P.as_batch({k: host[k] for k in ("color", "K", "inv_K")},
                       device)
    return host, P.forward_infer_fused(models, batch, CFG)


def _train(models, device="cpu", on=False, events=True):
    """One train_step from a copy of ``models``; ``on``: the tracer on for
    the step alone (``events``: with CUDA events)."""
    models = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
    opt, sched = S.create_optimizer(models, CFG)
    batch = P.synthetic_batch(CFG, 2, seed=1, device=device)
    draws = P.sample_draws(CFG, 2, torch.Generator(device).manual_seed(2),
                           device)
    if on:
        trace.enable(device=events)
    losses, _ = S.train_step(models, opt, sched, batch, CFG, True, draws)
    return losses


def _parents(summ):
    return {name: s["parents"] for name, s in summ["spans"].items()}


def test_off_span_is_one_shared_object_and_records_nothing(models):
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b") is trace.OFF
    with trace.span("a") as s:
        assert s is trace.OFF
    _infer(models)
    _train(models)
    summ = trace.summary()
    assert summ["spans"] == {}
    # counters are always on
    assert summ["counters"]["h2d_bytes"] > 0


def test_off_span_costs_under_a_microsecond():
    """The cost of an off span on the host: the best of 5 runs of 20000
    ``with trace.span(...)`` blocks, against 1 us (generous on purpose)."""
    n, best = 20000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("train.step"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    assert best < 1000, f"{best:.0f} ns an off span"


def test_inference_spans_parents_and_bytes(models):
    trace.enable()
    host, _ = _infer(models)
    summ = trace.summary()
    assert _parents(summ) == INFER_SPANS
    calls = {name: s["calls"] for name, s in summ["spans"].items()}
    assert calls == dict.fromkeys(INFER_SPANS, 1) | {
        "as_batch.host_copy": 3}  # one a key
    assert all(s["device_ms"] is None for s in summ["spans"].values())
    nbytes = sum(host[k].nbytes for k in ("color", "K", "inv_K"))
    assert summ["counters"]["h2d_bytes"] == nbytes
    assert summ["counters"]["h2d_pageable_bytes"] == nbytes


def test_train_spans_parents_and_self_time(models):
    _train(models, on=True)
    summ = trace.summary()
    assert _parents(summ) == TRAIN_SPANS
    spans = summ["spans"]
    for name, s in spans.items():
        kids = [k for k, p in TRAIN_SPANS.items() if p == [name]]
        want = s["host_ms"] - sum(spans[k]["host_ms"] for k in kids)
        assert s["self_host_ms"] == pytest.approx(want, abs=1e-9), name
        assert 0 <= s["self_host_ms"] <= s["host_ms"] <= s["host_max_ms"]
    assert summ["counters"].get("all_reduce_bytes") is None  # no group


def test_self_time_of_nested_spans():
    """Self time is the duration less what the children cover: two
    children, one grandchild."""
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.002)
        with trace.span("child"):
            with trace.span("grandchild"):
                time.sleep(0.002)
        with trace.span("child"):
            time.sleep(0.002)
    s = trace.summary()["spans"]
    assert s["child"]["calls"] == 2
    assert s["grandchild"]["parents"] == ["child"]
    assert s["outer"]["self_host_ms"] == pytest.approx(
        s["outer"]["host_ms"] - s["child"]["host_ms"], abs=1e-9)
    assert s["child"]["self_host_ms"] == pytest.approx(
        s["child"]["host_ms"] - s["grandchild"]["host_ms"], abs=1e-9)
    assert s["outer"]["self_host_ms"] >= 2.0
    assert s["child"]["host_max_ms"] >= 2.0


def test_outputs_and_losses_are_bitwise_equal_on_and_off(models):
    _, off = _infer(models)
    loss_off = _train(models)
    trace.enable()
    _, on = _infer(models)
    loss_on = _train(models, on=True)
    assert "train.step" in trace.summary()["spans"]
    assert sorted(on) == sorted(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    for k in loss_off:
        assert torch.equal(loss_on[k], loss_off[k]), k


def test_export_is_the_same_with_the_tracer_on(models):
    """torch.export traces the serving forward with every span a no-op:
    the same graph, and no span recorded."""
    off = EM.build_export(CFG, models, False, 1, "cpu")
    trace.enable()
    on = EM.build_export(CFG, models, False, 1, "cpu")
    assert str(on.graph) == str(off.graph)
    assert trace.summary()["spans"] == {}


def test_recompute_lands_under_the_backward():
    """A rematerialized block's spans: under the forward's span where it
    runs first, under ``train.backward`` where the backward runs it
    again."""
    lin = torch.nn.Linear(4, 4)

    def block(x):
        with trace.span("block"):
            return torch.tanh(lin(x))

    trace.enable()
    x = torch.randn(3, 4, requires_grad=True)
    with trace.span("train.forward"):
        y = P._checkpointed({}, block, x)
    with trace.span("train.backward"):
        y.sum().backward()
    s = trace.summary()["spans"]
    assert s["block"]["calls"] == 2
    assert s["block"]["parents"] == ["train.backward", "train.forward"]


def test_counters_and_the_launch_view():
    trace.count("launch.sweep_warp", 2)
    trace.count("launch.sweep_warp")
    trace.count("h2d_bytes", 10)
    assert kernel_launches() == dict.fromkeys(TRAIN_KERNELS, 0) | {
        "sweep_warp": 3}
    assert trace.counters() == {"launch.sweep_warp": 3, "h2d_bytes": 10}
    trace.reset()
    assert set(kernel_launches().values()) == {0}
    assert trace.counter("h2d_bytes") == 0


def test_traced_decorator_checks_the_flag_at_each_call():
    @trace.traced("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert trace.summary()["spans"] == {}
    trace.enable()
    assert f(1) == 2
    assert trace.summary()["spans"]["decorated"]["calls"] == 1
    assert f.__name__ == "f"


def test_per_call_table():
    trace.enable()
    for _ in range(4):
        with trace.span("x"):
            pass
    trace.count("c", 5)
    table = T.per_call(trace.summary())
    x = table["spans"]["x"]
    assert x["calls"] == 4 and x["device_ms_mean"] is None
    assert x["host_ms_mean"] <= x["host_ms_max"]
    assert table["counters"] == {"c": 5}


def test_ranges_only_while_a_profiler_records():
    """An on span opens a ``movedepth.<name>`` profiler range while a
    profiler records, and none without one."""
    trace.enable()
    with trace.span("x") as sp:
        assert sp.range is None
    with torch.profiler.profile() as prof:
        with trace.span("x") as sp:
            assert sp.range is not None
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "movedepth.x" in names
    assert trace.summary()["spans"]["x"]["calls"] == 2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA events and graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_time_the_device_on_the_card(device, models):
    """Each span records a pair of CUDA events: device ms for every call
    on the card; the forward's and the step's kernels are counted."""
    cuda_models = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
    trace.enable()
    _infer(cuda_models, device)
    infer = trace.summary()
    trace.disable()
    trace.reset()
    _train(cuda_models, device, on=True)
    train = trace.summary()
    assert _parents(infer) == INFER_SPANS
    assert _parents(train) == TRAIN_SPANS
    for name, s in {**infer["spans"], **train["spans"]}.items():
        assert s["device_calls"] == s["calls"] >= 1, name
        assert s["device_ms"] > 0, name
    assert infer["counters"]["launch.sweep_warp_corr"] == 1
    assert train["counters"]["launch.sweep_warp"] == 1
    trace.disable()
    trace.reset()
    _train(cuda_models, device, on=True, events=False)  # the host alone
    host = trace.summary()
    assert _parents(host) == TRAIN_SPANS
    assert all(s["device_calls"] == 0 and s["device_ms"] is None
               for s in host["spans"].values())


@pytest.mark.cuda
def test_graph_replay_adds_captured_launches_once(device, models):
    """A captured step's launches come off the counters at the capture and
    are added once per replay; a span records no events under the
    capture."""
    cuda_models = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
    opt, sched = S.create_optimizer(cuda_models, CFG)
    multi = S.make_train_multistep(cuda_models, opt, sched, CFG)
    batches = [P.synthetic_batch(CFG, 2, seed=i, device=device)
               for i in range(2)]
    gen = torch.Generator(device).manual_seed(0)
    draws = [P.sample_draws(CFG, 2, gen, device) for _ in batches]
    trace.enable()
    multi(batches, draws, True)  # warm-up, capture, 2 replays
    torch.cuda.synchronize()
    fwd = trace.summary()["spans"]["train.forward"]
    assert fwd["calls"] == S.WARMUP_STEPS + 1  # the warm-up and the capture
    assert fwd["device_calls"] == S.WARMUP_STEPS  # none under the capture
    graph = multi.graphs[True]
    per_replay = {k: n for k, n in graph.counts.items()
                  if k.startswith("launch.")}
    assert per_replay["launch.sweep_warp"] == 1
    assert per_replay["launch.sweep_warp_bwd"] == 1
    trace.reset()
    multi(batches, draws, True)  # 2 replays
    torch.cuda.synchronize()
    for k, n in per_replay.items():
        assert trace.counter(k) == 2 * n, k
    assert trace.summary()["spans"] == {}  # a replay runs no span
