"""The benchmark's arithmetic on inputs with known answers: the idle union,
the window rate, the tail, the bound, the import check."""

from types import SimpleNamespace

import pytest

from mdbench import check, harness, readers, trace, work


def test_union_of_overlapping_intervals():
    busy = trace.merged([(5, 8), (0, 2), (1, 3), (7, 9), (20, 30)], 0, 25)
    assert busy == [[0, 3], [5, 9], [20, 25]]
    assert trace.gaps(busy, 0, 25) == [(3, 5), (9, 20)]


def test_summarize_busy_idle_and_breakdown():
    ev = [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0,
         "dur": 100.0},
        {"cat": "user_annotation", "name": "mdbench.put", "ts": 10.0,
         "dur": 30.0},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 12.0, "dur": 20.0},
        {"cat": "kernel", "name": "k1", "ts": 0.0, "dur": 10.0},
        {"cat": "kernel", "name": "k1", "ts": 5.0, "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40.0,
         "dur": 20.0},
        {"cat": "kernel", "name": "k2", "ts": 90.0, "dur": 20.0},
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((15 + 20 + 10) * 1e-6)
    assert s["breakdown"]["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    gap = s["breakdown"]["idle_gaps"][0]
    assert gap[1] == pytest.approx(30e-6)  # 60 .. 90
    assert s["breakdown"]["idle_gaps"][1] == [
        "mdbench.put/aten::copy_", pytest.approx(25e-6)]  # 15 .. 40
    run = SimpleNamespace(profile=s)
    assert readers.idle_pct(run) == pytest.approx(55.0)
    assert trace.summarize(ev[1:]) is None


def test_rate_and_tail():
    run = SimpleNamespace(items=600, window_s=2.0)
    assert readers.window_rate(run) == 300.0
    vals = list(range(1, 101))
    assert readers.p95(vals) == 95
    assert readers.p95([3.0]) == 3.0
    assert readers.p95([]) is None


def test_roofline_reads_the_kernels_it_names():
    prof = {"kernels": [("void sweep_warp_corr_kernel<bf16, 32, 16, 0>", 2e-3),
                        ("void sweep_warp_corr_kernel<bf16, 32, 16, 0>", 2e-3),
                        ("void other<>", 1.0)]}
    run = SimpleNamespace(profile=prof, traced_units=2)
    assert readers.roofline(run, [(r"sweep_warp_corr_kernel<", 1, 1.0)]) \
        == pytest.approx(50.0)
    assert readers.roofline(run, [(r"missing<", 1, 1.0)]) is None


def test_bound():
    assert work.bound_ms(3.35e12, 0) == pytest.approx(1000.0)
    assert work.bound_ms(0, 67e12) == pytest.approx(1000.0)
    nbytes, flops = work.sweep_corr_work(1, 2, 3, 4, 5, 2, 2, 2)
    pts = 1 * 5 * 2 * 3
    assert nbytes == 1 * 4 * 3 * 4 * 2 + 8 * pts + pts * 2 * 2
    assert flops == pts * (32 + 4 + 4 + 2 + 8)


def test_import_check_compares_top_level_names_whole():
    assert harness.forbidden_modules({"movedepth_tpu": 1}) == ["movedepth_tpu"]
    assert harness.forbidden_modules({"movedepth_tpu.ops.x": 1}) == [
        "movedepth_tpu.ops.x"]
    assert harness.forbidden_modules({"jax": 1, "jax.numpy": 1, "jaxlib": 1,
                                      "flax.linen": 1}) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib"]
    assert harness.forbidden_modules({"movedepth_tpu_torch": 1,
                                      "movedepth_tpu_torch.ops": 1,
                                      "jaxtyping": 1}) == []


def test_worst_leaf_and_quiet_leaves():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert check.worst_leaf({"a": 1.1, "b": 2.0, "c": 0.0}, ref) == \
        pytest.approx(0.1)
    assert check.moving_leaves(ref) == ["a", "b"]
    assert check.worst_leaf({"a": 1.0, "b": 2.0, "c": 5.0}, ref,
                            ["a", "b"]) == 0.0
    assert check.loss_gap(float("nan"), 1.0) == float("inf")


def test_judge_needs_every_number_under_its_limit():
    checks, ok = harness.judge({"x": 1.0, "y": 2.0, "z": 9.0},
                               {"x": 2.0, "y": 2.0})
    assert ok and checks["y"] == {"value": 2.0, "limit": 2.0}
    assert "z" not in checks
    assert not harness.judge({"x": 1.0}, {})[1]
    assert harness.judge({"x": 1.0}, {})[0] == {
        "x": {"value": 1.0, "limit": None}}
    assert not harness.judge({"x": float("inf")}, {"x": 1.0})[1]
    assert not harness.judge({}, {"x": 1.0})[1]
