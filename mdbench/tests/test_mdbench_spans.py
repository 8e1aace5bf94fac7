"""The readers of the program's own spans and counters over a fake tracer
summary: each reads its number, gives None where its span or counter is
missing or where the program has no tracer, and turns the tracer on."""

from types import SimpleNamespace

import pytest

from mdbench import harness, spans
from movedepth_tpu_torch import trace

READS = {
    "host_copy_ms.infer": 180.0 / 3,
    "h2d_mb.infer": 3 * 377503744 / 1e6 / 3,
    "reg3d_ms.infer": 90.0 / 3,
    "issue_ms.train": 400.0 / 4,
    "forward_issue_ms.train": 240.0 / 4,
    "backward_issue_ms.train": 120.0 / 4,
}
# the span or counter each reads
NEEDS = {"host_copy_ms.infer": ["as_batch.host_copy", "pipeline.as_batch"],
         "h2d_mb.infer": ["pipeline.as_batch", "h2d_bytes"],
         "reg3d_ms.infer": ["infer.reg3d"],
         "issue_ms.train": ["train.step"],
         "forward_issue_ms.train": ["train.forward"],
         "backward_issue_ms.train": ["train.backward"]}


def _span(calls, host_ms, device_ms=None):
    return {"calls": calls, "host_ms": host_ms, "host_max_ms": host_ms,
            "self_host_ms": host_ms, "device_ms": device_ms,
            "device_calls": calls if device_ms is not None else 0,
            "parents": [None]}


FAKE = {
    "spans": {"pipeline.as_batch": _span(3, 240.0, 250.0),
              "as_batch.host_copy": _span(9, 180.0),  # 3 arrays a batch
              "infer.reg3d": _span(3, 1.5, 90.0),
              "train.step": _span(4, 400.0, 560.0),
              "train.forward": _span(4, 240.0),
              "train.backward": _span(4, 120.0)},
    "counters": {"h2d_bytes": 3 * 377503744, "launch.sweep_warp": 4},
}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"mdbench_metric_{name}")


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_the_fake_summary(name, monkeypatch):
    monkeypatch.setattr(trace, "summary", lambda: FAKE)
    assert _reader(name).read(SimpleNamespace()) == pytest.approx(
        READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_none_without_its_span(name, monkeypatch):
    for gone in NEEDS[name]:
        fake = {"spans": {k: v for k, v in FAKE["spans"].items()
                          if k != gone},
                "counters": {k: v for k, v in FAKE["counters"].items()
                             if k != gone}}
        monkeypatch.setattr(trace, "summary", lambda fake=fake: fake)
        assert _reader(name).read(SimpleNamespace()) is None, gone


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_none_without_a_tracer(name, monkeypatch):
    """A program without ``movedepth_tpu_torch/trace.py`` (the parent of
    the change that added it): nothing to read, nothing raised."""
    monkeypatch.setattr(spans, "tracer", lambda: None)
    reader = _reader(name)
    run = SimpleNamespace()
    reader.instrument(run, None)
    assert reader.read(run) is None


def test_instrument_resets_and_enables_and_the_summary_is_taken_once(
        monkeypatch):
    trace.count("h2d_bytes", 5)
    calls = []
    real = trace.summary
    monkeypatch.setattr(trace, "summary",
                        lambda: calls.append(1) or real())
    run = SimpleNamespace()
    try:
        _reader("h2d_mb.infer").instrument(run, None)
        assert trace.enabled() and trace.counter("h2d_bytes") == 0
        assert not trace._device  # the host alone
        with trace.span("pipeline.as_batch"):
            trace.count("h2d_bytes", 2_000_000)
        assert _reader("h2d_mb.infer").read(run) == pytest.approx(2.0)
        assert _reader("issue_ms.train").read(run) is None
        assert len(calls) == 1
    finally:
        trace.disable()
        trace.reset()


def test_device_events_only_where_a_reader_of_the_cell_reads_them():
    """The train readers time the host alone; reg3d_ms.infer turns the
    events on for its cells, whatever order the readers come in."""
    try:
        for names, device in ((["issue_ms.train", "forward_issue_ms.train",
                                "backward_issue_ms.train"], False),
                              (["host_copy_ms.infer", "reg3d_ms.infer",
                                "h2d_mb.infer"], True),
                              (["reg3d_ms.infer", "host_copy_ms.infer"],
                               True)):
            run = SimpleNamespace()
            for name in names:
                _reader(name).instrument(run, None)
            assert trace.enabled() and trace._device is device, names
            trace.disable()
    finally:
        trace.enable(device=True)  # back to the default mode
        trace.disable()
        trace.reset()


def test_every_new_reader_has_its_manifest_entry():
    bench = harness.manifest()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READS:
        m = entries[name]
        cells = ["r18-train"] if name.endswith(".train") else [
            "r18-offline", "r50-offline"]
        assert m["workloads"] == cells
        assert m["source"] == ("program_counter" if name == "h2d_mb.infer"
                               else "program_span")
