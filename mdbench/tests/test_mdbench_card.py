"""One cell's run on the card, short: set-up, window, trace and check.
Run on the card with ``python -m pytest --noconftest mdbench/tests``."""

import pytest
import torch

from mdbench import harness


@pytest.mark.cuda
def test_stream_cell_runs_correct_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # r18-stream is kept in mdbench/dormant/, out of BENCHMARK.json
    manifest = harness.manifest
    monkeypatch.setattr(harness, "manifest",
                        lambda root=harness.ROOT: manifest(root, True))
    result, bad = harness.run_cell("r18-stream", 2 ** 31 + 11, 1.0, True)
    assert bad == []
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "idle_pct.stream" in result["metrics"]
