"""CPU tests of the port's model factory's default device and of the
kernel build report that the card run prints.

The kernels themselves run only on the card (tests/test_torch_port_cuda.py).
"""

import inspect

import pytest
import torch

from movedepth_tpu_torch import Config, native
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops.masking import sample_box


def test_factory_defaults_to_the_card():
    """build_models, synthetic_batch, sample_draws and sample_box put their
    tensors on the card unless the caller asks for the CPU; without a card
    they raise rather than fall back."""
    for fn in (build_models, P.synthetic_batch, P.sample_draws, sample_box):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults do not raise here")
    cfg = Config(height=64, width=96)
    with pytest.raises((RuntimeError, AssertionError)):
        build_models(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        P.synthetic_batch(cfg, 1)
    with pytest.raises((RuntimeError, AssertionError)):
        P.sample_draws(cfg, 1)
    with pytest.raises((RuntimeError, AssertionError)):
        sample_box(64, 96, (21, 32))


def test_factory_on_the_cpu_when_asked():
    cfg = Config(height=64, width=96)
    models = build_models(cfg, "cpu")
    assert all(p.device.type == "cpu" for m in models.values()
               for p in m.parameters())
    batch = P.synthetic_batch(cfg, 1, device="cpu")
    assert all(v.device.type == "cpu" for v in batch.values())
    draws = P.sample_draws(cfg, 1, torch.Generator().manual_seed(0),
                           device="cpu")
    assert all(n.device.type == "cpu" for n in draws["noise"])


def test_ptxas_report_reads_registers_spills_and_shared_memory(monkeypatch):
    report = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooPf",
        "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 1024 bytes "
        "smem, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3barPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 400 bytes cmem[0]"])
    monkeypatch.setitem(native.build_reports, "fake", (1.0, report))
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")  # no cu++filt
    assert native.ptxas_report("fake") == [("_Z3fooPf", 72, 16, 8, 1024),
                                           ("_Z3barPf", 40, 0, 0, 0)]
    assert native.ptxas_report("never_built") == []
