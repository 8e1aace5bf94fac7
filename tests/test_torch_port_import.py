"""Import hygiene of the PyTorch port and the refusal of chip_smoke.py
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = (
    "movedepth_tpu_torch", "movedepth_tpu_torch.pipeline",
    "movedepth_tpu_torch.cli.infer", "movedepth_tpu_torch.models",
    "movedepth_tpu_torch.weights", "movedepth_tpu_torch.native",
    "movedepth_tpu_torch.ops.costvolume", "movedepth_tpu_torch.ops.geometry",
    "movedepth_tpu_torch.ops.losses", "movedepth_tpu_torch.ops.sampling",
    "movedepth_tpu_torch.ops.sweep_warp", "movedepth_tpu_torch.ops.upsample",
    "movedepth_tpu_torch.ops.image_warp", "movedepth_tpu_torch.ops.masking",
    "movedepth_tpu_torch.train", "movedepth_tpu_torch.train.state",
)


def _python(code_or_args, cwd=REPO):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) \
        else code_or_args
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_gpu(where, tmp_path):
    """No CUDA device here: the script must fail and print no ok line,
    from the checkout and from a directory holding only the script."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _python(["chip_smoke.py"], cwd=cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
