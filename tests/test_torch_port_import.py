"""Import hygiene of the PyTorch port, its own copies of the JAX package's
jax-free modules, and the refusal of chip_smoke.py and the kernel-variant
module to run without a GPU."""

import dataclasses
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import movedepth_tpu_torch
from movedepth_tpu.config import Config as JaxConfig
from movedepth_tpu.data.synthetic import make_batch as jax_make_batch
from movedepth_tpu_torch import Config
from movedepth_tpu_torch import profile_kernel_variants as PKV
from movedepth_tpu_torch.data.synthetic import make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every module of the port, found by walking the package
PORT_MODULES = tuple(sorted(
    ["movedepth_tpu_torch"]
    + [m.name for m in pkgutil.walk_packages(movedepth_tpu_torch.__path__,
                                             "movedepth_tpu_torch.")]))


def _python(code_or_args, cwd=REPO):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) \
        else code_or_args
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    """Importing every module of the port loads nothing of the JAX package
    (not even its jax-free modules) and no jax, jaxlib, flax, optax or
    orbax."""
    assert "movedepth_tpu_torch.train.trainer" in PORT_MODULES
    assert "movedepth_tpu_torch.data.kitti" in PORT_MODULES
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('movedepth_tpu', 'jax', 'jaxlib', 'flax',\n"
            "              'optax', 'orbax'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_config_copy_matches_jax_package():
    """Every field, with its name, type annotation and default."""
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(Config)]
    assert got == want
    assert Config().num_scales == JaxConfig().num_scales
    assert Config().prior_hw == JaxConfig().prior_hw


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_opt_json_loads_in_both_packages(writer):
    kw = dict(height=64, width=96, scales=(0, 1), kernel_l1=True,
              models_to_load=("mono_encoder", "mono_depth"),
              load_weights_folder="/w")
    text = (JaxConfig if writer == "jax" else Config)(**kw).to_json()
    assert dataclasses.asdict(Config.from_json(text)) == dataclasses.asdict(
        JaxConfig.from_json(text))
    assert Config.from_json(text) == Config(**kw)


@pytest.mark.parametrize("with_pose", [False, True])
def test_make_batch_copy_matches_jax_package(with_pose):
    cfg = Config(height=64, width=96, frame_ids=(0, -1, 1))
    jcfg = JaxConfig(height=64, width=96, frame_ids=(0, -1, 1))
    got = make_batch(cfg, 2, seed=5, with_pose=with_pose)
    want = jax_make_batch(jcfg, 2, seed=5, with_pose=with_pose)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kernel_variants_refuse_without_a_gpu():
    """The stage-ablation module imports here; it runs only on a card."""
    assert list(PKV.VARIANTS) == ["full", "no_gather", "no_weights",
                                  "no_correlate", "no_reduce"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        PKV.main(["2"])
    x = torch.zeros(1, 4, 8, 32, dtype=torch.bfloat16)
    c = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        PKV.run_variant("full", x, x, c, c)
    proc = _python(["-m", "movedepth_tpu_torch.profile_kernel_variants"])
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


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
