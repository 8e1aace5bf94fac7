"""The port's serving export (``cli/export_model.py``) on the CPU.

``build_export`` in mono and MVS modes, saved with ``torch.export.save``
and loaded back: the loaded program against the live port forward on the
same inputs (float32, rtol 1e-6), and against the JAX package's own
``build_export`` artifact on the same weights (a reference ``.pth`` folder
the port writes, which the JAX package's ``load_variables`` reads) and the
same numpy inputs, run as tests/test_serving.py runs it
(``platforms=("cpu",)``), under the forward-parity tolerances of
tests/test_torch_port_pipeline.py. Then the CLI with ``--device cpu
--check`` on that folder. 64x96, 8 bins, batch 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import export as jax_export

from movedepth_tpu.cli.evaluate import load_variables
from movedepth_tpu.cli.export_model import build_export as jax_build_export
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.cli import export_model as EM
from movedepth_tpu_torch.models import build_models
from test_torch_port_pipeline import CFG, H, W, _state_dicts

ECFG = CFG.replace(num_depth_bins=8)
# per output: the forward-parity tolerance of test_torch_port_pipeline
# (disparities absolute, depths relative as its CLI test takes them)
JAX_TOL = {"disp_mono": dict(atol=2e-5), "disp_mvs": dict(atol=1e-4),
           "depth_mvs": dict(rtol=1e-4), "depth_mono": dict(rtol=1e-5)}
NAMES = EM.OUTPUTS


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference .pth folder of seeded port weights (BN statistics
    perturbed, the pose head conditioned) and the port's models on it."""
    folder = tmp_path_factory.mktemp("export_weights")
    states = _state_dicts(ECFG)
    for name, sd in states.items():
        if name.endswith("encoder") and name != "mvs_encoder":
            sd = dict(sd, height=H, width=W)  # as a reference file has it
        torch.save(sd, folder / f"{name}.pth")
    models = build_models(ECFG, "cpu")
    for name, m in models.items():
        m.load_state_dict(states[name])
    return str(folder), models


@pytest.fixture(scope="module", params=[True, False], ids=["mono", "mvs"])
def exported(request, weights, tmp_path_factory):
    """(mono, the loaded program's outputs, the live forward's, the
    inputs as numpy)."""
    mono = request.param
    _, models = weights
    program = EM.build_export(ECFG, models, mono, 1, "cpu")
    path = tmp_path_factory.mktemp("export") / "movedepth.pt2"
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()
    path.unlink()  # ~110 MB of weights, in memory now
    inputs = EM.example_inputs(ECFG, mono, 1, "cpu")
    with torch.no_grad():
        got = [o.numpy() for o in loaded(*inputs)]
    batch = dict(zip(("color", "K", "inv_K"), inputs))
    live = (P.forward_mono_infer if mono else P.forward_infer)(
        models, batch, ECFG)
    want = [live[k].numpy() for k in NAMES[mono]]
    return mono, got, want, [t.numpy() for t in inputs]


def test_export_calls_the_kernel_ops(weights):
    """The MVS program calls the cost-volume kernel as its op, once per
    source frame; the mono program has no cost volume."""
    _, models = weights
    for mono, calls in ((False, 1), (True, 0)):
        program = EM.build_export(ECFG, models, mono, 1, "cpu")
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("movedepth.sweep_warp_corr.default") == calls
        user = program.graph_signature.user_inputs
        shapes = [tuple(n.meta["val"].shape) for n in program.graph.nodes
                  if n.op == "placeholder" and n.name in user]
        assert shapes == [(1, 1 if mono else 2, H, W, 3), (1, 4, 4),
                          (1, 4, 4)]


def test_loaded_program_matches_live_forward(exported):
    mono, got, want, _ = exported
    assert [g.shape for g in got] == [(1, H, W)] * len(NAMES[mono])
    for name, g, w in zip(NAMES[mono], got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)


def test_loaded_program_matches_jax_export(exported, weights):
    mono, got, _, inputs = exported
    folder, _ = weights
    cfg = ECFG.replace(load_weights_folder=folder)
    exp = jax_build_export(cfg, load_variables(cfg), mono=mono, batch=1,
                           platforms=("cpu",))
    fn = jax_export.deserialize(exp.serialize())
    want = fn.call(*(jnp.asarray(a) for a in inputs))
    assert len(want) == len(got)
    for name, g, w in zip(NAMES[mono], got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   **JAX_TOL[name])


def test_cli_check_roundtrip(weights, tmp_path, capsys):
    folder, _ = weights
    out = tmp_path / "cli.pt2"
    EM.main(["--load_weights_folder", folder, "--height", str(H),
             "--width", str(W), "--num_depth_bins", "8",
             "--compute_dtype", "float32", "--out", str(out),
             "--device", "cpu", "--check"])
    out.unlink()
    text = capsys.readouterr().out
    assert f"wrote {out}" in text and "device=cpu" in text
    assert f"roundtrip ok: outputs {[(1, H, W)] * 3}" in text
