"""The port's experimental modules and host utilities against the JAX
package's, on the same inputs and weights.

Inputs come from a numpy seed at the sizes tests/test_extras.py uses
(64x96 images, ResNet18 pyramids). Every JAX model is initialized, its
BatchNorm parameters and statistics perturbed, and its variables carried
into the port's module by ``weights.state_dict_from_jax``, under the
module's class name. float32 outputs are held to the gates of
tests/test_torch_port_models.py (atol 1e-4; 1e-6 for the 0.01-scaled pose
outputs, as for PoseDecoder); the pure functions to the tolerance each
test states; ``flowvis`` and ``pointcloud`` must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movedepth_tpu import models as JM
from movedepth_tpu.models import decoders_extra as JD
from movedepth_tpu.ops import costvolume as JCV
from movedepth_tpu.ops import flowvis as JFV
from movedepth_tpu.ops import geometry as JG
from movedepth_tpu.ops import losses as JL
from movedepth_tpu.ops import pointcloud as JPC
from movedepth_tpu.ops import sampling as JS
from movedepth_tpu_torch import models as TM
from movedepth_tpu_torch.models import decoders_extra as TD
from movedepth_tpu_torch.ops import costvolume as TCV
from movedepth_tpu_torch.ops import flowvis as TFV
from movedepth_tpu_torch.ops import geometry as TG
from movedepth_tpu_torch.ops import losses as TL
from movedepth_tpu_torch.ops import pointcloud as TPC
from movedepth_tpu_torch.ops import sampling as TS
from movedepth_tpu_torch.weights import state_dict_from_jax
from test_torch_port_models import _nchw, _perturb_bn

F32 = jnp.float32
H, W = 64, 96
ATOL = 1e-4  # tests/test_torch_port_models.py's float32 gate


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _feats(rng):
    """A ResNet18 pyramid of a 64x96 image, NHWC numpy."""
    return [rng.normal(0, 1, (1, H // 2 ** (i + 1), W // 2 ** (i + 1), c))
            .astype(np.float32)
            for i, c in enumerate(TM.encoder_channels(18))]


def _port(name, jax_vars, module):
    module.load_state_dict(state_dict_from_jax(name, jax_vars))
    return module.eval()


def _assert_outputs(got, want, atol=ATOL):
    """Dict outputs keyed alike: the port's NCHW against the JAX NHWC."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]),
                                   atol=atol, err_msg=str(k))


# ------------------------------------------------------------------ ops

def test_upsample_nearest_2x(rng):
    """Exact: a copy of every pixel into a 2x2 block."""
    x = rng.normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    got = TS.upsample_nearest_2x(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got),
                                  np.asarray(JS.upsample_nearest_2x(x)))


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_v2_and_per_pixel_projection(rng, invert):
    """Per-pixel transforms, their projection and project_pixel to atol
    1e-5 (float32 matrix products in another order)."""
    b, h, w = 2, 4, 6
    aa = rng.normal(0, 0.05, (b, 3)).astype(np.float32)
    t = rng.normal(0, 0.2, (b, h, w, 3)).astype(np.float32)
    want_T = np.asarray(JG.transformation_from_parameters_v2(aa, t, invert))
    got_T = TG.transformation_from_parameters_v2(_t(aa), _t(t), invert)
    assert got_T.shape == (b, h, w, 4, 4)
    np.testing.assert_allclose(got_T.numpy(), want_T, atol=1e-6)

    depth = rng.uniform(1, 20, (b, h, w)).astype(np.float32)
    K = np.tile(np.array([[6.0, 0, 3, 0], [0, 8.0, 2, 0], [0, 0, 1, 0],
                          [0, 0, 0, 1]], np.float32), (b, 1, 1))
    inv_K = np.linalg.inv(K).astype(np.float32)
    pts = np.asarray(JG.backproject(depth, inv_K))
    want = np.asarray(JG.project_per_pixel(pts, K, want_T))
    got = TG.project_per_pixel(_t(pts), _t(K), _t(want_T))
    assert got.shape == (b, h, w, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    T = want_T[:, 0, 0]
    want_sx, want_sy = JG.project_pixel(pts, K, T, h, w)
    got_sx, got_sy = TG.project_pixel(_t(pts), _t(K), _t(T), h, w)
    np.testing.assert_allclose(got_sx.numpy(), np.asarray(want_sx),
                               atol=1e-5)
    np.testing.assert_allclose(got_sy.numpy(), np.asarray(want_sy),
                               atol=1e-5)


V1_CASES = {
    "inverse": {},
    "linear": {"schedule_type": "linear"},
    "log_depth": {"schedule_type": "log", "is_depth": True},
    "geo": {"damper": 2.0},
    "z": {},
}


@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_schedule_depth_bins_v1(rng, case):
    """The three variants (plain, geo-masked, z-scaled) and the schedule
    types, rtol 1e-5 (float32 reciprocals). The clamp is active: without
    it the band of the image's farthest pixel would pass the image's
    largest depth. No gradient flows to the input."""
    kw = V1_CASES[case]
    disp = rng.uniform(0.05, 0.9, (2, 8, 10)).astype(np.float32)
    if kw.get("is_depth"):
        disp = 1.0 / disp
    jkw, tkw = dict(kw), dict(kw)
    if case == "geo":
        mask = rng.uniform(0, 1, disp.shape) < 0.5
        jkw["geo_mask"], tkw["geo_mask"] = mask, _t(mask)
    if case == "z":
        z = np.array([0.5, 1.5], np.float32)
        jkw["z_trans"], tkw["z_trans"] = z, _t(z)
    args = (8, 0.5, 0.1, 100.0)
    want = np.asarray(JCV.schedule_depth_bins_v1(disp, *args, **jkw))
    x = _t(disp).requires_grad_(True)
    got = TCV.schedule_depth_bins_v1(x, *args, **tkw)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    center = disp if kw.get("is_depth") else 1.0 / (
        1 / 100.0 + disp * (1 / 0.1 - 1 / 100.0))
    flat = center.reshape(2, -1)
    top, bottom = got.numpy().max(1), got.numpy().min(1)
    assert (top <= flat.max(1)[:, None, None] * (1 + 1e-6)).all()
    assert (bottom >= flat.min(1)[:, None, None] * (1 - 1e-6)).all()
    assert np.isclose(top.reshape(2, -1), flat.max(1, keepdims=True),
                      rtol=1e-6).any()


def test_mvs_ssim(rng):
    """VALID windows and a mask, atol 1e-6."""
    x = rng.uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 10, 12, 1)) < 0.7).astype(np.float32)
    want_map, want_pool = JL.mvs_ssim(x, y, mask)
    got_map, got_pool = TL.mvs_ssim(_t(x), _t(y), _t(mask))
    assert got_map.shape == (2, 8, 10, 3) and got_pool.shape == (2, 8, 10, 1)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map),
                               atol=1e-6)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool),
                               atol=1e-6)


@pytest.mark.parametrize("bgr", [False, True])
def test_flowvis_bit_for_bit(rng, bgr):
    flow = rng.normal(0, 2, (12, 16, 2)).astype(np.float32)
    np.testing.assert_array_equal(TFV.make_colorwheel(),
                                  JFV.make_colorwheel())
    got = TFV.flow_to_image(flow, convert_to_bgr=bgr)
    want = JFV.flow_to_image(flow, convert_to_bgr=bgr)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TFV.flow_to_image(flow, clip_flow=1.5),
                                  JFV.flow_to_image(flow, clip_flow=1.5))


def test_update_flow_bit_for_bit(rng):
    """numpy arrays give the JAX package's numpy result; tensors the same
    values as a tensor."""
    flow = rng.normal(0, 1, (2, 4, 6, 2)).astype(np.float32)
    pix = rng.uniform(-1, 1, (2, 4, 6, 2)).astype(np.float32)
    want = JFV.update_flow(flow, pix, 6, 4)
    got = TFV.update_flow(flow, pix, 6, 4)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    got_t = TFV.update_flow(_t(flow), _t(pix), 6, 4)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


def test_pointcloud_same_ply_bytes(rng, tmp_path):
    rgbs, depths, intrs, extrs, masks = [], [], [], [], []
    for _ in range(2):
        rgbs.append(rng.integers(0, 256, (4, 5, 3), dtype=np.uint8))
        depths.append(rng.uniform(1, 5, (4, 5)).astype(np.float32))
        intrs.append(np.array([[2.0, 0, 2], [0, 2.0, 2], [0, 0, 1]],
                              np.float32))
        extr = np.eye(4, dtype=np.float32)
        extr[:3, 3] = rng.normal(0, 1, 3)
        extrs.append(extr)
        masks.append((rng.uniform(0, 1, (4, 5)) < 0.6).astype(np.float32))
    args = (rgbs, depths)
    rest = (intrs, extrs, masks)
    want = JPC.generate_pointcloud(*args, str(tmp_path / "jax.ply"), *rest)
    got = TPC.generate_pointcloud(*args, str(tmp_path / "port.ply"), *rest)
    assert open(got, "rb").read() == open(want, "rb").read()


# --------------------------------------------------------------- models

def test_context_encoder(rng):
    x = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    jm = JM.ContextEncoder(arch=18, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(0), x, False), rng)
    want = np.asarray(jm.apply(v, x, False))
    port = _port("ContextEncoder", v, TM.ContextEncoder(18))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (1, 64, H // 4, W // 4)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


def test_pose_cnn(rng):
    x = rng.uniform(0, 1, (2, H, W, 9)).astype(np.float32)
    jm = JM.PoseCNN(num_input_frames=3, dtype=F32)
    v = jm.init(jax.random.PRNGKey(1), x)
    want = jm.apply(v, x)
    port = _port("PoseCNN", v, TM.PoseCNN(3))
    assert sorted(port.state_dict())[-2:] == ["pose_conv.bias",
                                              "pose_conv.weight"]
    with torch.no_grad():
        got = port(_nchw(x))
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_fpn3cas(rng):
    x = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    jm = JM.FPN3cas(base_channels=8, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(2), x, False), rng)
    want = jm.apply(v, x, False)
    port = _port("FPN3cas", v, TM.FPN3cas(8))
    with torch.no_grad():
        got = port(_nchw(x))
    shapes = [(1, 32, 8, 12), (1, 16, 16, 24), (1, 8, 32, 48)]
    for g, w, shape in zip(got, want, shapes):
        assert g.shape == shape
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("discret", ["UD", "SID"])
def test_depth_grid(discret):
    """atol 1e-6: float32 exp/log and linspace of either library."""
    want = np.asarray(JD.depth_grid(discret, 16, 0.1, 10.0))
    got = TD.depth_grid(discret, 16, 0.1, 10.0)
    assert got.shape == (1, 16, 1, 1)
    np.testing.assert_allclose(got.numpy().reshape(-1), want.reshape(-1),
                               atol=1e-6)


def test_mpm_decoder(rng):
    chans = TM.encoder_channels(18)
    feats = _feats(rng)
    cost = rng.normal(0, 1, (1, H // 4, W // 4, 8)).astype(np.float32)
    jm = JD.MPMDecoder(num_ch_enc=chans, num_bins=8, dtype=F32)
    v = jm.init(jax.random.PRNGKey(3), cost, feats)
    want = jm.apply(v, cost, feats)
    port = _port("MPMDecoder", v, TM.MPMDecoder(chans, num_bins=8))
    with torch.no_grad():
        got = port(_nchw(cost), [_nchw(f) for f in feats])
    _assert_outputs(got, want)


@pytest.mark.parametrize("discret", ["UD", "SID"])
def test_depth_decoder_3d(rng, discret):
    chans = TM.encoder_channels(18)
    feats = _feats(rng)
    kw = dict(scales=(0, 2), discret=discret, mono_bins=16)
    jm = JD.DepthDecoder3D(num_ch_enc=chans, dtype=F32, **kw)
    v = jm.init(jax.random.PRNGKey(4), feats)
    want = jm.apply(v, feats)
    port = _port("DepthDecoder3D", v, TM.DepthDecoder3D(chans, **kw))
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    assert got[("mono_depth", 0)].shape == (1, 1, H, W)
    # depths in [0.1, 10]: the same 1e-4 relative to the range's top
    _assert_outputs(got, want, atol=10 * ATOL)


def test_depth_decoder_bin(rng):
    chans = TM.encoder_channels(18)
    feats = _feats(rng)
    jm = JD.DepthDecoderBin(num_ch_enc=chans, mono_bins=8, dtype=F32)
    v = jm.init(jax.random.PRNGKey(5), feats)
    want = jm.apply(v, feats)
    port = _port("DepthDecoderBin", v, TM.DepthDecoderBin(chans,
                                                          mono_bins=8))
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    _assert_outputs(got, want)


def test_depth_decoder_3head(rng):
    chans = TM.encoder_channels(18)
    feats = _feats(rng)
    jm = JD.DepthDecoder3Head(num_ch_enc=chans, scales=(0, 1), dtype=F32)
    v = jm.init(jax.random.PRNGKey(6), feats)
    want = jm.apply(v, feats)
    port = _port("DepthDecoder3Head", v,
                 TM.DepthDecoder3Head(chans, scales=(0, 1)))
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    _assert_outputs(got, want)


def test_res_block_wdsr(rng):
    x = rng.normal(0, 1, (1, 16, 24, 16)).astype(np.float32)
    disp = rng.normal(0, 1, (1, 16, 24, 1)).astype(np.float32)
    jm = JD.ResBlockWDSR(n_feats=16, res_scale=0.5, dtype=F32)
    v = jm.init(jax.random.PRNGKey(7), x, disp)
    want = np.asarray(jm.apply(v, x, disp))
    port = _port("ResBlockWDSR", v, TM.ResBlockWDSR(16, res_scale=0.5))
    with torch.no_grad():
        got = port(_nchw(x), _nchw(disp))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


def test_context_adjustment_layer(rng):
    """A depth of O(10): the gate is 1e-4 of its range."""
    depth = rng.uniform(1, 20, (2, 16, 24, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    jm = JD.ContextAdjustmentLayer(num_blocks=2, dtype=F32)
    v = jm.init(jax.random.PRNGKey(8), depth, img)
    want = np.asarray(jm.apply(v, depth, img))
    port = _port("ContextAdjustmentLayer", v,
                 TM.ContextAdjustmentLayer(num_blocks=2))
    with torch.no_grad():
        got = port(_nchw(depth), _nchw(img))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL * 20)
