"""The port's models against the JAX package's, on the same weights.

Each JAX model is initialized, its BatchNorm parameters and running
statistics are perturbed with numpy, and ``weights.state_dict_from_jax``
carries the variables into the port's module. Eval-mode outputs must agree
to atol 1e-4. The port's ``state_dict()`` then goes back through the JAX
package's own converter (``train/torch_import.convert_state_dict``) and must
reproduce the JAX variables exactly, which proves the port keeps the
reference's state_dict key names and layouts.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from movedepth_tpu import models as JM
from movedepth_tpu.models import layers as JL
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch import models as TM
from movedepth_tpu_torch.models import layers as TL
from movedepth_tpu_torch.weights import _kernel_to_torch, state_dict_from_jax

F32 = jnp.float32


def _perturb_bn(variables, rng):
    """Nontrivial BN affine parameters and running statistics."""
    variables = jax.tree.map(np.array, variables)

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict) and "scale" in v:
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape)
                v["bias"] = rng.uniform(-0.5, 0.5, v["bias"].shape)
                stats[k]["mean"] = rng.uniform(-0.5, 0.5, v["scale"].shape)
                stats[k]["var"] = rng.uniform(0.5, 1.5, v["scale"].shape)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    if "batch_stats" in variables:
        walk(variables["params"], variables["batch_stats"])
    return jax.tree.map(lambda a: np.asarray(a, np.float32), variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=path)


def _port_model(name, jax_vars, port_model):
    port_model.load_state_dict(state_dict_from_jax(name, jax_vars))
    return port_model.eval()


def _round_trip(name, port_model, jax_vars):
    state = {k: v.detach().numpy() for k, v in port_model.state_dict().items()}
    _assert_tree_equal(TI.convert_state_dict(name, state), jax_vars)


# ------------------------------------------------- the eight pipeline models

def _resnet_case(arch, images, hw):
    def run(rng):
        x = rng.uniform(0, 1, (1,) + hw + (3 * images,)).astype(np.float32)
        jm = JM.ResNetEncoder(arch=arch, num_input_images=images, dtype=F32)
        v = _perturb_bn(jm.init(jax.random.PRNGKey(0), x, False), rng)
        return v, jm.apply(v, x, False), _nchw(x)
    return run


CASES = {
    "mono_encoder": (_resnet_case(18, 1, (32, 64)),
                     lambda: TM.ResNetEncoder(18)),
    "pose_encoder": (_resnet_case(18, 2, (32, 64)),
                     lambda: TM.ResNetEncoder(18, num_input_images=2)),
    "mono_encoder_resnet50": (_resnet_case(50, 1, (32, 64)),
                              lambda: TM.ResNetEncoder(50)),
    # 34: the basic blocks at depth; 101: the bottleneck depths (a 23-block
    # stage), at 64x96
    "mono_encoder_resnet34": (_resnet_case(34, 1, (64, 96)),
                              lambda: TM.ResNetEncoder(34)),
    "mono_encoder_resnet101": (_resnet_case(101, 1, (64, 96)),
                               lambda: TM.ResNetEncoder(101)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_encoder(rng, case):
    run, make = CASES[case]
    v, want, x = run(rng)
    port = _port_model("mono_encoder", v, make())
    with torch.no_grad():
        got = port(x)
    for g, w in zip(got, want):
        # atol 1e-4 of each level's range: ResNet50's deepest features
        # reach O(60) at this init, and float32 sums over its 50 layers
        # differ by ~1e-5 of that range (measured 8e-4 absolute)
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))
    _round_trip("mono_encoder", port, v)


def test_depth_decoder(rng):
    chans = TM.encoder_channels(18)
    feats = [rng.normal(0, 1, (1, 64 // 2 ** (i + 1), 96 // 2 ** (i + 1), c))
             .astype(np.float32) for i, c in enumerate(chans)]
    jm = JM.DepthDecoder(num_ch_enc=chans, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(1), feats), rng)
    want = jm.apply(v, feats)
    port = _port_model("mono_depth", v, TM.DepthDecoder(chans))
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    assert sorted(got) == sorted(k for k in want if k[0] == "disp")
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(want[k]).transpose(0, 3, 1, 2),
                                   atol=1e-4)
    _round_trip("mono_depth", port, v)


def test_pose_decoder(rng):
    feat = rng.normal(0, 1, (2, 2, 3, 512)).astype(np.float32)
    jm = JM.PoseDecoder(num_ch_enc=TM.encoder_channels(18), dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(2), [[feat]]), rng)
    want = jm.apply(v, [[feat]])
    port = _port_model("pose", v, TM.PoseDecoder(TM.encoder_channels(18)))
    with torch.no_grad():
        got = port([[_nchw(feat)]])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    _round_trip("pose", port, v)


def test_fpn4(rng):
    x = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    jm = JM.FPN4(base_channels=8, scale=2, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(3), x, False), rng)
    want = jm.apply(v, x, False)
    port = _port_model("mvs_encoder", v, TM.FPN4(8, scale=2))
    with torch.no_grad():
        got = port(_nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=1e-4)
    _round_trip("mvs_encoder", port, v)


def test_reg3d(rng):
    vol = rng.normal(0, 1, (1, 8, 8, 16, 16)).astype(np.float32)  # BDHWG
    jm = JM.Reg3D(base_channels=16, down_size=3, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(4), vol, False), rng)
    want = jm.apply(v, vol, False)
    port = _port_model("reg3d", v, TM.Reg3D(16))
    with torch.no_grad():
        got = port(torch.from_numpy(vol.transpose(0, 4, 1, 2, 3).copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    _round_trip("reg3d", port, v)


def test_uncertnet(rng):
    x = rng.uniform(0, 2, (1, 12, 20, 1)).astype(np.float32)
    jm = JM.UncertNet(dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(5), x, False), rng)
    want = jm.apply(v, x, False)
    port = _port_model("mask_cnn", v, TM.UncertNet())
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-4)
    _round_trip("mask_cnn", port, v)


def test_convex_upsample_head(rng):
    x = rng.normal(0, 1, (1, 12, 20, 32)).astype(np.float32)
    jm = JM.ConvexUpsampleHead(scale=2, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(6), x), rng)
    want = jm.apply(v, x)
    port = _port_model("up", v, TM.ConvexUpsampleHead(32, scale=2))
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-4)
    _round_trip("up", port, v)


# --------------------------------------------------------- the layer blocks

def _load_conv(conv, node, transposed=False):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            _kernel_to_torch(node["kernel"], transposed))))
        if "bias" in node:
            conv.bias.copy_(torch.from_numpy(np.array(node["bias"])))


def _load_bn(bn, params, stats):
    with torch.no_grad():
        for attr, src in (("weight", params["scale"]), ("bias", params["bias"]),
                          ("running_mean", stats["mean"]),
                          ("running_var", stats["var"])):
            getattr(bn, attr).copy_(torch.from_numpy(np.array(src)))


@pytest.mark.parametrize("block", ["Conv3x3", "ConvBlock"])
def test_conv3x3_and_conv_block(rng, block):
    """Reflection padding, then the 3x3 conv (and ELU for ConvBlock)."""
    x = rng.normal(0, 1, (1, 6, 9, 4)).astype(np.float32)
    jm = getattr(JL, block)(5, dtype=F32)
    v = jm.init(jax.random.PRNGKey(7), x)
    tm = getattr(TL, block)(4, 5).eval()
    conv3x3 = tm if block == "Conv3x3" else tm.conv
    node = v["params"]["conv"]
    _load_conv(conv3x3.conv, node if block == "Conv3x3" else node["conv"])
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jm.apply(v, x)).transpose(0, 3, 1, 2),
        atol=1e-5)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (5, 2)])
def test_conv_bn_relu(rng, kernel, stride):
    x = rng.normal(0, 1, (1, 8, 12, 4)).astype(np.float32)
    jm = JL.ConvBNReLU(6, (kernel, kernel), (stride, stride),
                       ((kernel // 2,) * 2,) * 2, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(8), x, False), rng)
    tm = TL.ConvBNReLU(4, 6, kernel, stride).eval()
    _load_conv(tm.conv, v["params"]["conv"])
    _load_bn(tm.bn, v["params"]["bn"], v["batch_stats"]["bn"])
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jm.apply(v, x, False)).transpose(0, 3, 1, 2),
        atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu_3d(rng, stride):
    x = rng.normal(0, 1, (1, 4, 6, 8, 3)).astype(np.float32)
    jm = JL.ConvBnReLU3D(5, strides=(stride,) * 3, dtype=F32)
    v = _perturb_bn(jm.init(jax.random.PRNGKey(9), x, False), rng)
    tm = TL.ConvBnReLU3D(3, 5, stride).eval()
    _load_conv(tm.conv, v["params"]["conv"])
    _load_bn(tm.bn, v["params"]["bn"], v["batch_stats"]["bn"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jm.apply(v, x, False)).transpose(0, 4, 1, 2, 3), atol=1e-5)


def test_conv_transpose_3d_output_padding(rng):
    """torch's ConvTranspose3d(stride 2, padding 1, output_padding 1)
    doubles every dimension; the JAX package stores the kernel flipped."""
    x = rng.normal(0, 1, (1, 3, 4, 5, 6)).astype(np.float32)
    jm = JL.ConvTransposeTorch(4, (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1),
                               dtype=F32)
    v = jm.init(jax.random.PRNGKey(10), x)
    tm = torch.nn.ConvTranspose3d(6, 4, 3, stride=2, padding=1,
                                  output_padding=1, bias=False)
    _load_conv(tm, v["params"], transposed=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    want = np.asarray(jm.apply(v, x)).transpose(0, 4, 1, 2, 3)
    assert got.shape == want.shape == (1, 4, 6, 8, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_max_pool_3x3_s2(rng):
    x = rng.normal(0, 1, (2, 7, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TL.max_pool_3x3_s2(_nchw(x)).numpy(),
        np.asarray(JL.max_pool_3x3_s2(x)).transpose(0, 3, 1, 2))


def test_build_models_defers_unported_options():
    """Reg2D below 8 bins and the DCN head are built now (their parity
    tests are in tests/test_torch_port_variants.py); an arch torchvision
    lacks and a parameter type the port does not store are refused."""
    from movedepth_tpu_torch import Config
    models = TM.build_models(Config(num_depth_bins=4, dcn=True), "cpu")
    assert type(models["reg3d"]) is TM.Reg2D
    assert isinstance(models["mvs_encoder"].out_dcn_0, TM.DCNConv2d)
    with pytest.raises(ValueError, match="param_dtype"):
        TM.build_models(Config(param_dtype="float64"), "cpu")
    # every ResNet depth is ported; an arch torchvision lacks is refused
    with pytest.raises(ValueError, match="ResNet26"):
        TM.build_models(Config(res_arch=26), "cpu")


def test_resnet152_shapes_and_key_names():
    """ResNet152 (too deep to run against JAX in the CPU suite): its
    feature shapes, and its state_dict keys and shapes against the JAX
    encoder's variables through the JAX package's own converter."""
    enc = TM.ResNetEncoder(152)
    assert TM.encoder_channels(152) == (64, 256, 512, 1024, 2048)
    assert TM.encoder_channels(34) == (64, 64, 128, 256, 512)
    with torch.no_grad():
        feats = enc(torch.zeros(1, 3, 64, 96))
    assert [tuple(f.shape) for f in feats] == [
        (1, 64, 32, 48), (1, 256, 16, 24), (1, 512, 8, 12),
        (1, 1024, 4, 6), (1, 2048, 2, 3)]
    state = {k: v.numpy() for k, v in enc.state_dict().items()}
    assert "encoder.layer3.35.conv3.weight" in state
    assert "encoder.layer2.7.bn3.running_var" in state
    jm = JM.ResNetEncoder(arch=152, dtype=F32)
    want = jax.eval_shape(lambda k, x: jm.init(k, x, False),
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    got = TI.convert_state_dict("mono_encoder", state)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
