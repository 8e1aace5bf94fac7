"""Weights into the port: from the JAX package's flax variables, from
reference per-model ``.pth`` folders, and ImageNet encoders from a
torchvision ``.pth``.

:func:`state_dict_from_jax` inverts movedepth_tpu/train/torch_import.py:
flax kernels (kh, kw, I, O) / (kd, kh, kw, I, O) go back to torch's
(O, I, ...) layout, the transposed 3-D convs of Reg3D are flipped back
(the JAX package stores them spatially flipped, as input-dilated
correlations), and BatchNorm scale/bias and mean/var become
weight/bias and running_mean/running_var. Reg2D's leaves take Reg3D's
names (its ``prob`` has a bias); a deformable block of the FPN head
(``out_dcn_N``) holds its own kernel beside its ``conv_offset`` and ``bn``
children. bfloat16 leaves (``param_dtype``) stay bfloat16.
"""

from __future__ import annotations

import glob
import os
import re
from collections.abc import Mapping as MappingABC
from typing import Dict, Mapping

import numpy as np
import torch

_FIXED_NAMES = {
    "pose": {"squeeze": "net.0", "pose_0": "net.1", "pose_1": "net.2",
             "pose_2": "net.3"},
    "mask_cnn": {"conv1": "conv1.0", "bn1": "conv1.1", "conv2": "conv2.0",
                 "bn2": "conv2.1", "head": "head_convs"},
    "up": {"mask0": "upsample_mask.0", "mask1": "upsample_mask.2"},
    # monodepth2's pose_cnn.py: the seven convs in ``net``, then pose_conv
    "PoseCNN": dict({f"convs_{i}": f"net.{i}" for i in range(7)},
                    pose_conv="pose_conv"),
}
# models whose state_dict names are their flax paths dotted by _attr
_DOTTED = ("mvs_encoder", "reg3d", "FPN3cas", "MPMDecoder", "DepthDecoder3D",
           "DepthDecoderBin", "DepthDecoder3Head", "ResBlockWDSR",
           "ContextAdjustmentLayer")
_TRANSPOSED = ("conv7_0", "conv9_0", "conv11_0")  # Reg3D's ConvTranspose3d


def _leaves(tree, path=()):
    """(path, node) for every conv ('kernel') and BatchNorm ('scale'), and
    below a node that holds both a kernel and child modules (a DCN block),
    its children too."""
    if "kernel" in tree or "scale" in tree:
        yield path, tree
    for key, sub in tree.items():
        if isinstance(sub, MappingABC):
            yield from _leaves(sub, path + (key,))


def _attr(part):
    """A flax module name as a torch attribute path: a number or a single
    letter after an underscore is an index (conv0_1 -> conv0.1,
    upconv_4_0 -> upconv.4.0, depth_3dcnn_2_a -> depth_3dcnn.2.a); other
    names stay as they are (conv_offset, reduce_conv), and so does the DCN
    head's out_dcn_N."""
    if part.startswith("out_dcn_"):
        return part
    return re.sub(r"_(\d+|[a-z])(?=_|$)", r".\1", part)


def _prefix(name, path, scales):
    """Flax module path -> the reference's state_dict prefix."""
    dotted = ".".join(_attr(p) for p in path)
    if name in ("mono_encoder", "pose_encoder", "ContextEncoder"):
        return "encoder." + dotted  # layer1_0/downsample_0 -> layer1.0...
    if name in _DOTTED:
        return dotted  # conv0_1/bn -> conv0.1.bn, conv7_0 -> conv7.0
    if name == "mono_depth":  # upconv_i_j at 2*(4-i)+j, then dispconv_s
        kind, *idx = path[0].split("_")
        if kind == "upconv":
            return f"decoder.{2 * (4 - int(idx[0])) + int(idx[1])}.conv.conv"
        return f"decoder.{10 + list(scales).index(int(idx[0]))}.conv"
    return _FIXED_NAMES[name][path[0]]


def _kernel_to_torch(kernel, transposed):
    k = np.asarray(kernel)
    if k.ndim == 4:
        return k.transpose(3, 2, 0, 1)
    if transposed:
        return k.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]
    return k.transpose(4, 3, 0, 1, 2)


def state_dict_from_jax(name: str, variables: Mapping,
                        scales=(0, 1, 2, 3)) -> Dict[str, torch.Tensor]:
    """One model's flax variables ({'params', 'batch_stats'}, numpy or
    jax arrays) -> the port's state_dict for model ``name``: one of
    ``ALL_MODELS``, or the class name of a module outside the pipeline
    (``ContextEncoder``, ``PoseCNN``, ``FPN3cas`` and those of
    ``models/decoders_extra.py``). A params-only tree (gradients, Adam's
    moments, or parameters after an optimizer update) gives the parameters
    alone, without BatchNorm running statistics."""
    stats = variables.get("batch_stats")
    out = {}
    for path, node in _leaves(variables["params"]):
        prefix = _prefix(name, path, scales)
        if "kernel" in node:
            transposed = name == "reg3d" and path[0] in _TRANSPOSED
            out[prefix + ".weight"] = _kernel_to_torch(node["kernel"],
                                                       transposed)
            if "bias" in node:
                out[prefix + ".bias"] = node["bias"]
        else:
            out.update({prefix + ".weight": node["scale"],
                        prefix + ".bias": node["bias"]})
            if stats is None:
                continue
            st = stats
            for p in path:
                st = st[p]
            out.update({prefix + ".running_mean": st["mean"],
                        prefix + ".running_var": st["var"],
                        prefix + ".num_batches_tracked": np.zeros((),
                                                                  np.int64)})
    return {k: _tensor(v) for k, v in out.items()}


def _tensor(v):
    """A numpy or jax array as a torch tensor of its type: a bfloat16 one
    (ml_dtypes, which numpy cannot hand to torch) through its bits."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_state(model: torch.nn.Module, state: Mapping, source: str):
    """Load a reference state_dict into ``model`` in place: entries that
    are not weights of the model (``encoder.fc.*``, an encoder's saved
    ``height``/``width``) are dropped, and every weight and statistic of
    the model must be there."""
    own = model.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{source} lacks {len(missing)} weights of the "
                       f"model, e.g. {missing[:3]}")
    model.load_state_dict({k: v for k, v in state.items() if k in own},
                          strict=False)


def load_reference_folder(folder: str, models: Mapping) -> list:
    """Load ``<folder>/<name>.pth`` into each of ``models`` in place.

    The files are the reference's per-model state_dicts. Entries that are
    not weights of the model (``encoder.fc.*``, the encoder's saved
    ``height``/``width``) are dropped; a missing file is skipped, as in
    the JAX package's loader. Returns the names that were loaded.
    """
    loaded = []
    for name, model in models.items():
        path = os.path.join(folder, f"{name}.pth")
        if not os.path.isfile(path):
            continue
        load_state(model, torch.load(path, map_location="cpu",
                                     weights_only=True), path)
        loaded.append(name)
    return loaded


def find_imagenet_weights(num_layers: int, search_dirs=None):
    """A torchvision ImageNet ``pretrain_resnet/resnet{N}-*.pth``: the first
    match in ``search_dirs``, then ``$PRETRAIN_RESNET_DIR``, then
    ``./pretrain_resnet``, then ``pretrain_resnet`` at the root of the
    checkout. None when there is none."""
    dirs = list(search_dirs or [])
    env = os.environ.get("PRETRAIN_RESNET_DIR")
    if env:
        dirs.append(env)
    dirs.append("pretrain_resnet")
    dirs.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                             "pretrain_resnet"))
    for d in dirs:
        hits = sorted(glob.glob(os.path.join(d, f"resnet{num_layers}-*.pth")))
        if hits:
            return hits[0]
    return None


def load_imagenet_encoders(cfg, models: Mapping, search_dirs=None) -> list:
    """ImageNet warm start of the ResNet encoders, in place: a
    torchvision-layout ``.pth`` (no ``encoder.`` prefix, an ``fc`` head)
    into ``mono_encoder`` and, unless ``cfg.load_pose``, ``pose_encoder``,
    whose ``conv1`` takes the kernel tiled over its 2 stacked frames and
    halved. BatchNorm statistics come along. Returns the names loaded;
    empty when no file is found (the caller warns and keeps its init)."""
    path = find_imagenet_weights(cfg.res_arch, search_dirs)
    if path is None:
        return []
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {"encoder." + k: v for k, v in state.items()
             if not k.startswith("fc.")}
    loaded = []
    for name in ("mono_encoder", "pose_encoder"):
        if name not in models or (name == "pose_encoder" and cfg.load_pose):
            continue
        sd = dict(state)
        if name == "pose_encoder":
            k = sd["encoder.conv1.weight"]
            sd["encoder.conv1.weight"] = torch.cat([k, k], dim=1) / 2
        load_state(models[name], sd, path)
        loaded.append(name)
    return loaded
