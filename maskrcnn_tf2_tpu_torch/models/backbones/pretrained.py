"""Pretrained backbone weights (counterpart of the ResNet part of
``maskrcnn_tf2_tpu/models/backbones/pretrained.py``).

``config.backbone_init_weights`` names a local file, since nothing is
downloaded:

- an ``.npz`` of flax-path keys (``params/backbone/stem/conv/kernel``,
  ``batch_stats/backbone/stem/bn/mean``, ...), the interchange format both
  packages read and write (``save_backbone_npz``). A file written from a bare
  backbone, whose keys lack ``backbone/``, loads into the whole model. Each
  leaf goes through the flax -> torch bridge of ``weights.py``; keys the model
  does not have are skipped, and a shape that does not fit raises;
- a torch ``.pt``/``.pth`` holding a torchvision ResNet ``state_dict`` (or a
  module with one), read with ``weights_only=True``. Names map onto the
  port's (``conv1`` -> ``stem.conv``, ``layer{s}.{b}`` ->
  ``stage{s}_block{b+1}``, ``downsample.0/1`` -> ``downsample.conv/bn``; the
  classifier ``fc`` is dropped); both sides are OIHW, so nothing is
  transposed. An entry whose shape does not fit is skipped;
- ``'imagenet'``: ``$MASKRCNN_TPU_WEIGHTS_DIR/{backbone}.npz``, else
  ``~/.cache/maskrcnn_tf2_tpu/weights/{backbone}.npz`` (the JAX package's
  path, so both find one file).

Coverage counts the ``state_dict`` entries under ``backbone.`` without
``num_batches_tracked``, which has no flax leaf, so that it equals the JAX
package's leaf count; a load below 90 % of it raises. The deep-stem and
squeeze-excite names (ResNeXt, SENet) and the MobileNet and EfficientNet
layouts wait for their backbones (ROADMAP A.7).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.weights import _convert_param, state_dict_to_flax

_BN = nn.modules.batchnorm._BatchNorm
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_BN_LEAVES = r"(weight|bias|running_mean|running_var)"


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def save_backbone_npz(module: nn.Module, path: str) -> None:
    """Write ``module``'s parameters and batch-norm statistics as a
    flax-path-keyed npz (``params/...``, ``batch_stats/...``): the whole
    model's keys carry ``backbone/``, a bare backbone's do not."""
    flat = {}
    for coll, tree in state_dict_to_flax(module).items():
        for p, v in _flatten(tree).items():
            flat[coll + "/" + "/".join(p)] = v
    np.savez(path, **flat)


def _npz_target(model: nn.Module, coll: str, path: Tuple[str, ...], value: np.ndarray):
    """The model's ``(state_dict key, converted array)`` for one npz leaf, or
    None where the model has no such leaf."""
    try:
        module = model.get_submodule(".".join(path[:-1]))
    except AttributeError:
        return None
    if coll == "batch_stats":
        if not isinstance(module, _BN) or path[-1] not in _BN_STATS:
            return None
        name, converted = _BN_STATS[path[-1]], value
    else:
        try:
            name, converted = _convert_param(module, path[-1], value)
        except KeyError:
            return None
    return ".".join(path[:-1] + (name,)), converted


@torch.no_grad()
def load_npz(model: nn.Module, path: str) -> int:
    """Load a flax-path-keyed npz into ``model`` in place; returns the number
    of leaves loaded. A leaf the model lacks is skipped; a shape that does
    not fit raises."""
    sd = model.state_dict()
    loaded = 0
    with np.load(path) as data:
        for key in data.files:
            coll, rest = key.split("/", 1)
            p = tuple(rest.split("/"))
            value = np.asarray(data[key], np.float32)
            target = _npz_target(model, coll, p, value)
            if target is None or target[0] not in sd:
                target = _npz_target(model, coll, ("backbone",) + p, value)  # a bare backbone's file
            if target is None or target[0] not in sd:
                continue
            name, converted = target
            if tuple(converted.shape) != tuple(sd[name].shape):
                raise ValueError(f"shape mismatch for {key}: {tuple(sd[name].shape)} vs {value.shape}")
            sd[name].copy_(torch.from_numpy(np.ascontiguousarray(converted)))
            loaded += 1
    return loaded


def _torch_resnet_key(name: str) -> Optional[str]:
    """A torchvision ResNet ``state_dict`` name -> the port's, relative to the
    backbone; None for names the backbone does not use."""
    if re.match(r"conv1\.weight$", name):
        return "stem.conv.weight"
    m = re.match(rf"bn1\.{_BN_LEAVES}$", name)
    if m:
        return f"stem.bn.{m.group(1)}"
    m = re.match(rf"layer(\d+)\.(\d+)\.(conv|bn)(\d)\.{_BN_LEAVES}$", name)
    if m:
        stage, block, kind, idx, leaf = m.groups()
        return f"stage{stage}_block{int(block) + 1}.conv{idx}.{'conv' if kind == 'conv' else 'bn'}.{leaf}"
    m = re.match(rf"layer(\d+)\.(\d+)\.downsample\.(0|1)\.{_BN_LEAVES}$", name)
    if m:
        stage, block, which, leaf = m.groups()
        return f"stage{stage}_block{int(block) + 1}.downsample.{'conv' if which == '0' else 'bn'}.{leaf}"
    return None


def convert_torch_resnet(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` -> entries under the port's
    backbone names (``stem.conv.weight``, ``stage1_block1.conv1.bn.bias``,
    ...); ``fc.*`` and ``num_batches_tracked`` are dropped."""
    out = {}
    for name, tensor in state_dict.items():
        ours = _torch_resnet_key(name)
        if ours is not None:
            out[ours] = tensor
    return out


def convert_torch_backbone(state_dict) -> Dict[str, torch.Tensor]:
    """Sniff the layout of a torch ``state_dict``: ResNets convert; the
    MobileNet and EfficientNet layouts raise until their backbones are
    ported."""
    keys = set(state_dict.keys())
    if any(k.startswith("conv_stem") for k in keys) or any(k.startswith("features.0.0") for k in keys):
        raise ValueError(
            "a MobileNet/EfficientNet state_dict: the port has the ResNet backbones only; "
            "their converters wait for the rest of the backbone zoo (ROADMAP A.7)"
        )
    return convert_torch_resnet(state_dict)


def backbone_leaf_count(model: nn.Module) -> int:
    """The backbone's ``state_dict`` entries without ``num_batches_tracked``:
    the JAX package's count of param and batch_stats leaves."""
    return sum(1 for k in model.state_dict() if k.startswith("backbone.") and not k.endswith("num_batches_tracked"))


@torch.no_grad()
def load_backbone_params(model: nn.Module, source: str) -> int:
    """Load pretrained weights from ``source`` (``.npz``, ``.pt``, ``.pth``)
    into ``model``'s backbone, in place; returns the number of leaves
    loaded."""
    if source.endswith(".npz"):
        return load_npz(model, source)
    if source.endswith((".pt", ".pth")):
        sd = torch.load(source, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        target = model.state_dict()
        loaded = 0
        for name, tensor in convert_torch_backbone(sd).items():
            key = "backbone." + name
            if key in target and tuple(target[key].shape) == tuple(tensor.shape):
                target[key].copy_(tensor)
                loaded += 1
        return loaded
    raise ValueError(
        f"unsupported weight source '{source}' (.npz or torch .pt/.pth); 'imagenet' is read from a local "
        "file and never downloaded: convert a torchvision checkpoint with save_backbone_npz"
    )


def init_backbone_weights(model: nn.Module, config) -> int:
    """Load ``config.backbone_init_weights`` into ``model`` in place and
    report coverage; returns the number of leaves loaded (0 for random
    weights). ``'imagenet'`` raises ``FileNotFoundError`` without its file.
    Raises below 90 % of the backbone's leaves: a partial load would train a
    mostly random backbone while claiming a pretrained one."""
    source = config.backbone_init_weights
    if source in (None, "", "none", "random"):
        return 0
    if source == "imagenet":
        root = os.environ.get("MASKRCNN_TPU_WEIGHTS_DIR", os.path.expanduser("~/.cache/maskrcnn_tf2_tpu/weights"))
        source = os.path.join(root, f"{config.backbone}.npz")
        if not os.path.exists(source):
            raise FileNotFoundError(
                f"backbone_init_weights='imagenet' expects {source}; nothing is downloaded: place a "
                "converted checkpoint there (save_backbone_npz / convert_torch_backbone)"
            )
    loaded = load_backbone_params(model, source)
    total = backbone_leaf_count(model)
    if total and loaded < 0.9 * total:
        raise ValueError(
            f"pretrained load covered only {loaded}/{total} backbone leaves from '{source}' — wrong "
            f"checkpoint for backbone '{config.backbone}'?"
        )
    print(f"loaded pretrained backbone: {loaded}/{total} leaves from {source}")
    return loaded
