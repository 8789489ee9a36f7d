"""Pretrained backbone weights (counterpart of
``maskrcnn_tf2_tpu/models/backbones/pretrained.py``).

``config.backbone_init_weights`` names a local file, since nothing is
downloaded:

- an ``.npz`` of flax-path keys (``params/backbone/stem/conv/kernel``,
  ``batch_stats/backbone/stem/bn/mean``, ...), the interchange format both
  packages read and write (``save_backbone_npz``), for any of the 25
  backbones. A file written from a bare backbone, whose keys lack
  ``backbone/``, loads into the whole model. Each leaf goes through the flax
  -> torch bridge of ``weights.py``; keys the model does not have are
  skipped, and a shape that does not fit raises;
- a torch ``.pt``/``.pth`` ``state_dict`` (or a module with one), read with
  ``weights_only=True``, in one of five layouts that ``convert_torch_backbone``
  tells apart by its names: torchvision ResNet/ResNeXt, timm
  ``legacy_seresnet*``/``legacy_senet154``, torchvision ``mobilenet_v2``, timm
  ``mobilenetv1_100`` and timm ``efficientnet_b*``. Names map onto the
  port's; both sides are OIHW, so only the squeeze-excite 1x1 convs are
  reshaped (to ``Linear`` weights); classifiers and head convs are dropped.
  An entry whose shape does not fit is skipped;
- ``'imagenet'``: ``$MASKRCNN_TPU_WEIGHTS_DIR/{backbone}.npz``, else
  ``~/.cache/maskrcnn_tf2_tpu/weights/{backbone}.npz`` (the JAX package's
  path, so both find one file).

Coverage counts the ``state_dict`` entries under ``backbone.`` without
``num_batches_tracked``, which has no flax leaf, so that it equals the JAX
package's leaf count; a load below 90 % of it raises.

One divergence by design: a timm ``legacy_seresnet*`` file has a single-conv
``layer0.conv1``/``layer0.bn1`` stem, which the port loads into ``stem``. The
JAX package maps every ``layer0.conv{i}`` to the deep stem's ``stem{i}``, so
it skips that stem; the port takes the deep-stem branch only when the file
has ``layer0.conv3.weight``.
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


def _torch_resnet_key(name: str, deep_stem: bool) -> Optional[str]:
    """A torchvision or timm ResNet-family ``state_dict`` name -> the port's,
    relative to the backbone; None for names the backbone does not use."""
    if re.match(r"conv1\.weight$", name):
        return "stem.conv.weight"
    m = re.match(rf"bn1\.{_BN_LEAVES}$", name)
    if m:
        return f"stem.bn.{m.group(1)}"
    m = re.match(rf"layer0\.(conv|bn)(\d)\.{_BN_LEAVES}$", name)
    if m:
        kind, idx, leaf = m.groups()
        if not deep_stem and idx != "1":
            return None
        return f"{f'stem{idx}' if deep_stem else 'stem'}.{kind}.{leaf}"
    m = re.match(rf"layer(\d+)\.(\d+)\.(conv|bn)(\d)\.{_BN_LEAVES}$", name)
    if m:
        stage, block, kind, idx, leaf = m.groups()
        return f"stage{stage}_block{int(block) + 1}.conv{idx}.{kind}.{leaf}"
    m = re.match(rf"layer(\d+)\.(\d+)\.downsample\.(0|1)\.{_BN_LEAVES}$", name)
    if m:
        stage, block, which, leaf = m.groups()
        return f"stage{stage}_block{int(block) + 1}.downsample.{'conv' if which == '0' else 'bn'}.{leaf}"
    m = re.match(r"layer(\d+)\.(\d+)\.(?:se_module|se)\.fc(\d)\.(weight|bias)$", name)
    if m:
        stage, block, idx, leaf = m.groups()
        return f"stage{stage}_block{int(block) + 1}.se.fc{idx}.{leaf}"
    return None


def _as_linear(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv weight ``[O, I, 1, 1]`` (or a linear one) -> ``[O, I]``."""
    return w.reshape(w.shape[0], w.shape[1])


def convert_torch_resnet(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet/ResNeXt or timm ``legacy_seresnet*``/``legacy_senet154``
    ``state_dict`` -> entries under the port's backbone names
    (``stem.conv.weight``, ``stage1_block1.conv1.bn.bias``,
    ``stage1_block1.se.fc1.weight``, ...). ``layer0.conv{1,2,3}`` is the deep
    stem ``stem{1,2,3}`` when ``layer0.conv3.weight`` is present, else
    ``layer0.conv1`` is the single ``stem``. Squeeze-excite weights, 1x1
    convs (``se_module.fc{i}``) or linear layers (``se.fc{i}``), become
    ``Linear`` weights; ``fc``, ``last_linear`` and ``num_batches_tracked``
    are dropped."""
    deep_stem = "layer0.conv3.weight" in state_dict
    out = {}
    for name, tensor in state_dict.items():
        ours = _torch_resnet_key(name, deep_stem)
        if ours is not None:
            out[ours] = _as_linear(tensor) if ".se.fc" in ours and ours.endswith("weight") else tensor
    return out


def _copy_conv_bn(out, sd, ours: str, conv: str, bn: str) -> None:
    """``{ours}_conv.weight`` and ``{ours}_bn.*`` from ``{conv}.weight`` and
    ``{bn}.*``, when the file has that conv."""
    if f"{conv}.weight" not in sd:
        return
    out[f"{ours}_conv.weight"] = sd[f"{conv}.weight"]
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        if f"{bn}.{leaf}" in sd:
            out[f"{ours}_bn.{leaf}"] = sd[f"{bn}.{leaf}"]


def convert_torch_mobilenet_v2(state_dict) -> Dict[str, torch.Tensor]:
    """torchvision ``mobilenet_v2`` -> ``MobileNetV2``: ``features.0`` is the
    stem, ``features.1..17`` the blocks ``block0..16`` (``conv.{0,1,2,3}`` is
    expand, dw, project conv and bn; without the expansion ``conv.{0,1,2}``
    is dw, project conv and bn); ``features.18``, the classifier's 1280-wide
    head conv, has no counterpart."""
    out: Dict[str, torch.Tensor] = {}
    _copy_conv_bn(out, state_dict, "stem", "features.0.0", "features.0.1")
    for i in range(1, 18):
        pre = f"features.{i}.conv"
        if f"{pre}.1.0.weight" in state_dict:
            sites = [("expand", "0.0", "0.1"), ("dw", "1.0", "1.1"), ("project", "2", "3")]
        else:
            sites = [("dw", "0.0", "0.1"), ("project", "1", "2")]
        for ours, conv, bn in sites:
            _copy_conv_bn(out, state_dict, f"block{i - 1}.{ours}", f"{pre}.{conv}", f"{pre}.{bn}")
    return out


def _timm_blocks(sd):
    """timm's ``blocks.{s}.{b}`` prefixes in (stage, block) order."""
    def has(s, b):
        return f"blocks.{s}.{b}.conv_dw.weight" in sd or f"blocks.{s}.{b}.conv_pw.weight" in sd

    s = 0
    while has(s, 0):
        b = 0
        while has(s, b):
            yield f"blocks.{s}.{b}"
            b += 1
        s += 1


def convert_timm_efficientnet(state_dict) -> Dict[str, torch.Tensor]:
    """timm ``efficientnet_b*`` -> ``EfficientNet``: ``conv_stem``/``bn1`` is
    the stem; ``blocks.{s}.{b}`` numbered globally as ``block{idx}``, an MBConv
    with ``conv_pw``/``bn1`` (expand), ``conv_dw``/``bn2``, ``conv_pwl``/``bn3``
    (project), or stage 0's depthwise-separable block with ``conv_dw``/``bn1``
    and ``conv_pw``/``bn2`` (project); ``se.conv_reduce``/``se.conv_expand``
    (1x1 convs with bias) become ``se_reduce``/``se_expand``; ``conv_head``
    has no counterpart."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}
    _copy_conv_bn(out, sd, "stem", "conv_stem", "bn1")
    for idx, pre in enumerate(_timm_blocks(sd)):
        if f"{pre}.conv_pwl.weight" in sd:
            sites = [("expand", "conv_pw", "bn1"), ("dw", "conv_dw", "bn2"), ("project", "conv_pwl", "bn3")]
        else:
            sites = [("dw", "conv_dw", "bn1"), ("project", "conv_pw", "bn2")]
        for ours, conv, bn in sites:
            _copy_conv_bn(out, sd, f"block{idx}.{ours}", f"{pre}.{conv}", f"{pre}.{bn}")
        for timm, ours in (("conv_reduce", "se_reduce"), ("conv_expand", "se_expand")):
            if f"{pre}.se.{timm}.weight" in sd:
                out[f"block{idx}.{ours}.weight"] = _as_linear(sd[f"{pre}.se.{timm}.weight"])
            if f"{pre}.se.{timm}.bias" in sd:
                out[f"block{idx}.{ours}.bias"] = sd[f"{pre}.se.{timm}.bias"]
    return out


def convert_timm_mobilenet_v1(state_dict) -> Dict[str, torch.Tensor]:
    """timm ``mobilenetv1_100`` -> ``MobileNetV1``: ``conv_stem``/``bn1`` is
    the stem; the 13 ``blocks.{s}.{b}`` in (stage, block) order are ``b1..b13``,
    each ``conv_dw``/``bn1`` and ``conv_pw``/``bn2``."""
    out: Dict[str, torch.Tensor] = {}
    _copy_conv_bn(out, state_dict, "stem", "conv_stem", "bn1")
    for i, pre in enumerate(_timm_blocks(state_dict), start=1):
        _copy_conv_bn(out, state_dict, f"b{i}_dw", f"{pre}.conv_dw", f"{pre}.bn1")
        _copy_conv_bn(out, state_dict, f"b{i}_pw", f"{pre}.conv_pw", f"{pre}.bn2")
    return out


def convert_torch_backbone(state_dict) -> Dict[str, torch.Tensor]:
    """Sniff the layout of a torch ``state_dict`` and convert it: timm's
    ``conv_stem`` skeleton is EfficientNet when it has 3-conv blocks or SE
    convs, else MobileNet V1; ``features.0.0`` is torchvision MobileNet V2;
    anything else is the ResNet family."""
    keys = set(state_dict.keys())
    if any(k.startswith("conv_stem") for k in keys):
        if any(".conv_pwl." in k or ".se." in k for k in keys):
            return convert_timm_efficientnet(state_dict)
        return convert_timm_mobilenet_v1(state_dict)
    if any(k.startswith("features.0.0") for k in keys):
        return convert_torch_mobilenet_v2(state_dict)
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
