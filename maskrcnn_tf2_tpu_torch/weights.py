"""The flax -> PyTorch weight bridge, and a seeded initializer.

``flax_to_state_dict`` turns the JAX package's variables
``{"params", "batch_stats"}`` (nested dicts of numpy arrays) into the port's
``state_dict``. The torch modules carry the flax names, so a leaf at
``a/b/c/kernel`` lands at ``a.b.c.weight``; the layout changes with the kind
of module found there:

- ``Conv2d``: HWIO -> OIHW (this covers the RPN's ``_Conv1x1Params`` pair and
  the mask head's ``_MaskProj``, both ``[1, 1, in, out]``); a grouped kernel
  ``[kh, kw, in / groups, out]`` becomes ``[out, in / groups, kh, kw]`` by the
  same transpose, a depthwise ``[kh, kw, 1, C]`` ``[C, 1, kh, kw]``;
- ``ConvTranspose2d``: flax applies its kernel spatially flipped, so
  ``W[c, f, i, j] = K[1 - i, 1 - j, c, f]``;
- ``Linear``: ``[in, out]`` -> ``[out, in]`` (the classifier's FC on the
  pooled patch keeps its (P, P, C) row order; the backbones' squeeze-excite
  ``fc1``/``fc2`` and ``se_reduce``/``se_expand`` Dense layers too);
- batch norm: scale/bias/mean/var -> weight/bias/running_mean/running_var,
  and ``num_batches_tracked`` is set to 0.

It raises on a leaf that maps nowhere, on a shape that does not match, and
on any parameter or buffer of the model that is left unassigned. With
``params_only=True`` it converts a ``{"params"}`` tree alone (a gradient
tree, say) to the model's parameter names and checks only the parameters.
``state_dict_to_flax`` is its inverse: a module's entries back to flax
variables (``num_batches_tracked`` has no flax leaf and is dropped).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_BN = nn.modules.batchnorm._BatchNorm


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value, dtype=np.float32)


def _convert_param(module: nn.Module, name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if isinstance(module, _BN):
        if name in ("scale", "bias"):
            return ("weight" if name == "scale" else "bias"), value
    elif name == "bias" and isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        return "bias", value
    elif name == "kernel":
        if isinstance(module, nn.ConvTranspose2d):
            return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
        if isinstance(module, nn.Conv2d):
            return "weight", value.transpose(3, 2, 0, 1)
        if isinstance(module, nn.Linear):
            return "weight", value.T
    raise KeyError(f"no torch counterpart for leaf {name!r} of {type(module).__name__}")


def _export_param(module: nn.Module, name: str, value: np.ndarray) -> Tuple[str, str, np.ndarray]:
    """The inverse of ``_convert_param``, and of the batch-norm statistics'
    renaming: ``(collection, flax leaf, array)``."""
    if isinstance(module, _BN):
        leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}[name]
        return leaf + (value,)
    if name == "bias":
        return "params", "bias", value
    if isinstance(module, nn.ConvTranspose2d):
        return "params", "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(module, nn.Conv2d):
        return "params", "kernel", value.transpose(2, 3, 1, 0)
    if isinstance(module, nn.Linear):
        return "params", "kernel", value.T
    raise KeyError(f"no flax counterpart for {name!r} of {type(module).__name__}")


def state_dict_to_flax(model: nn.Module) -> Dict[str, Dict]:
    """``model``'s parameters and batch-norm statistics as flax variables
    ``{"params", "batch_stats"}`` (nested dicts of float32 numpy arrays, copies
    that later updates of the model leave alone), the tree
    ``flax_to_state_dict`` reads."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in model.state_dict().items():
        *path, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        value = tensor.detach().to("cpu", torch.float32).numpy()
        coll, leaf, value = _export_param(model.get_submodule(".".join(path)), name, value)
        node = out[coll]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(value, order="C")  # a copy: a CPU model's arrays would alias its tensors
    return out


def flax_to_state_dict(variables: Mapping, model: nn.Module, params_only: bool = False) -> Dict[str, torch.Tensor]:
    """Convert flax ``variables`` to a ``state_dict`` for ``model`` (only its
    parameters when ``params_only``)."""
    extra = set(variables) - ({"params"} if params_only else {"params", "batch_stats"})
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    target = dict(model.named_parameters()) if params_only else model.state_dict()
    out: Dict[str, torch.Tensor] = {}

    def assign(key: str, value: np.ndarray, source: str) -> None:
        if key not in target:
            raise KeyError(f"{source} maps to {key!r}, which the model does not have")
        if key in out:
            raise KeyError(f"{source} assigns {key!r} a second time")
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{source}: shape {value.shape} does not fit {key!r} {tuple(target[key].shape)}"
            )
        out[key] = torch.from_numpy(np.ascontiguousarray(value))

    def module_at(path: Tuple[str, ...], source: str) -> nn.Module:
        try:
            return model.get_submodule(".".join(path))
        except AttributeError as e:
            raise KeyError(f"{source}: the model has no module {'.'.join(path)!r}") from e

    for path, value in _leaves(variables.get("params", {})):
        source = "params/" + "/".join(path)
        module = module_at(path[:-1], source)
        name, converted = _convert_param(module, path[-1], value)
        assign(".".join(path[:-1] + (name,)), converted, source)
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _leaves(variables.get("batch_stats", {})):
        source = "batch_stats/" + "/".join(path)
        if not isinstance(module_at(path[:-1], source), _BN) or path[-1] not in stats_names:
            raise KeyError(f"no torch counterpart for {source}")
        assign(".".join(path[:-1] + (stats_names[path[-1]],)), value, source)
    if not params_only:
        for name, module in model.named_modules():
            if isinstance(module, _BN) and module.num_batches_tracked is not None:
                out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model entries left unassigned by the flax variables: {missing}")
    return out


@torch.no_grad()
def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights at the scale of the JAX package's initializers:
    kernels normal with std 1/sqrt(fan_in), biases zero, batch norm the
    identity (scale 1, bias 0, mean 0, var 1). A grouped conv's fan-in is
    ``in / groups * kh * kw``, as flax's. Draws on the CPU from
    ``generator``, so a seed gives the same weights on every device."""
    for module in model.modules():
        if isinstance(module, _BN):
            module.reset_parameters()
        elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            v = torch.randn(w.shape, generator=generator) / fan_in**0.5
            w.copy_(v)
            if module.bias is not None:
                module.bias.zero_()
    return model
