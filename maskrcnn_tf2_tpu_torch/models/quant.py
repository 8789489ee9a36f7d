"""Int8 post-training quantization: the quantizable sites (counterpart of
``maskrcnn_tf2_tpu/models/quant.py``).

``config.quant_mode`` is ``off``, ``calib`` or ``int8``. A site is a
``Int8Conv2d`` (a drop-in for ``layers.SameConv2d``) or an ``Int8Linear``
(for ``layers.Linear``), with the same ``weight`` and ``bias`` names and
shapes, so checkpoints and the weight bridge are unchanged, and the calibrated
input amax as a float32 scalar buffer on the module that owns the site, under
the name the flax ``quant`` collection gives it (``x_amax`` on a ResNet
``ConvBN``, ``{name}_x_amax`` elsewhere). ``add_site`` registers a site (or,
with ``quant`` off, the float layer) and its buffer; ``call_site`` calls it
with its input and that buffer:

- ``calib``: the buffer takes the running max of ``|x|`` (in place, on the
  device), and the site runs in floating point;
- ``int8``: symmetric TRT-style scales, the input per tensor from the amax
  (``quantize_input``) or pre-quantized by its producer (a ``QTensor``), the
  weight per output channel from its own max (``quantize_weight``), then the
  int8 kernel ``kernels/int8_conv.py`` (a dense layer is a 1x1 convolution
  over ``[M, 1, 1, K]``) and the epilogue ``acc.float() * (sx * sw) + bias``,
  cast to the compute dtype.

The weight is quantized from the float32 parameter, as the JAX package does
inside its graph. ``freeze_`` does that once into buffers (``wq``, ``sw``,
``bias32``); ``MaskRCNN.cast_for_serving_`` calls it before it casts the
weights to the compute dtype, since quantizing a bfloat16 copy would give
other ``wq`` and ``sw``. A site not frozen quantizes its float32 weight at
every call.

Every division here rounds as the float32 IEEE division does, also where a
backend multiplies by the reciprocal instead, which would move ``round()``
at .5: PyTorch's CUDA division by a Python scalar or a CPU scalar tensor
does, and so does Inductor for any divisor it knows at compile time.
``x / sx`` divides by a tensor (an engine does not fold it into a
constant, ``export/engine.py::_eager_numerics``), and ``_div`` takes the
scales' ``/ 127`` in float64.
``torch.round`` rounds half to even, as ``jnp.round`` does.

The JAX package's A/B switches are read at each call, as it reads them while
tracing: ``MASKRCNN_TPU_INT8_QRES`` and ``MASKRCNN_TPU_INT8_QC`` (the
quantized residual stream, ``models/backbones/resnet.py``) and
``MASKRCNN_TPU_INT8_DW`` (the depthwise sites of the MobileNet and
EfficientNet families, ``add_site(..., dw_switch=True)``, stay in floating
point unless it is ``1``; in ``calib`` they record all the same, so one
calibration serves both settings). ``MASKRCNN_TPU_INT8_PET``, the TPU's choice of the
convolution's output type, is not ported: any value but ``s32`` raises.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple, Union

import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.kernels.int8_conv import int8_conv
from maskrcnn_tf2_tpu_torch.models.layers import Linear, SameConv2d
from maskrcnn_tf2_tpu_torch.utils import profiling


class QTensor(NamedTuple):
    """A pre-quantized activation: ``q`` int8 in the float tensor's layout,
    ``scale`` its float32 scalar (a 0-d tensor on the device), ``dtype`` the
    compute dtype it stands for."""

    q: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype

    def dequantize(self) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(self.dtype)


def dw_on() -> bool:
    return os.environ.get("MASKRCNN_TPU_INT8_DW", "0") == "1"


def check_pet() -> None:
    pet = os.environ.get("MASKRCNN_TPU_INT8_PET", "s32")
    if pet != "s32":
        raise ValueError(f"MASKRCNN_TPU_INT8_PET={pet!r} is not ported: the TPU's choice of the int8 "
                         "convolution's output type; the port's kernel sums in int32 (s32)")


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for float32 ``a`` and ``b = 127``, the float32 IEEE quotient
    on any backend: the quotient is taken in float64 and rounded to float32.
    Taken through float64's reciprocal instead, it rounds to the same float32
    for every positive normal float32 ``a`` (a quotient by 127 is never
    within float64's error of a float32 rounding midpoint;
    ``tests/test_torch_port_int8.py::test_scale_division_is_ieee`` checks a
    sample of 21 million)."""
    return (a.to(torch.float64) / b).to(torch.float32)


def record_amax_(amax: torch.Tensor, x: torch.Tensor) -> None:
    """``amax = max(amax, max|x|)`` in place."""
    torch.maximum(amax, x.detach().abs().amax().to(torch.float32), out=amax)


def quantize_input(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``sx = max(amax, 1e-6) / 127``, ``xq =
    clip(round(x / sx), -127, 127)``. Returns ``(xq, sx)``; ``xq`` keeps
    ``x``'s layout."""
    with profiling.span("quant.quantize_input"):
        sx = _div(torch.clamp_min(amax.to(device=x.device, dtype=torch.float32), 1e-6), 127.0)
        xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -127.0, 127.0).to(torch.int8)
        return xq, sx


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per output channel (dimension 0) symmetric int8 of a float32 weight:
    ``sw = max(max|w|, 1e-12) / 127``, ``wq = round(w / sw)``."""
    if w.dtype != torch.float32:
        raise TypeError(f"weights are quantized from float32, got {w.dtype} (freeze_ before casting them)")
    sw = _div(torch.clamp_min(w.abs().amax(dim=tuple(range(1, w.dim()))), 1e-12), 127.0)
    wq = torch.round(w / sw.reshape((-1,) + (1,) * (w.dim() - 1))).to(torch.int8)
    return wq, sw


class _Int8Site:
    """What ``Int8Conv2d`` and ``Int8Linear`` share: the mode, the name of the
    owner's amax buffer (set by ``add_site``) and the weight's quantization,
    cached by ``freeze_``."""

    quant: str
    amax_name: str

    def _init_site(self, quant: str) -> None:
        if quant not in ("calib", "int8"):
            raise ValueError(f"an int8 site runs in calib or int8 mode, not {quant!r}")
        self.quant = quant
        self.frozen = False

    def float_in_int8(self) -> bool:
        """Whether the site runs in floating point in ``int8`` mode."""
        return False

    def _kernel_weight(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _quantized_weight(self):
        """``(wq [O, kh, kw, C / groups] int8, sw [O], bias float32 or None)``."""
        if self.frozen:
            return self.wq, self.sw, self.bias32
        wq, sw = quantize_weight(self.weight.detach())
        bias = None if self.bias is None else self.bias.detach().to(torch.float32)
        return self._kernel_weight(wq), sw, bias

    @torch.no_grad()
    def freeze_(self) -> None:
        """Quantize the float32 weight once, into buffers that serving reads."""
        wq, sw, bias = self._quantized_weight()
        self.register_buffer("wq", wq, persistent=False)
        self.register_buffer("sw", sw, persistent=False)
        self.register_buffer("bias32", bias, persistent=False)
        self.frozen = True


class Int8Conv2d(_Int8Site, SameConv2d):
    """``SameConv2d`` with an int8 path. ``forward(x, amax)`` takes the input
    and the site's amax buffer, or a ``QTensor`` (int8 mode only)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, bias=True, groups=1, quant="int8",
                 dw_switch=False):
        super().__init__(in_channels, out_channels, kernel_size, stride, bias=bias, groups=groups)
        self._init_site(quant)
        self.dw_switch = dw_switch and groups > 1

    def float_in_int8(self) -> bool:
        return self.dw_switch and not dw_on()

    def _kernel_weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.permute(0, 2, 3, 1).contiguous()  # [O, kh, kw, C / groups]

    def float_forward(self, x: torch.Tensor) -> torch.Tensor:
        return SameConv2d.forward(self, x)

    def forward(self, x: Union[torch.Tensor, QTensor], amax: torch.Tensor) -> torch.Tensor:
        if self.quant == "calib":
            if isinstance(x, QTensor):
                raise ValueError("a pre-quantized input outside int8 mode")
            record_amax_(amax, x)
            return self.float_forward(x)
        check_pet()
        if isinstance(x, QTensor):
            xq, sx, dtype = x
        else:
            (xq, sx), dtype = quantize_input(x, amax), x.dtype
        wq, sw, bias = self._quantized_weight()
        xq = xq.permute(0, 2, 3, 1)
        if not xq.is_contiguous():
            xq = xq.contiguous()
        y = int8_conv(xq, wq, sx, sw, bias, self.stride[0], self.groups, dtype)
        return y.permute(0, 3, 1, 2)  # NCHW in channels_last memory


class Int8Linear(_Int8Site, Linear):
    """``Linear`` with an int8 path: a 1x1 convolution over ``[M, 1, 1, K]``
    (the classifier's FC on the pooled patch keeps its (P, P, C) row order)."""

    def __init__(self, in_features, out_features, bias=True, quant="int8"):
        super().__init__(in_features, out_features, bias=bias)
        self._init_site(quant)

    def _kernel_weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.reshape(w.shape[0], 1, 1, w.shape[1]).contiguous()

    def float_forward(self, x: torch.Tensor) -> torch.Tensor:
        return Linear.forward(self, x)

    def forward(self, x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
        if self.quant == "calib":
            record_amax_(amax, x)
            return self.float_forward(x)
        check_pet()
        xq, sx = quantize_input(x, amax)
        wq, sw, bias = self._quantized_weight()
        m, k = xq.shape
        y = int8_conv(xq.reshape(m, 1, 1, k).contiguous(), wq, sx, sw, bias, 1, 1, x.dtype)
        return y.reshape(m, -1)


def add_amax(owner: nn.Module, name: str) -> None:
    """Register a calibrated amax on its owner (0 until calibrated)."""
    owner.register_buffer(name, torch.zeros((), dtype=torch.float32))


def add_site(owner: nn.Module, name: str, quant: str, float_cls: type, *args, amax: str = "",
             dw_switch: bool = False, **kwargs) -> None:
    """Register ``owner.<name>``: ``float_cls(*args, **kwargs)`` (a conv or a
    ``Linear``) when ``quant`` is ``off``; else its int8 counterpart with the
    same arguments (``Int8Linear`` for a ``Linear``, ``Int8Conv2d`` for a
    conv) and the site's input amax on ``owner`` as ``amax`` (by default
    ``{name}_x_amax``). ``dw_switch``: a grouped site that follows
    ``MASKRCNN_TPU_INT8_DW`` (the MobileNet and EfficientNet families; the
    JAX package's ``conv_site``)."""
    if quant == "off":
        layer = float_cls(*args, **kwargs)
    elif issubclass(float_cls, nn.Linear):
        layer = Int8Linear(*args, quant=quant, **kwargs)
    else:
        layer = Int8Conv2d(*args, quant=quant, dw_switch=dw_switch, **kwargs)
    if quant != "off":
        layer.amax_name = amax or f"{name}_x_amax"
        add_amax(owner, layer.amax_name)
    owner.add_module(name, layer)


def call_site(owner: nn.Module, name: str, x) -> torch.Tensor:
    """``owner.<name>`` on ``x``: the float layer alone, a site with its
    amax, or a site that stays in floating point in ``int8`` mode (see
    ``add_site``'s ``dw_switch``) without it."""
    layer = getattr(owner, name)
    if not isinstance(layer, _Int8Site):
        return layer(x)
    if layer.quant == "int8" and layer.float_in_int8():
        return layer.float_forward(x)
    return layer(x, getattr(owner, layer.amax_name))


def is_quant_buffer(name: str) -> bool:
    """A ``state_dict`` entry (or its last part) that is a calibrated amax."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf in ("x_amax", "out_amax") or leaf.endswith("_x_amax")


def freeze_int8_sites_(module: nn.Module) -> None:
    for m in module.modules():
        if isinstance(m, _Int8Site) and m.quant == "int8":
            m.freeze_()
