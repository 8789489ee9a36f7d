"""The int8 MobileNet V2 and EfficientNet-B0 detectors at ``MASKRCNN_TPU_INT8_DW=0``, site by site against JAX.

Under the default switch the depthwise convolutions of these families stay in
floating point while their expand and project convolutions, the FPN and the
RPN run in int8. End to end the two packages then differ by more than the
1e-3 the ResNet detector is held to (C4 by ~2 %, C5 by ~4 % relative L2 on
MobileNet V2): a float depthwise convolution sums in another order than
XLA's, one value lands on the other side of the next site's rounding
boundary, and the flip spreads through the later sites one step at a time.
That is a divergence by design, so these tests hold what a wiring fault (a
wrong scale, amax or input) would break and a rounding flip does not.

Both packages run the small detector of ``tests/test_torch_port_int8.py``
with JAX's calibration carried across. JAX's forward is compiled as the
detector tests compile it (``EXACT_DIVISION``), and an interceptor records
each int8 site's and each float depthwise convolution's inputs and output.
Then:

- every int8 site of the port, fed JAX's input and amax for that call, gives
  JAX's output bit for bit. On a site with a bias, XLA:CPU contracts
  ``acc * scale + bias`` into one fused multiply-add, where the port (like
  PyTorch's element-wise ops and the CUDA kernel) rounds the product and the
  sum apart: there the port's int32 sums and scales, put through JAX's own
  compiled epilogue, give JAX's output bit for bit;
- every float depthwise convolution, fed JAX's input, within 1e-6 of JAX's
  output (relative to its largest value: a float32 summation order);
- in the two forwards as they run, the first site whose quantized input
  differs between the packages differs by at most one step;
- at least ``MIN_CLASSES_EQUAL`` of the detections' class ids agree.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.export.quantize import quantize_for_inference as jax_quantize_for_inference
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.models.quant import Int8Conv

from maskrcnn_tf2_tpu_torch.kernels.int8_conv import dequantize_plain, int8_conv_accumulate_plain
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.models.quant import _Int8Site, quantize_input
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from test_torch_port_int8 import EXACT_DIVISION, SWITCHES, detector, small_inputs

DEPTHWISE_REL = 1e-6
MIN_CLASSES_EQUAL = 0.9


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def recorded_site(module, method):
    """A JAX int8 site, or a float depthwise convolution, being called."""
    if method != "__call__":
        return False
    return isinstance(module, Int8Conv) or (isinstance(module, nn.Conv) and module.feature_group_count > 1)


def jax_sites(jcfg, jvars, images, meta):
    """JAX's forward, compiled with ``EXACT_DIVISION``: ``(outputs, {name:
    [(input, amax or None, output), ...]})``, one entry a call."""
    model = JaxMaskRCNN(jcfg)

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if recorded_site(context.module, context.method_name):
            amax = args[1] if isinstance(context.module, Int8Conv) else jnp.zeros(())
            context.module.sow("intermediates", "site", (args[0], amax, out))
        return out

    def forward(v, images, meta):
        with nn.intercept_methods(interceptor):
            out, state = model.apply(v, images, meta, train=False, mutable=["intermediates"])
        return out, state["intermediates"]

    out, inter = jax.jit(forward, compiler_options=EXACT_DIVISION)(jvars, images, meta)
    sites = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        at = keys.index("site")
        call, part = int(keys[at + 1]), int(keys[at + 2])
        sites.setdefault(".".join(keys[:at]), {}).setdefault(call, [None] * 3)[part] = np.asarray(leaf)
    return out, {name: [tuple(calls[i]) for i in sorted(calls)] for name, calls in sites.items()}


def port_sites(model, names, images, meta):
    """The port's forward: ``(outputs, {name: [(input, output), ...]}, call
    order)``. A depthwise site under ``DW=0`` runs ``float_forward`` alone.
    The recorders are taken off again after the forward."""
    seen, order, handles = {}, [], []

    def record(name, x, y):
        seen.setdefault(name, []).append((x, y))
        order.append((name, len(seen[name]) - 1))

    modules = dict(model.named_modules())
    for name in names:
        mod = modules[name]
        if isinstance(mod, _Int8Site) and mod.float_in_int8():
            float_forward = mod.float_forward

            def wrapped(x, float_forward=float_forward, name=name):
                y = float_forward(x)
                record(name, x, y)
                return y

            mod.float_forward = wrapped
        else:
            handles.append(mod.register_forward_hook(lambda mod, i, o, name=name: record(name, i[0], o)))
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(meta))
    for handle in handles:
        handle.remove()
    for name in names:
        modules[name].__dict__.pop("float_forward", None)
    return out, seen, order


@jax.jit
def jax_epilogue(acc, scale, bias):
    """JAX's dequantize epilogue (``models/quant.py:85-88``) on the port's sums, compiled by XLA:CPU."""
    return acc.astype(jnp.float32) * scale + bias


@pytest.fixture(scope="module", params=["mobilenetv2", "efficientnetb0"])
def forwards(request):
    """Both packages' int8 forwards of one detector at ``DW=0``, with JAX's
    calibration: ``(port model, JAX outputs, JAX sites, port outputs, port
    sites, port call order)``."""
    mp = pytest.MonkeyPatch()
    for name in SWITCHES:
        mp.delenv(name, raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg, jcfg, _, variables = detector(request.param)
        images, meta = small_inputs(seed=7)
        jqcfg, jvars = jax_quantize_for_inference(jcfg, dict(variables), [(jnp.asarray(images), jnp.asarray(meta))])
        jvars = jax.tree.map(np.asarray, jvars)
        jout, jsites = jax_sites(jqcfg, jvars, images, meta)
        qcfg = cfg.replace(quant_mode="int8")
        model = MaskRCNN(qcfg, device="cpu")
        model.load_state_dict(flax_to_state_dict(jvars, model))
        tout, tsites, order = port_sites(model, list(jsites), images, meta)
        yield model, jout, jsites, tout, tsites, order
    finally:
        torch.set_num_threads(before)
        mp.undo()


def int8_sites(model, jsites):
    modules = dict(model.named_modules())
    return [(name, modules[name]) for name in jsites
            if isinstance(modules[name], _Int8Site) and not modules[name].float_in_int8()]


def test_the_sites_are_recorded_alike(forwards):
    """The same sites, called as often, with inputs of the same shapes; the
    depthwise ones in floating point, the rest in int8."""
    model, _, jsites, _, tsites, _ = forwards
    assert jsites.keys() == tsites.keys()
    for name, calls in jsites.items():
        assert len(calls) == len(tsites[name]), name
        for (jin, _, jout), (tin, tout) in zip(calls, tsites[name]):
            assert jin.shape == nhwc(tin).shape and jout.shape == nhwc(tout).shape, name
    modules = dict(model.named_modules())
    depthwise = [n for n in jsites if modules[n].float_in_int8()]
    assert depthwise and all(modules[n].groups > 1 for n in depthwise)
    assert len(int8_sites(model, jsites)) == len(jsites) - len(depthwise)


def test_int8_sites_give_jax_outputs_on_jax_inputs(forwards):
    model, _, jsites, _, _, _ = forwards
    for name, mod in int8_sites(model, jsites):
        for call, (jin, amax, jout) in enumerate(jsites[name]):
            with torch.no_grad():
                got = nhwc(mod(nchw(jin), torch.tensor(amax)))
            if mod.bias is None:
                np.testing.assert_array_equal(got, jout, err_msg=f"{name} call {call}")
                continue
            xq, sx = quantize_input(nchw(jin), torch.tensor(amax))
            wq, sw, bias = mod._quantized_weight()
            acc = int8_conv_accumulate_plain(xq.permute(0, 2, 3, 1).contiguous(), wq, mod.stride[0], mod.groups)
            scale = (sx * sw).numpy()
            np.testing.assert_array_equal(np.asarray(jax_epilogue(acc.numpy(), scale, bias.numpy())), jout,
                                          err_msg=f"{name} call {call}: JAX's epilogue on the port's sums")
            np.testing.assert_array_equal(got, dequantize_plain(acc, sx, sw, bias, torch.float32).numpy(),
                                          err_msg=f"{name} call {call}: the port's own epilogue")


def test_float_depthwise_convs_match_jax(forwards):
    model, _, jsites, _, _, _ = forwards
    modules = dict(model.named_modules())
    for name in jsites:
        if not modules[name].float_in_int8():
            continue
        (jin, _, jout), = jsites[name]
        with torch.no_grad():
            got = nhwc(modules[name].float_forward(nchw(jin)))
        rel = np.abs(got - jout).max() / np.abs(jout).max()
        assert rel <= DEPTHWISE_REL, (name, rel)


def test_first_differing_int8_input_is_one_step_off(forwards):
    """The forwards as they run: the first int8 site (in the port's call
    order) whose quantized input differs is at most one step off; every
    site before it is bit-equal."""
    model, _, jsites, _, tsites, order = forwards
    modules = dict(model.named_modules())
    for name, call in order:
        if modules[name].float_in_int8():
            continue
        jin, amax, _ = jsites[name][call]
        mine = quantize_input(tsites[name][call][0], torch.tensor(amax))[0].to(torch.int32)
        theirs = quantize_input(nchw(jin), torch.tensor(amax))[0].to(torch.int32)
        off = int((mine - theirs).abs().max())
        if off:
            assert off == 1, f"{name} call {call}: the first differing input is {off} steps off"
            return


def test_detection_classes_agree(forwards):
    _, jout, _, tout, _, _ = forwards
    jcls, tcls = np.asarray(jout["detections"])[..., 4], tout["detections"][..., 4].numpy()
    assert (jcls > 0).sum() >= 1, "no detection: the comparison would be vacuous"
    assert np.mean(jcls == tcls) >= MIN_CLASSES_EQUAL
