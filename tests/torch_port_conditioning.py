"""How well conditioned the training step's gradients are, on the CPU.

    python tests/torch_port_conditioning.py     # from the root of the repository

Not a test: it prints the numbers behind the gradient tolerances of
``tests/test_torch_port_train_step.py`` and ``chip_smoke.py``.

1. The port's ResNet-18 backbone (seeded weights, a 2x3x128x128 input): how
   far a 1e-6 relative perturbation of the input moves each gradient leaf,
   with the batch norms on batch statistics and on their running averages.
2. The mask head of the whole-step parity test's scene, on the pooled input
   the port computes: JAX's float32 gradient and the port's float32 gradient
   against the port's float64 gradient of the same function, as they are and
   with ten of the sixteen ROI slots zeroed, as padding slots are.
"""

import copy
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from maskrcnn_tf2_tpu import losses as jax_losses  # noqa: E402
from maskrcnn_tf2_tpu.models.heads import FPNMaskHead as JaxMaskHead  # noqa: E402

import test_torch_port_train_step as step_test  # noqa: E402
from maskrcnn_tf2_tpu_torch import losses as port_losses  # noqa: E402
from maskrcnn_tf2_tpu_torch.models import mask_rcnn  # noqa: E402
from maskrcnn_tf2_tpu_torch.models.backbones.factory import get_backbone  # noqa: E402
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_  # noqa: E402


def worst_rel(a, b):
    """Largest leaf-relative difference of two gradient dicts, and its leaf."""
    return max((float((a[n] - b[n]).abs().max() / b[n].abs().max()), n) for n in b if float(b[n].abs().max()) > 0)


def backbone_sensitivity(draws=5):
    net = lecun_init_(get_backbone("resnet18"), torch.Generator().manual_seed(0)).to(memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 128, 128), generator=gen)
    with torch.no_grad():
        cot = [torch.randn(o.shape, generator=gen) for o in net.eval()(x).values()]

    def grads(inp, train):
        m = copy.deepcopy(net).train(train)  # a fresh copy: batch statistics update the running ones
        out = m(inp.contiguous(memory_format=torch.channels_last))
        loss = sum((o * c).sum() for o, c in zip(out.values(), cot))
        return dict(zip([n for n, _ in m.named_parameters()], torch.autograd.grad(loss, list(m.parameters()))))

    for train in (True, False):
        base = grads(x, train)
        moved = sorted(worst_rel(grads(x * (1 + 1e-6 * torch.randn(x.shape, generator=gen)), train), base)
                       for _ in range(draws))
        mode = "batch statistics" if train else "running averages"
        print(f"backbone, batch norms on {mode}: {draws} draws of a 1e-6 relative input perturbation move the "
              f"worst leaf by {moved[len(moved) // 2][0]:.3g} of its max (median draw), {moved[-1][0]:.3g} "
              f"({moved[-1][1]}) at most")


def mask_head_precision():
    jcfg, cfg, variables, batch, _, draws = step_test.setup_pair()
    model = step_test.port_state(cfg, variables).model
    pooled = {}
    original = mask_rcnn.pyramid_roi_align

    def record(feats, boxes, pool, image_shape, *args):
        out = original(feats, boxes, pool, image_shape, *args)
        if pool == cfg.mask_pool_size:
            pooled["x"] = out.detach().clone()
        return out

    mask_rcnn.pyramid_roi_align = record
    try:
        tb = step_test.torch_batch(batch)
        out = model(tb["images"], tb["image_meta"], tb["gt_class_ids"], tb["gt_boxes"], tb["gt_masks"],
                    train=True, draws=draws)
    finally:
        mask_rcnn.pyramid_roi_align = original
    cls, target = out["target_class_ids"], out["target_masks"]
    head = model.mask_head.train(True)
    jhead = JaxMaskHead(num_classes=cfg.num_classes, conv_channels=cfg.mask_conv_channels, dtype=jnp.float32)
    params, stats = variables["params"]["mask_head"], variables["batch_stats"]["mask_head"]

    def port_grads(h, x, dtype):
        h = copy.deepcopy(h).to(dtype)
        loss = port_losses.mrcnn_mask_loss(h(x.to(dtype), class_ids=cls), target.to(dtype), cls)
        return dict(zip([n for n, _ in h.named_parameters()], torch.autograd.grad(loss, list(h.parameters()))))

    def jax_grads(x):
        def loss(p):
            masks, _ = jhead.apply({"params": p, "batch_stats": stats}, jnp.asarray(x.numpy()), train_bn=True,
                                   class_ids=jnp.asarray(cls.numpy()), mutable=["batch_stats"])
            return jax_losses.mrcnn_mask_loss(masks, jnp.asarray(target.numpy()), jnp.asarray(cls.numpy()))

        g = jax.grad(loss)(params)
        return {k: v.double() for k, v in flax_to_state_dict({"params": g}, head, params_only=True).items()}

    padded = pooled["x"].clone()
    padded.reshape(16, -1)[[3, 4, 5, 6, 7, 11, 12, 13, 14, 15]] = 0.0
    for name, x in (("as computed", pooled["x"]), ("10 of 16 slots zeroed", padded)):
        exact = port_grads(head, x, torch.float64)
        weights = {n: g for n, g in exact.items() if not n.endswith("bias")}  # biases before a batch norm: 0
        ours = {n: g.double() for n, g in port_grads(head, x, torch.float32).items()}
        theirs = jax_grads(x)
        e_jax, l_jax = worst_rel({n: theirs[n] for n in weights}, weights)
        e_port, l_port = worst_rel({n: ours[n] for n in weights}, weights)
        print(f"mask head, pooled input {name}: against the float64 gradient, JAX float32 is off by "
              f"{e_jax:.3g} of the leaf's max ({l_jax}), the port's float32 by {e_port:.3g} ({l_port})")


if __name__ == "__main__":
    backbone_sensitivity()
    mask_head_precision()
