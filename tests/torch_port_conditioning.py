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
3. The scene of ``tests/test_torch_port_gspmd.py`` (its four gloo ranks and
   JAX's gspmd steps, through the test's own fixture): each layout's losses
   and first moments against JAX's, in budgets of the moment rule (1e-4 *
   (leaf max + step max)); JAX's (2, 2)-mesh moments against its (1, 2)
   mesh's on running averages; JAX's gspmd losses against its single-device
   step's; and the one-process port on batch statistics, at one and two
   intra-op threads, against JAX's (1, 2) mesh.
"""

import copy
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")  # section 3's meshes

import jax  # noqa: E402
import numpy as np  # noqa: E402
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


def moment_budgets(model, mu, ref_mu):
    """The worst leaf of ``mu`` against ``ref_mu`` (flax trees or port dicts),
    in budgets of the moment rule, and its name."""
    def port(tree):
        return tree if isinstance(tree, dict) and all("." in k for k in tree) else \
            {k: v.numpy() for k, v in flax_to_state_dict({"params": tree}, model, params_only=True).items()}

    mu, ref_mu = port(mu), port(ref_mu)
    step_max = max(float(np.abs(v).max()) for v in ref_mu.values())
    return max((float(np.abs(mu[k] - v).max()) / (1e-4 * (float(np.abs(v).max()) + step_max)), k)
               for k, v in ref_mu.items())


def tensor_parallel_scene():
    import test_torch_port_gspmd as tp_test
    from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
    from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
    from maskrcnn_tf2_tpu_torch.train.train_step import make_train_step

    model, refs, _, ranks = tp_test.run._get_wrapped_function()()
    for case in ("dp1", "dp2", "dp2_bn"):
        out, ref = ranks[0][case], refs[case]
        lo = max((step_test.rel(out["losses"][0][k], v), k) for k, v in ref["losses"][0].items())
        same = "" if case == "dp2_bn" else \
            f", against its (1, 2) mesh {moment_budgets(model, out['mu'], refs['dp1']['mu'])[0]:.3g}"
        print(f"gspmd {case}: worst loss {lo[0]:.3g} relative ({lo[1]}); moments against JAX's own mesh "
              f"{moment_budgets(model, out['mu'], ref['mu'])[0]:.3g} budgets{same}")
    own = moment_budgets(model, refs["dp2"]["mu"], refs["dp1"]["mu"])
    print(f"JAX on running averages, (2, 2) mesh against (1, 2): {own[0]:.3g} budgets ({own[1]})")
    variables, batch, rng = tp_test.jax_variables(), tp_test.dp_batch(), jax.random.PRNGKey(7)
    jcfg = JaxConfig(**tp_test.TP_BN)
    (_, (single, _)), _ = jax.jit(jax.value_and_grad(step_test.jax_loss_fn(jcfg), has_aux=True))(
        variables["params"], variables["batch_stats"], batch, rng)
    worst = max((step_test.rel(refs["dp2_bn"]["losses"][0][k], v), k) for k, v in single.items())
    print(f"JAX on batch statistics, the (2, 2) mesh's losses against the single-device step's: {worst[0]:.3g} "
          f"relative ({worst[1]})")
    ref = tp_test.jax_gspmd(jcfg, variables, batch, rng, 1)
    draws = {k: torch.from_numpy(v) for k, v in tp_test.jax_draws(rng, jcfg, jcfg.post_nms_rois_training, 2).items()}
    cfg = MaskRCNNConfig(**tp_test.TP_BN)
    before = torch.get_num_threads()
    for threads in (1, 2):
        torch.set_num_threads(threads)
        state = step_test.port_state(cfg, variables)
        names = [n for n, _ in state.model.named_parameters()]
        state, _ = make_train_step(cfg)(state, step_test.torch_batch(batch), draws=draws)
        mu = {n: m.numpy() for n, m in zip(names, state.opt_state.slots["mu"])}
        worst = moment_budgets(model, mu, ref["mu"])
        print(f"one process on batch statistics at {threads} thread(s) against JAX's (1, 2) mesh: "
              f"{worst[0]:.3g} budgets ({worst[1]})")
    torch.set_num_threads(before)


if __name__ == "__main__":
    backbone_sensitivity()
    mask_head_precision()
    tensor_parallel_scene()
