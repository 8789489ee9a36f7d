"""The whole model on the new backbone families, the port against the JAX
package on the CPU.

- Serving, MobileNet V2 and EfficientNet-B0: the tiny configuration of
  ``tests/test_torch_port_slice.py`` (128x128, 64-wide FPN/FC/mask head, 3
  classes, float32, ``detection_min_confidence=0``) with the backbone
  swapped. The RPN outputs, proposals, detections and masks agree within
  1e-4 of max |JAX| (the tolerance of
  ``tests/test_torch_port_models.py::test_backbone_fpn_rpn_match``), with
  identical validity masks. The FPN's laterals
  take each backbone's own C2..C5 widths (24/32/96/320 and 24/40/112/320),
  which the ResNet guess ``c5 // 8, c5 // 4, c5 // 2`` would miss.
- Training, MobileNet V2: one step's losses and gradients with the batch
  norms on their running averages, at the tolerances of
  ``tests/test_torch_port_train_step.py::test_gradients_match_jax_on_running_averages``
  (each loss within 1e-5 relative, each gradient leaf within 1e-4 of its
  own max), on that file's batch and JAX's draws.
- ``frozen_backbone`` and ``train_bn_backbone`` on MobileNet V1,
  EfficientNet-B0 and SE-ResNeXt-50 (the port alone: no backbone gradient,
  the backbone's running statistics kept, the heads' updated).

The weights are the port's seeded ones (``weights.lecun_init_``) with every
bias and batch-norm leaf randomised, carried to flax by
``weights.state_dict_to_flax``; the RPN class weights are scaled by 0.1 so
the scores do not tie in the top-k.
"""

import jax
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.ops.image import compose_image_meta

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.train.train_step import _loss
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_, state_dict_to_flax

from test_torch_port_slice import TINY, images
from test_torch_port_train_step import BASE, jax_draws, jax_loss_fn, make_batch, rel, torch_batch
from torch_port_helpers import randomize


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def paired_model(cfg):
    """The port's model and the same weights as flax variables."""
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(0))
    variables = randomize(state_dict_to_flax(model), np.random.RandomState(1))
    rpn_class = variables["params"]["rpn"]["rpn_class_raw"]
    rpn_class["kernel"] = rpn_class["kernel"] * np.float32(0.1)
    model.load_state_dict(flax_to_state_dict(variables, model))
    return model, variables


@pytest.mark.parametrize("backbone", ["mobilenetv2", "efficientnetb0"])
def test_served_outputs_match_jax(backbone):
    cfg = dict(TINY, backbone=backbone)
    model, variables = paired_model(MaskRCNNConfig(**cfg))
    jmodel = JaxMaskRCNN(JaxConfig(**cfg))
    img = images(2, 0)
    meta = np.stack([compose_image_meta(i, (128, 128, 3), (128, 128, 3), (0, 0, 128, 128), 1.0, np.ones(3))
                     for i in range(2)])
    jout = jax.jit(lambda v, i, m: jmodel.apply(v, i, m, train=False))(variables, img, meta)
    with torch.no_grad():
        tout = model(torch.from_numpy(img), torch.from_numpy(meta))
    np.testing.assert_array_equal(tout["rpn_rois_valid"].numpy(), np.asarray(jout["rpn_rois_valid"]))
    for key in ("rpn_logits", "rpn_probs", "rpn_bbox", "rpn_rois", "mrcnn_probs", "mrcnn_deltas", "detections",
                "mrcnn_masks"):
        ours, ref = tout[key].numpy(), np.asarray(jout[key])
        assert ours.shape == ref.shape, key
        assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max(), key
    assert (tout["detections"].numpy()[..., 4] > 0).sum() >= 1, "no valid detection: the test would be vacuous"


def test_gradients_match_jax_on_running_averages_mobilenetv2():
    over = dict(backbone="mobilenetv2", train_bn=False, train_bn_backbone=False)
    jcfg, cfg = JaxConfig(**dict(BASE, **over)), MaskRCNNConfig(**dict(BASE, **over))
    model, variables = paired_model(cfg)
    batch, rng = make_batch(), jax.random.PRNGKey(7)
    draws = jax_draws(rng, jcfg, cfg.post_nms_rois_training)
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))
    (_, (ref, _)), jgrads = vg(variables["params"], variables["batch_stats"], batch, rng)
    ours, losses = _loss(model, torch_batch(batch), draws, cfg)
    assert float(ref["mrcnn_mask_loss"]) > 0, "no positive ROI: the head losses are untested"
    for k, v in ref.items():
        assert rel(losses[k], v) <= 1e-5, k
    params = list(model.named_parameters())
    grads = torch.autograd.grad(ours, [p for _, p in params])
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, jgrads)}, model, params_only=True)
    for (name, _), g in zip(params, grads):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("backbone", ["mobilenet", "efficientnetb0", "seresnext50"])
def test_frozen_backbone_and_train_bn_backbone_reach_every_family(backbone):
    """``frozen_backbone`` cuts every backbone gradient and
    ``train_bn_backbone=False`` keeps the backbone's batch norms on their
    running averages while the heads' update theirs, whatever the family (the
    JAX package's ``mask_rcnn.py:115-130``)."""
    cfg = MaskRCNNConfig(**dict(BASE, backbone=backbone, frozen_backbone=True, train_bn_backbone=False))
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(0))
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith("running_var")}
    draws = jax_draws(jax.random.PRNGKey(7), JaxConfig(**dict(BASE, backbone=backbone)), cfg.post_nms_rois_training)
    total, _ = _loss(model, torch_batch(make_batch()), draws, cfg)
    total.backward()
    assert not model.backbone.training and model.classifier.training
    backbone_grads = [p.grad for p in model.backbone.parameters()]
    assert all(g is None or not g.any() for g in backbone_grads)
    assert any(p.grad is not None and p.grad.any() for p in model.fpn.parameters())
    after = model.state_dict()
    for k, v in stats.items():
        assert torch.equal(after[k], v) == k.startswith("backbone."), k
