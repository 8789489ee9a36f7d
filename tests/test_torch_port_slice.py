"""The PyTorch port's whole serving slice against the JAX package, on the CPU.

A tiny configuration (ResNet-18, 128x128, 64-wide FPN/FC/mask head, 256
pre-NMS anchors, 64 proposals, 3 classes, float32) runs through both packages
with the same bridged weights and inputs. ``detection_min_confidence=0`` keeps
every stage busy. Tolerances: proposals, detections and masks <= 1e-4 in
float32 (with identical validity masks); through ``Predictor.detect``, boxes
and class ids equal and >= 99.5 % of mask pixels equal, since the port
unmolds with PyTorch's bilinear resize where the JAX package uses cv2.
"""

import numpy as np
import pytest
import torch

import jax

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.data import transforms as jax_transforms
from maskrcnn_tf2_tpu.export import inference as jax_inference
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.ops.image import compose_image_meta
from maskrcnn_tf2_tpu.predictor import Predictor as JaxPredictor

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import transforms as port_transforms
from maskrcnn_tf2_tpu_torch.export import inference as port_inference
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from torch_port_helpers import randomize

TINY = dict(
    image_shape=(128, 128, 3), image_min_dim=128, image_max_dim=128,
    rpn_anchor_scales=(8, 16, 32, 64, 128), backbone="resnet18",
    top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
    pre_nms_limit=256, post_nms_rois_inference=64, num_classes=3,
    compute_dtype="float32", detection_min_confidence=0.0,
)


def images(n, seed):
    """Smooth random images (blurred noise), so the features are not flat."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 255, (n, 16, 16, 3))
    x = np.repeat(np.repeat(x, 8, axis=1), 8, axis=2)
    return np.clip(x + rs.normal(0, 8, x.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxMaskRCNN(jcfg)
    img = images(2, 0)
    meta = np.stack(
        [compose_image_meta(i, (128, 128, 3), (128, 128, 3), (0, 0, 128, 128), 1.0, np.ones(3)) for i in range(2)]
    )
    variables = jax.jit(lambda r: jmodel.init({"params": r}, img, meta, train=False))(jax.random.PRNGKey(0))
    variables = randomize(variables, np.random.RandomState(1))
    # Smaller RPN class weights spread the scores below 1.0: saturated scores
    # tie, and ties rank by index, which would leave the top-k untested.
    rpn_class = variables["params"]["rpn"]["rpn_class_raw"]
    rpn_class["kernel"] = rpn_class["kernel"] * np.float32(0.1)
    tmodel = MaskRCNN(MaskRCNNConfig(**TINY), device="cpu")
    state = flax_to_state_dict(variables, tmodel)
    tmodel.load_state_dict(state)
    jout = jax.jit(lambda v, i, m: jmodel.apply(v, i, m, train=False))(variables, img, meta)
    tout = tmodel(torch.from_numpy(img), torch.from_numpy(meta))
    return jcfg, variables, state, jout, tout


def close(ours, ref, tol=1e-4):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.max(np.abs(ours - ref))) <= tol * max(1.0, float(np.max(np.abs(ref))))


def test_whole_slice_matches_jax(slice_pair):
    _, _, _, jout, tout = slice_pair
    top = np.sort(np.asarray(jout["rpn_probs"])[..., 1], axis=1)[:, ::-1][:, : TINY["pre_nms_limit"] + 1]
    assert np.all(np.diff(top, axis=1) < 0), "tied RPN scores: the top-k order would not be tested"
    np.testing.assert_array_equal(tout["rpn_rois_valid"].numpy(), np.asarray(jout["rpn_rois_valid"]))
    for key in ("rpn_probs", "rpn_rois", "mrcnn_probs", "mrcnn_deltas", "detections", "mrcnn_masks"):
        assert close(tout[key], jout[key]), key
    det = tout["detections"].numpy()
    assert (det[..., 4] > 0).sum() >= 1, "no valid detection: the test would be vacuous"
    assert tout["rpn_rois_valid"].numpy().sum() >= 1


def test_predictor_detect_matches_jax(slice_pair):
    jcfg, variables, state, _, _ = slice_pair
    img = images(1, 5)[0]  # already at image_shape: no resize runs
    ref = JaxPredictor(jcfg, variables).detect([img])[0]
    ours = Predictor(MaskRCNNConfig(**TINY), state, device="cpu").detect([img])[0]
    assert len(ours["class_ids"]) >= 1
    np.testing.assert_array_equal(ours["rois"], ref["rois"])
    np.testing.assert_array_equal(ours["class_ids"], ref["class_ids"])
    np.testing.assert_allclose(ours["scores"], ref["scores"], rtol=0, atol=1e-4)
    assert ours["masks"].shape == ref["masks"].shape
    assert np.mean(ours["masks"] == ref["masks"]) >= 0.995


def test_predictor_resizes_other_sizes(slice_pair):
    _, _, state, _, _ = slice_pair
    pred = Predictor(MaskRCNNConfig(**TINY), state, device="cpu")
    rs = np.random.RandomState(3)
    imgs = [rs.randint(0, 256, (96, 200, 3)).astype(np.uint8), rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)]
    results = pred.detect(imgs)
    for img, r in zip(imgs, results):
        assert r["masks"].shape[:2] == img.shape[:2]
        assert len(r["rois"]) == len(r["class_ids"]) == len(r["scores"]) == r["masks"].shape[2]


@pytest.mark.parametrize("shape", [(300, 400, 3), (640, 480, 3), (100, 90, 3)])
def test_process_input_matches_cv2_resize(shape):
    """The port's torch resize against the JAX package's cv2 resize: the same
    meta (window, scale), every grey level within 1 (cv2 rounds uint8
    through fixed-point weights)."""
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    cfg = dict(image_min_dim=300, image_max_dim=512)
    ours, ours_meta = port_inference.process_input(img, MaskRCNNConfig(**cfg), image_id=4)
    ref, ref_meta = jax_inference.process_input(img, JaxConfig(**cfg), image_id=4)
    np.testing.assert_array_equal(ours_meta, ref_meta)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1


def test_unmold_mask_matches_cv2():
    rs = np.random.RandomState(8)
    agree, total = 0, 0
    for _ in range(20):
        mask = rs.uniform(size=(28, 28)).astype(np.float32)
        y1, x1 = rs.randint(0, 100, 2)
        box = (y1, x1, y1 + rs.randint(5, 150), x1 + rs.randint(5, 150))
        ours = port_transforms.unmold_mask(mask, box, (256, 256, 3))
        ref = jax_transforms.unmold_mask(mask, box, (256, 256, 3))
        agree, total = agree + int((ours == ref).sum()), total + ours.size
    assert agree / total >= 0.995
