"""The port's data-parallel serving (``Predictor(..., data_parallel=True)``)
against its single predictor and the JAX package's data-parallel predictor,
on the CPU, and the kernels' launch counters under threads.

The port serves on ``devices=["cpu", "cpu"]`` (two replicas, a worker thread
each); the JAX package on the conftest's 8 virtual CPU devices (the pattern
of ``tests/test_gspmd_pallas.py::test_dp_predictor_keeps_interpret_kernels``).
A tiny float32 configuration (ResNet-18 at 64 px, 64-wide heads, 3 classes,
``detection_min_confidence=0`` so that every stage is busy) with the JAX
package's initialization, randomized and bridged (``test_torch_port_slice``'s
recipe), and three images at the configured size (an odd count: both
predictors pad). Tolerances: ``rois`` and ``scores`` within 1e-4, class ids
equal (the JAX package's own rule for its data-parallel predictor), and >=
99.5 % of mask pixels equal against JAX (the port unmolds with PyTorch's
bilinear resize, the JAX package with cv2's); ``detect_stream`` equals
``detect`` over the same chunks bit for bit.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.ops.image import compose_image_meta
from maskrcnn_tf2_tpu.predictor import Predictor as JaxPredictor

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.kernels import int8_conv as int8_kernel
from maskrcnn_tf2_tpu_torch.kernels import nms as nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import roi_align as roi_kernel
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from test_torch_port_slice import images
from torch_port_helpers import randomize

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=10, num_classes=3,
            backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
            compute_dtype="float32", detection_min_confidence=0.0)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_images(n, seed):
    """``test_torch_port_slice.images`` at 64 px (the configured size: no resize)."""
    return [im[::2, ::2].copy() for im in images(n, seed)]


@pytest.fixture(scope="module")
def served():
    """Three images through the JAX data-parallel predictor, the port's single
    predictor and the port's two replicas."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxMaskRCNN(jcfg)
    imgs = small_images(3, 0)
    meta = np.stack([compose_image_meta(0, (64, 64, 3), (64, 64, 3), (0, 0, 64, 64), 1.0, np.ones(3))])
    variables = jax.jit(lambda r: jmodel.init({"params": r}, imgs[0][None], meta, train=False))(jax.random.PRNGKey(0))
    variables = randomize(variables, np.random.RandomState(1))
    rpn_class = variables["params"]["rpn"]["rpn_class_raw"]
    rpn_class["kernel"] = rpn_class["kernel"] * np.float32(0.1)
    cfg = MaskRCNNConfig(**TINY)
    state = flax_to_state_dict(variables, MaskRCNN(cfg, device="cpu"))
    jax_dp = JaxPredictor(jcfg, variables, data_parallel=True)
    single = Predictor(cfg, state, device="cpu")
    dp = Predictor(cfg, state, device="cpu", data_parallel=True, devices=["cpu", "cpu"])
    return dict(cfg=cfg, state=state, imgs=imgs, jax_dp=jax_dp, jax=jax_dp.detect(imgs), single=single, dp=dp,
                dp_out=dp.detect(imgs), single_out=single.detect(imgs))


def assert_close(ours, ref, masks=None):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a["class_ids"]) >= 1
        np.testing.assert_array_equal(a["class_ids"], b["class_ids"])
        np.testing.assert_allclose(a["rois"], b["rois"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-4)
        if masks is not None:
            assert a["masks"].shape == b["masks"].shape and np.mean(a["masks"] == b["masks"]) >= masks


def test_dp_predictor_matches_the_single_predictor(served):
    assert_close(served["dp_out"], served["single_out"], masks=1.0)


def test_dp_predictor_matches_jax_dp_predictor(served):
    assert served["jax_dp"].num_devices == len(jax.devices()) == 8
    assert_close(served["dp_out"], served["jax"], masks=0.995)


def test_num_devices(served):
    cfg, state = served["cfg"], served["state"]
    assert served["dp"].num_devices == 2 and served["single"].num_devices == 1
    assert Predictor(cfg, state, device="cpu", data_parallel=True).num_devices == 1  # devices default to [device]


def test_one_device_is_the_single_device_path(served):
    one = Predictor(served["cfg"], served["state"], device="cpu", data_parallel=True, devices=["cpu"])
    assert one.num_devices == 1 and len(one.replicas) == 1 and one.model is one.replicas[0]
    out = one.detect(served["imgs"])
    for a, b in zip(out, served["single_out"]):
        for k in ("rois", "class_ids", "scores", "masks"):
            np.testing.assert_array_equal(a[k], b[k])


def test_dp_detect_stream_equals_detect(served):
    """Chunks of 2 over 3 images: the tail chunk of one image is padded to 2
    by the stream and split over the replicas by ``detect``'s padding."""
    dp, imgs = served["dp"], served["imgs"]
    stream = list(dp.detect_stream(iter(imgs), batch_size=2))
    want = dp.detect(imgs[:2]) + dp.detect(imgs[2:])
    assert len(stream) == 3
    for a, b in zip(stream, want):
        for k in ("rois", "class_ids", "scores", "masks"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("wrapper", [nms_kernel.greedy_nms, roi_kernel.roi_align, roi_kernel.roi_align_backward,
                                     int8_kernel.int8_conv], ids=lambda w: w.__name__)
def test_launch_counters_are_exact_under_threads(wrapper):
    """Two threads count 10**4 launches each, with the interpreter switching
    threads every microsecond: the count is exact."""
    before, interval = wrapper.launches, sys.getswitchinterval()
    wrapper.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper) for _ in range(10**4)])
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert wrapper.launches == 2 * 10**4
    finally:
        sys.setswitchinterval(interval)
        wrapper.launches = before
