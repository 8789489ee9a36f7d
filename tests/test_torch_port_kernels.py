"""The PyTorch port's kernel wrappers: dispatch, plain versions, and on the card
the CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py

Tolerances on the card: NMS identical; ROIAlign within 1e-5 * max|feature|
in float32 (TF32 off) and one bf16 ulp of max|feature| in bf16 (both sum the
four weighted corners in float32 and round once, in another order).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu_torch.device import resolve_device
from maskrcnn_tf2_tpu_torch.kernels import nms as port_nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import roi_align as port_roi_kernel

from torch_port_helpers import nms_case, pyramid, random_boxes, roi_boxes

T = torch.from_numpy


# ---------------------------------------------------------------------------
# the plain versions against independent references (CPU)
# ---------------------------------------------------------------------------


def sequential_greedy(boxes, valid, thr):
    """The greedy NMS recurrence, one box at a time, in numpy float32."""
    keep = []
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    for i in range(len(boxes)):
        if not valid[i]:
            continue
        ok = True
        for j in keep:
            y1, x1 = np.maximum(boxes[i, :2], boxes[j, :2])
            y2, x2 = np.minimum(boxes[i, 2:], boxes[j, 2:])
            inter = np.float32(max(y2 - y1, 0)) * np.float32(max(x2 - x1, 0))
            union = area[i] + area[j] - inter
            if inter / np.maximum(union, np.float32(1e-10)) > np.float32(thr):
                ok = False
                break
        if ok:
            keep.append(i)
    return keep


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_plain_nms_matches_sequential_greedy(thr):
    rs = np.random.RandomState(int(thr * 10))
    boxes, _, valid, _, _, _ = nms_case("duplicate_chains", rs)
    boxes, valid = boxes[:, :700], valid[:, :700]  # spans two of the plain version's tiles
    pos, ok = port_nms_kernel.greedy_nms_plain(T(boxes), T(valid), thr, 1000)
    assert pos[0][ok[0]].tolist() == sequential_greedy(boxes[0], valid[0], thr)


def test_plain_roi_align_on_a_constant_map():
    rs = np.random.RandomState(0)
    feats = [np.full((2, s, s, 3), 2.5, np.float32) for s in (32, 16, 8, 4)]
    boxes = roi_boxes(rs, 2, 40)
    out = port_roi_kernel.roi_align_plain([T(f) for f in feats], T(boxes), 7, (128, 128)).numpy()
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    np.testing.assert_allclose(out[valid], 2.5, rtol=1e-6)
    assert not out[~valid].any()


# ---------------------------------------------------------------------------
# dispatch: no fallback hides the device or a kernel
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_launching():
    rs = np.random.RandomState(0)
    before = (port_nms_kernel.greedy_nms.launches, port_roi_kernel.roi_align.launches)
    boxes = T(random_boxes(rs, 64))[None]
    port_nms_kernel.greedy_nms(boxes, torch.ones((1, 64), dtype=torch.bool), 0.5, 10)
    port_roi_kernel.roi_align([T(f) for f in pyramid(rs, 1, 64, 4)], boxes, 7, (64, 64))
    assert (port_nms_kernel.greedy_nms.launches, port_roi_kernel.roi_align.launches) == before


def test_wrappers_refuse_other_devices_and_bad_inputs():
    boxes = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError):
        port_nms_kernel.greedy_nms(boxes, torch.ones((1, 8), dtype=torch.bool, device="meta"), 0.5, 4)
    with pytest.raises(TypeError):
        port_nms_kernel.greedy_nms(torch.zeros((1, 8, 4), dtype=torch.float64),
                                   torch.ones((1, 8), dtype=torch.bool), 0.5, 4)
    with pytest.raises(ValueError):
        port_roi_kernel.roi_align([torch.zeros((1, 8, 8, 4))], torch.zeros((2, 3, 4)), 7, (32, 32))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, maskrcnn_tf2_tpu_torch.predictor, maskrcnn_tf2_tpu_torch.weights;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'maskrcnn_tf2_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the kernels on the card (skip without one; chip_smoke.py covers the same)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 compared in full float32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["presorted_6000", "unsorted_class_offsets", "duplicate_chains", "all_invalid_row"])
def test_nms_kernel_matches_plain(cuda, case):
    boxes, scores, valid, limit, thr, _ = nms_case(case, np.random.RandomState(7))
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes_s = np.ascontiguousarray(np.take_along_axis(boxes, order[..., None], 1))
    valid_s = np.ones(scores.shape, bool) if valid is None else np.take_along_axis(valid, order, 1)
    want = port_nms_kernel.greedy_nms_plain(T(boxes_s), T(valid_s), thr, limit)
    before = port_nms_kernel.greedy_nms.launches
    got = port_nms_kernel.greedy_nms(T(boxes_s).to(cuda), T(valid_s).to(cuda), thr, limit)
    torch.cuda.synchronize()
    assert port_nms_kernel.greedy_nms.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool,n", [(7, 1000), (14, 100)])
def test_roi_align_kernel_matches_plain(cuda, dtype, pool, n):
    rs = np.random.RandomState(pool)
    feats = [T(f).to(cuda, dtype) for f in pyramid(rs, 2, 512, 256)]
    boxes = T(roi_boxes(rs, 2, n)).to(cuda)
    before = port_roi_kernel.roi_align.launches
    got = port_roi_kernel.roi_align(feats, boxes, pool, (512, 512))
    want = port_roi_kernel.roi_align_plain(feats, boxes, pool, (512, 512))
    torch.cuda.synchronize()
    assert port_roi_kernel.roi_align.launches == before + 1
    scale = max(float(f.abs().max()) for f in feats)
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-8 * scale  # one bf16 ulp
    assert float((got.float() - want.float()).abs().max()) <= tol
