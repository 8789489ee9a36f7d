#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and training step on one CUDA
card, on every backbone of the zoo, data- and tensor-parallel, with the host
modules around them, and hold its kernels against their plain PyTorch
versions.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- the card's name and power limit (nvidia-smi); no card, no run.
2. build    -- nvcc builds every kernel of the path from ``csrc/`` into
               ``maskrcnn_tf2_tpu_torch/_build/``, one process per source.
3. capture  -- one warm-up request through ``Predictor.detect`` at the flagship
               configuration (ResNet-50-FPN, 512x512, 81 classes, bf16,
               seeded random weights) records the inputs the path hands each
               kernel wrapper.
4. holds    -- each kernel against its plain version on those inputs (and on
               edge cases): NMS identical, also on chains across the scan's
               64-row chunks and on edge cases of its chunks (N not a multiple
               of 64, limit reached mid-chunk, N = 1, N < 64, limit > N, an
               image all invalid); ROIAlign within 1e-5 * max|feature| in
               float32 (TF32 off) and one bf16 ulp of max|feature| in bf16, at
               the 16-byte channel width of the path and at the scalar width
               (C = 36 in bf16, float32 maps 4 bytes off alignment). Times
               come from CUDA events with the L2 cache flushed before each
               launch.
5. serving  -- launch counts set to 0, then 4 requests of 2 uint8 images of
               other sizes than 512; latency, valid proposals and detections,
               peak memory; every kernel must have launched twice a request,
               and K8 (the mask paste, ``kernels/paste_masks.py``) exactly
               once.
5b. paste   -- K8 on the crowd cell's shapes: 16 smooth 480x640 images
               through ``detect_stream`` (batch 8, depth 2) with the launch
               count set to 0 first, exactly 1 launch a batch, then 8 of them
               through ``detect`` (1 more); each streamed result equal to the
               host loop (``unmold_detections``) over the same forward's
               outputs, and ``detect``'s equal to the stream's; the first
               batch's real forward outputs pasted by K8 into device memory
               and into pinned host memory, 0 differing bytes against
               ``paste_masks_plain`` and no byte written past each image's
               block; a batch with no detection writes no byte. Times: K8
               into each (CUDA events, L2 flushed, mean of 10) beside its
               bound (the bytes written at HBM's rate, and at the host link's
               for pinned memory), the plain version on the host clock; the
               host's ATen CPU capability (the exactness was pinned on
               AVX512's paths) is printed beside the check.
6. train capture -- one ``make_train_step`` step at the flagship's training
               configuration (batch 2, 2-8 seeded GT boxes per image, 56x56
               mini masks) records the inputs of ``greedy_nms``, ``roi_align``
               and ``roi_align_backward``: one, two and two calls.
7. holds, training -- the NMS and ROIAlign forward kernels against their
               plain versions on the captured training calls (2x6000 -> 2000
               at 0.7; 7x7 and 14x14 over 2x200 ROIs), timed with their bounds
               (``train_ms``, ``train_bound_ms``); then the ROIAlign backward
               kernel against its plain version
               on the captured 7x7 and 14x14 calls (bf16 within one bf16 ulp of
               max|plain|; float32 within 1e-5 * max|plain|, with zero-area,
               full-image and sliver boxes in front, where zero-area ROIs must
               leave the maps untouched), on boxes that straddle the kernel's
               tiles and on elongated ones, at the scalar width (C = 36, both
               dtypes) and on a float32 pyramid over 88 MiB (the TPU's second
               backward kernel's regime); every hold also launches twice and
               wants the same bits, and wants exact zeros, in maps from
               ``torch.empty`` over poisoned memory, wherever no ROI reaches
               (the plain backward of a cotangent of ones is zero there); the
               ROIs per tile and terms per pixel of the captured
               calls are printed; times as in 4.
8. tiny train cross-check -- one training step of a small float32 model,
               card against CPU, same weights and draws: losses within 1e-4
               relative with the batch norms on batch statistics and on their
               running averages, and in the latter every gradient leaf within
               1e-4 of its max plus the step's largest gradient.
9. train    -- launch counts set to 0, then 5 steps at full width: finite
               losses, ``grad_finite`` 1, parameters changed, each step one NMS,
               two forward and two backward ROIAlign launches; median step time
               over steps 2-5 and peak memory.
10. train_model -- the loop a user runs, at the flagship's widths (ResNet-50-FPN,
               512x512, bf16, batch 2, 2000 proposals, 200 ROIs per image,
               81 classes) from a dataset: 12 + 4 synthetic shapes images
               written as a COCO directory with COCO's 80 categories (the
               shapes are the first three; JPEG, RLE) and read back through
               ``CocoDataset``, device augmentation on (flip, zoom-out 0.25,
               photometric 0.2), a sample cache and checkpoints in a temporary
               directory; 2 epochs of 3 steps with validation. Holds: (a)
               launch counts set to 0, then exactly steps x (1, 2, 2) plus eval
               steps x (1, 2, 0) of (NMS, ROIAlign forward, backward); (b)
               finite losses and moved weights; (c) a best-only checkpoint on
               disk; (d) a SIGTERM sent from the metric writer mid-epoch
               leaves a preemption checkpoint, and resume runs to the end; (e)
               a run stopped at the epoch boundary resumes with the step
               count, the LR and the plateau state of the unbroken run. Prints
               the loader's images/s alone on the host, train_model's
               images/s, the share of the loop's time spent waiting on the
               loader and peak memory, each with the card line. The
               directory stays until phase 15 is done.
11. pretrained -- a seeded torchvision-keyed ResNet-50 ``state_dict`` saved to
               a ``.pth`` (``train/synthetic.py``) loads through
               ``create_train_state`` at the flagship's training config on the
               card: coverage 265/265 and every backbone entry equal to the
               file's bit for bit; then 2 training steps with launch counts
               set to 0: finite losses, ``grad_finite`` 1, exactly 1, 2 and 2
               launches a step of NMS, ROIAlign forward and backward.
12. evaluate -- phase 10's best checkpoint, put where ``cli/evaluate.py``
               looks for it, evaluated by ``cli.evaluate.main`` on the
               synthetic COCO val set, then through ``evaluate_dataset`` over
               ``detect`` and over ``detect_stream``: equal AP dicts, exactly
               2 NMS and 2 ROIAlign forward launches and 1 K8 launch a batch
               of 2 on each route; ``detect_stream`` (batch 2, depth 2) equal to ``detect``
               over the same chunks, image for image; AP, seconds per image
               and images/s of both routes with the card line.
13. detect CLI -- ``cli.detect.main`` on 2 JPEGs it is handed, with ``--out``:
               the JSON equals ``Predictor.detect``'s results and the overlay
               PNGs exist; 2 NMS and 2 ROIAlign forward launches an image.
14. backbone zoo -- launch counts set to 0, then (a) ``seresnet34``,
               ``seresnext50``, ``senet154``, ``mobilenet``, ``mobilenetv2``
               and ``efficientnetb0`` at the flagship's serving and training
               configurations (512x512, 81 classes, bf16, 256-wide FPN and
               heads, seeded random weights): 2 requests of 2 images through
               ``Predictor.detect`` (exactly 2 NMS and 2 ROIAlign forward
               launches each) and 2 ``make_train_step`` steps of batch 2
               (exactly 1, 2, 2 launches each, finite losses, ``grad_finite``
               1, every weight moved); latency, step time and peak memory;
               (b) all 25 keys build on the card and serve one 256x256 image
               (2 and 2 launches), with their parameter counts
               (``utils/summary.py``) and latency; (c) seeded timm
               EfficientNet-B0 and torchvision MobileNetV2 files through
               ``create_train_state`` at full coverage, bit-equal to the
               file, then one step each (1, 2, 2); the counts are read here.
               (d) EfficientNet-B0 and SENet154's code at one block a stage
               in float32, card (channels_last, TF32 off) against CPU with
               the same weights: C1..C5 within 1e-4 of max |CPU|, on running
               averages and on batch statistics.
15. train CLI -- ``cli.coco_train.main`` at the flagship's widths (ResNet-50,
               512x512, batch 2, 81 classes, the CLI's ``coco_config``) on
               phase 10's COCO directory: 6 training and 2 validation images,
               2 epochs, host augmentation with the weather and extended sets,
               TensorBoard when the package is there (the script says whether
               it is). Holds: launch counts set to 0, then exactly steps x
               (1, 2, 2) plus eval steps x (1, 2, 0); finite losses; a
               best-only checkpoint in the directory the configuration's md5
               names; the run again from a ``--config`` YAML with one flag
               typed builds the same md5 and resumes that checkpoint with
               nothing left to train. Prints the loader's images/s on the host
               (4 threads, 12 JPEGs of 512x512) with no augmentation, the
               default set, both sets, and each transform alone at
               probability 1.0, and the CLI run's loader wait share, each with
               the card line.
16. data parallel -- on phase 10's COCO directory, through
               ``parallel/multihost_dryrun.launch`` (every wait bounded; a
               failed rank fails the script): (a) two gloo ranks sharing the
               card, the flagship at one image a rank, 3 data-parallel steps
               with per-rank BN and with sync-BN: launches (1, 2, 2) a step on
               each rank, one fused all-reduce a step, the ranks bit-identical
               after every step, the first update against its
               single-process emulation (each half through ``_loss``,
               averaged, then the optimizer: the reduced gradients, read from
               the first adamax moment, within the whole-step test's rule,
               the parameters within 1e-3 lr where |grad| >= 1e-4), each
               kernel held against its plain version on the inputs rank 0's
               first step gave its wrapper (one image a rank) and timed beside
               its bound, the sync BatchNorm at C2 against one BatchNorm over
               the concatenated batch; (c) ``train_model`` with sync-BN under
               the two ranks, 2 epochs of 3 steps with validation (launches
               exact, rank 0 alone writes), the preemption drill (rank 1
               signalled after rank 0's second step: both stop after the same
               step, one preemption checkpoint) and the resume; (b) one NCCL
               rank through ``parallel.distributed.initialize()`` as
               ``torchrun --standalone --nproc_per_node 1`` sets it up: 2
               steps bit-equal to ``make_train_step``; (d) ``torchrun
               --standalone --nproc_per_node 1 -m
               maskrcnn_tf2_tpu_torch.cli.coco_train --sync_bn``: 1 epoch of
               2 steps, a finite loss. Prints the fused buffer's size, the
               all-reduce's ms under gloo and NCCL, the sync-BN all-reduces a
               step (counted through a patched ``torch.distributed.
               all_reduce``), and train_model's images/s under the two ranks
               beside the single-process rate, marked as two ranks sharing
               one card.
17. int8 serving -- (a) ``quantize_for_inference`` calibrates the flagship
               (seeded weights) on the card over the 4 requests; (b) one int8
               request records K7's (``csrc/int8_conv.cu``) inputs: every
               distinct site shape held bit-equal to ``int8_conv_plain`` in
               float32 and bf16, launched twice, and timed beside its bound
               (2 M N K operations at 1,979 int8 TOP/s, or its bytes at 3.35
               TB/s), the plain version, the bf16 cuDNN convolution of the
               same shape and, for every 1x1 stride-1 site, ``torch._int_mm``
               on the same int8 operands; each shape's plan (kernel, copy
               width, grid, split of K) is logged, and every site of one
               group must have run on the tensor-core path; the same holds
               on ResNeXt's groups of 4 and 8, depthwise 3x3 and 5x5/2, I =
               3, 4, 36 and 40, stride 2 on odd sizes, M, N and K tails, a
               split of K, the classifier FC at K = 12544 and an input whose
               amax is 0; before any of it, ``cuobjdump --dump-sass`` of the
               built library must show int8 tensor-core instructions
               (``IGMMA``, wgmma's) in every instantiation of the tensor-core
               kernel; (c) launch counts set to 0, then 4 int8
               requests of 2 images: (NMS, ROIAlign, K7) = (2, 2, 65) each; 71
               K7 a request with ``quant_classifier`` and
               ``quant_mask_head``; one request each on ResNeXt-50 (65 K7)
               and MobileNet V2 (46), every site shape of each held and
               timed as in (b); the share of each image's top-5 bf16
               detections that int8 matches (same class, IoU >= 0.9), held at
               ``TOP5_FLOOR``; the int8 and bf16 forwards at batch 2 and 8
               (CUDA events, median of 10); (d) a small float32 int8 model
               with one calibration, card (TF32 off) against CPU: every int8
               site call bit-equal on the CPU's inputs, end to end held at
               floors that a wiring fault falls below; (e) ``cli.detect
               --int8`` on 3 JPEGs.
18. engine  -- serving engines and program export (``export/engine.py``,
               ``export/serialize.py``): (a) a tiny float32 model's engine
               and program from one seeded state dict, against eager on the
               card (TF32 off) within 1e-4 with equal class ids, 2/2 launches
               in the engine's call; (b) the flagship's bf16 engine at batch
               2: build seconds and size, then, in a fresh process, the load
               seconds and the first call, with ``_build/`` and a fresh
               Inductor cache untouched (nothing built, nothing compiled),
               and the 4 requests: NMS and ROIAlign launched exactly 8 times
               each inside the engine; against ``Predictor._forward``, the
               share of eager's detections the engine has too (same class,
               IoU >= 0.9), their mask pixels that agree at 0.5, held at
               ``ENGINE_*_FLOOR``, and class ids equal over all slots, held
               at phase 17(d)'s floor; (c) the same for an int8 engine of
               phase 17's calibrated state dict, K7 exactly 260 times (and in
               (a) a tiny int8 engine against the live int8 model); the
               engine and eager forwards at batch 2 by CUDA events, bf16 and
               int8;
               (d) a flipped byte, a trailing byte, a foreign device name,
               torch version and kernel digest, each refused with its error.
19. tensor parallel -- ``parallel/gspmd.py`` and ``Predictor(data_parallel=
               True)`` at the flagship's widths (FC 1024 split 512 + 512),
               gloo ranks and replicas sharing the card through
               ``multihost_dryrun.launch`` (every wait bounded; a failed rank
               fails the script): (a) DP1xTP2, two ranks, 3 steps: launches
               (1, 2, 2) a step on each rank, FC shards [512, 12544] and
               [1024, 512], after every step the replicated leaves
               bit-identical over the world, each shard over its data group
               and FC1's input over the model group; the first update
               gathered whole and held by phase 16's rule against one
               process's ``make_train_step`` whose classifier computes the
               split head's arithmetic; K1, K3 and K4 held against their
               plain versions on rank 0's first-step inputs; (b) DP2xTP2,
               four ranks, one image a data rank, 2 steps with the same
               checks, the first update held on a float32 step with the batch
               norms on running averages (with batch statistics the data
               ranks sum them in another order, which the backbone's
               gradients amplify at random weights), and a float32 step on
               batch statistics over the data group whose losses and
               running statistics are held against one process's (1e-5 of
               max(1, |value|)); (c) ``train_model`` in
               gspmd mode under DP1xTP2 on phase 10's COCO directory (1 epoch
               of 3 steps, validation, launches exact, rank 0 alone writes a
               whole checkpoint), then that checkpoint restored into one
               process and served; (d) ``Predictor(data_parallel=True,
               devices=["cuda:0", "cuda:0"])`` on the 4 requests: (NMS,
               ROIAlign) (2, 2) a replica a request, against the single
               predictor on each replica's rows (one image: cuDNN's
               algorithms depend on the batch) at phase 18's and phase
               17(d)'s floors,
               ``detect_stream`` equal to ``detect`` (K8 once a batch, on the
               first replica), one int8 request with K7 65 a replica. Prints the model-group all-reduces' bytes and
               ms, the steps' ms beside the single-process step's, the two
               predictors' forwards; ranks and replicas share one card, so
               no number is a scaling number.
20. last modules -- (a) phase 10's COCO directory copied with every
               instance's counts compressed to a string, plus three 480x640
               training images, each with a crowd mask of 60, 2,000 or 20,000
               runs and a rectangle: every RLE mask decoded by the C decoder
               (``native/rle.py``) equal bit for bit to the numpy decoder's
               (``data/coco.py::rle_to_mask_plain``) and to its source runs;
               each decoder's ms per crowd mask, the loader's images/s (4
               threads, no cache) under each in turns and its batches equal;
               ``auto_download`` through ``file://`` zips of that directory
               equal to it, and a second call, with the zips gone, extracts
               nothing; (b) ``utils/profiling.trace`` of one flagship request
               through ``Predictor.detect``: launches (NMS, ROIAlign) exactly
               (2, 2), and ``top_ops(device_only=True)`` lists
               ``nms_mask_kernel``, ``nms_scan_kernel`` and
               ``roi_align_kernel`` and only device events; the top 10
               printed; (c) the tensor box helpers on the card against the
               CPU: boxes from masks exact, ``norm_boxes`` and its round trip
               through ``denorm_boxes`` within one float32 ulp. Host numbers
               carry the card line.
21. report  -- a ``{"kernels": [...]}`` line, the card line, and last the
               ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gzip
import hashlib
import io
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch._inductor.async_compile import shutdown_compile_workers

from maskrcnn_tf2_tpu_torch.cli import coco_train as cli_train
from maskrcnn_tf2_tpu_torch.cli import detect as cli_detect
from maskrcnn_tf2_tpu_torch.cli import evaluate as cli_evaluate
from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import augment as host_augment
from maskrcnn_tf2_tpu_torch.data import coco as coco_mod
from maskrcnn_tf2_tpu_torch.data import image_io
from maskrcnn_tf2_tpu_torch.data.coco import COCO_CLASS_NAMES, CocoDataset
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader
from maskrcnn_tf2_tpu_torch.eval.coco_eval import evaluate_dataset
from maskrcnn_tf2_tpu_torch.export import engine as engine_mod
from maskrcnn_tf2_tpu_torch.export.engine import build_engine, load_engine
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.export.quantize import quantize_for_inference
from maskrcnn_tf2_tpu_torch.export.serialize import export_program, load_program
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.kernels import int8_conv as int8_kernel
from maskrcnn_tf2_tpu_torch.kernels import nms as nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import paste_masks as k8
from maskrcnn_tf2_tpu_torch.kernels import roi_align as roi_kernel
from maskrcnn_tf2_tpu_torch.models.backbones.factory import backbone_names, get_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.pretrained import convert_torch_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import ResNet
from maskrcnn_tf2_tpu_torch.models import layers, quant
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks
from maskrcnn_tf2_tpu_torch.ops import boxes as boxes_op
from maskrcnn_tf2_tpu_torch.ops import nms as nms_op
from maskrcnn_tf2_tpu_torch.ops import roi_align as roi_op
from maskrcnn_tf2_tpu_torch.ops.targets import draw_uniforms
from maskrcnn_tf2_tpu_torch.parallel import distributed, gspmd, multihost_dryrun
from maskrcnn_tf2_tpu_torch.parallel.mesh import (check_equal, check_replicated, make_mesh_2d, shard_batch,
                                                  tensor_checksum)
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.loop import step_generator, train_model
from maskrcnn_tf2_tpu_torch.train.optimizer import build_optimizer
from maskrcnn_tf2_tpu_torch.train.synthetic import (resnet_state_dict, shapes_coco_datasets, smooth_image,
                                                     synthetic_batch, timm_efficientnet_state_dict,
                                                     torchvision_mobilenet_v2_state_dict)
from maskrcnn_tf2_tpu_torch.train.train_step import (_bn_stats, _draws, _loss, create_train_state,
                                                     fused_all_reduce_mean, make_train_step)
from maskrcnn_tf2_tpu_torch.utils import profiling
from maskrcnn_tf2_tpu_torch.utils.summary import count_params
from maskrcnn_tf2_tpu_torch.utils.tb_writer import make_tb_writer
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
HOST_LINK_BYTES_PER_S = 64e9  # PCIe 5.0 x16, one direction: K8 writes pinned host memory over it
CROWD_SHAPE = (480, 640)  # the benchmark's crowd cell: batch 8 of 480x640 images, 100 detections each
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
IOU_FLOPS = 13  # per box pair: 4 min/max, 2 sub, 2 clamps, 1 mul, 2 add/sub, 1 max, 1 div
REQUEST_SIZES = [((480, 640), (427, 640)), ((640, 480), (375, 500)),
                 ((600, 800), (333, 500)), ((720, 1280), (384, 512))]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def flagship_config() -> MaskRCNNConfig:
    return MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone="resnet50",
                          compute_dtype="bfloat16", detection_min_confidence=0.0)


def kernel_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each one timed on its
    own with CUDA events after the L2 cache was flushed. A ~1 ms sleep kernel
    runs between the flush and the start event, so the wrapper's host work is
    enqueued while the card is busy and the events bracket device time only
    (host work longer than the sleep, as in the plain versions, still counts)."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def nms_bound(boxes_s, valid_s, positions, out_valid):
    """(bytes time, operations time) in ms. Operations count the pairs greedy
    NMS must test on this data, up to the box that fills the limit: a kept box
    against every box kept before it, a suppressed one against one box."""
    b, n, _ = boxes_s.shape
    limit = positions.shape[1]
    pairs = 0
    for i in range(b):
        kept = positions[i][out_valid[i]].long().cpu()
        keep = torch.zeros(n, dtype=torch.long)
        keep[kept] = 1
        end = int(kept[-1]) + 1 if len(kept) == limit else n
        kept_before = torch.cumsum(keep, 0) - keep
        need = torch.where(keep.bool(), kept_before, torch.ones_like(keep))
        pairs += int((need[:end] * valid_s[i, :end].cpu().long()).sum())
    nbytes = b * n * (16 + 1) + b * limit * (4 + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, pairs * IOU_FLOPS / F32_FLOPS * 1e3


def summarize(max_abs_err, timings):
    """The kernels-line fields from per-call (kernel ms, plain ms, bytes time,
    operations time) tuples: times and bounds summed over the call sites."""
    k, p, bt, ot = zip(*timings)
    return dict(max_abs_err=max_abs_err, ms=sum(k), plain_ms=sum(p),
                bound_ms=sum(max(b, o) for b, o in zip(bt, ot)),
                bound_by="bytes" if sum(bt) >= sum(ot) else "operations")


def roi_bound(features, boxes, pool):
    b, n, _ = boxes.shape
    c = features[0].shape[-1]
    item = features[0].element_size()
    out_elems = b * n * pool * pool * c
    nbytes = sum(f.numel() for f in features) * item + boxes.numel() * 4 + out_elems * item
    return nbytes / HBM_BYTES_PER_S * 1e3, out_elems * 8 / F32_FLOPS * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def capture_inputs(predictor: Predictor, images):
    """One request through the real path, recording each wrapper's inputs."""
    calls = {"nms": [], "roi_align": []}

    def recorder(fn, key):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)

        return wrapped

    with mock.patch.object(nms_op, "greedy_nms", recorder(nms_kernel.greedy_nms, "nms")), \
            mock.patch.object(roi_op, "roi_align", recorder(roi_kernel.roi_align, "roi_align")):
        predictor.detect(images)
    torch.cuda.synchronize()
    if len(calls["nms"]) != 2 or len(calls["roi_align"]) != 2:
        raise RuntimeError(f"expected 2 calls of each wrapper per request, saw "
                           f"{ {k: len(v) for k, v in calls.items()} }")
    return calls


def run_paste_masks(predictor, device, card, flush):
    """Phase 5b: K8 on the crowd cell's shapes, through the predictor and on
    the first batch's real forward outputs against its plain version."""
    log(f"== paste: K8 (csrc/paste_masks.cu) on 16 crowd images of {CROWD_SHAPE[0]}x{CROWD_SHAPE[1]}, batch 8; "
        f"host ATen CPU capability {torch.backends.cpu.get_cpu_capability()} (K8's bilinear was pinned on AVX512's)")
    cfg = predictor.config
    rs = np.random.RandomState(SEED + 5)
    images = [smooth_image(rs, *CROWD_SHAPE) for _ in range(16)]
    forwards = []
    forward = predictor._forward

    def recorded(molded, metas):
        det, masks = forward(molded, metas)
        forwards.append((det.clone(), masks.clone(), metas.copy()))
        return det, masks

    predictor._forward = recorded
    try:
        torch.cuda.synchronize()
        k8.paste_masks.launches = 0
        streamed = list(predictor.detect_stream(iter(images), batch_size=8, depth=2))
        stream_launches = k8.paste_masks.launches
        detected = predictor.detect(images[8:])
        if (stream_launches, k8.paste_masks.launches) != (2, 3):
            raise AssertionError(f"K8 launched {stream_launches} times over 2 streamed batches and "
                                 f"{k8.paste_masks.launches - stream_launches} over one detect; want 1 a batch")
    finally:
        del predictor._forward

    def equal(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    for start, (det, masks, metas) in zip((0, 8), forwards):
        det, masks = det.cpu().numpy(), masks.cpu().numpy()
        for i, img in enumerate(images[start:start + 8]):
            want = unmold_detections(det[i], masks[i], img.shape, cfg.image_shape, metas[i][7:11])
            if not equal(streamed[start + i], want):
                raise AssertionError(f"detect_stream's image {start + i} differs from the host loop over its outputs")
    if not all(equal(a, b) for a, b in zip(detected, streamed[8:])):
        raise AssertionError("detect differs from detect_stream on the same crowd batch")

    det, masks, metas = forwards[0]
    shapes = [CROWD_SHAPE] * len(metas)
    offsets, total, largest = k8.block_layout(shapes, det.shape[1])
    meta_d, off_d = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (metas, offsets))
    host = [t.cpu() for t in (det, masks, meta_d, off_d)]
    want = torch.full((total,), 0xAB, dtype=torch.uint8)
    t0 = time.perf_counter()
    want_kept = k8.paste_masks(*host, cfg.image_shape, want, largest).numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = want.numpy()
    ends = [o + -(-CROWD_SHAPE[0] * CROWD_SHAPE[1] * int(k) // 16) * 16 for o, k in zip(offsets, want_kept)]
    outs = {"device": torch.full((total,), 0xAB, dtype=torch.uint8, device=device),
            "pinned": torch.full((total,), 0xAB, dtype=torch.uint8).pin_memory()}
    differing = {}
    for where, out in outs.items():
        kept = k8.paste_masks(det, masks, meta_d, off_d, cfg.image_shape, out, largest).cpu().numpy()
        torch.cuda.synchronize()
        got = out.cpu().numpy()
        if not np.array_equal(kept, want_kept):
            raise AssertionError(f"K8 into {where} memory kept {kept.tolist()}, the plain version {want_kept.tolist()}")
        differing[where] = sum(int((got[o:o + CROWD_SHAPE[0] * CROWD_SHAPE[1] * int(k)]
                                    != want[o:o + CROWD_SHAPE[0] * CROWD_SHAPE[1] * int(k)]).sum())
                               for o, k in zip(offsets, kept))
        outside = np.ones(total, bool)
        for o, e in zip(offsets, ends):
            outside[o:e] = False
        if differing[where] or (got[outside] != 0xAB).any():
            raise AssertionError(f"K8 into {where} memory: {differing[where]} bytes differ from the plain version, "
                                 f"{int((got[outside] != 0xAB).sum())} written past the images' blocks")
    if int(want_kept.sum()) == 0:
        raise AssertionError("the crowd batch kept no detection: nothing was pasted")
    empty = torch.full((total,), 0xAB, dtype=torch.uint8).pin_memory()
    none_kept = k8.paste_masks(torch.zeros_like(det), masks, meta_d, off_d, cfg.image_shape, empty, largest)
    torch.cuda.synchronize()
    if none_kept.any() or (empty.numpy() != 0xAB).any():
        raise AssertionError("a batch with no detection wrote mask bytes")

    written = sum(CROWD_SHAPE[0] * CROWD_SHAPE[1] * int(k) for k in want_kept)
    ms = {where: kernel_ms(lambda out=out: k8.paste_masks(det, masks, meta_d, off_d, cfg.image_shape, out, largest),
                           10, flush) for where, out in outs.items()}
    stats = dict(stream_launches=stream_launches, masks=int(want_kept.sum()), bytes_written=written,
                 ms=ms["device"], bound_ms=written / HBM_BYTES_PER_S * 1e3, pinned_ms=ms["pinned"],
                 pinned_bound_ms=written / HOST_LINK_BYTES_PER_S * 1e3, plain_ms=plain_ms,
                 host_cpu_capability=torch.backends.cpu.get_cpu_capability())
    log(f"  detect_stream (batch 8, depth 2) and detect: K8 {stream_launches} + 1 launches for 3 batches; every "
        f"result equal to the host loop's over the same outputs; kept masks a streamed image "
        f"{[len(r['class_ids']) for r in streamed]}")
    log(f"  K8 on the first batch's outputs ({stats['masks']} masks, {written / 1e6:.1f} MB): differing bytes "
        f"against paste_masks_plain {differing} (host capability {stats['host_cpu_capability']}); no detection, no "
        f"byte written")
    log(f"  K8 into device memory {stats['ms']:.4f} ms (bound {stats['bound_ms']:.4f} at 3.35 TB/s), into pinned "
        f"host memory {stats['pinned_ms']:.4f} ms (bound {stats['pinned_bound_ms']:.4f} at 64 GB/s); plain version "
        f"{plain_ms:.1f} ms on the host ({card})")
    return stats


def roi_like_boxes(rs, n):
    y1, x1 = rs.uniform(0, 0.7, (2, n))
    h, w = rs.uniform(0.01, 0.3, (2, n))
    return np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1).astype(np.float32)


def edge_boxes(boxes):
    """The path's boxes with zero-area, full-image, edge and extreme boxes in front."""
    extra = torch.tensor(
        [[0.0, 0.0, 1.0, 1.0], [0.3, 0.3, 0.3, 0.6], [0.0, 0.0, 0.0, 0.0],
         [0.0, 0.1, 1.0, 0.102], [0.5, 0.0, 0.5005, 1.0], [0.999, 0.999, 1.0, 1.0],
         [0.0, 0.97, 0.03, 1.0], [0.97, 0.0, 1.0, 0.03]],
        device=boxes.device,
    )
    b = boxes.shape[0]
    return torch.cat([extra[None].expand(b, -1, -1), boxes[:, : boxes.shape[1] - len(extra)]], 1).contiguous()


def staircases(rs, chains, steps, interleave):
    """Boxes [chains * steps, 4]: staircases of 0.3-wide boxes stepping 0.07 (each
    overlaps the next above 0.5, not the one after), chain by chain or
    interleaved row by row."""
    base = rs.uniform(0, 0.6, (chains, 2))
    y1 = base[:, None, 0] + 0.07 * np.arange(steps)[None, :]  # [chains, steps]
    x1 = np.repeat(base[:, 1:], steps, 1)
    if interleave:
        y1, x1 = y1.T, x1.T
    y1, x1 = y1.reshape(-1), x1.reshape(-1)
    return np.stack([y1, x1, y1 + 0.3, x1 + 0.3], -1).astype(np.float32)


def chain_case(device):
    """Staircases of equal boxes, each step overlapping the next above the
    threshold but not the one after it: greedy order alternates kept and
    suppressed along each chain, inside and across the scan's chunks."""
    rs = np.random.RandomState(SEED + 1)
    boxes = staircases(rs, 200, 30, False)[None]
    valid = rs.uniform(size=boxes.shape[:2]) > 0.05
    return torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)


def nms_edge_cases(device):
    """(name, boxes, valid, iou, limit) aimed at the scan's 64-row chunks."""
    rs = np.random.RandomState(SEED + 7)

    def case(name, boxes, limit, thr=0.5, valid=None):
        boxes = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(device)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool) if valid is None else torch.from_numpy(valid)
        return name, boxes, valid.to(device), thr, limit

    # the limit filled in the middle of a chunk, with kept rows after it there
    mid = np.stack([roi_like_boxes(rs, 1000) for _ in range(2)])
    pos, ok = nms_kernel.greedy_nms_plain(torch.from_numpy(mid), torch.ones((2, 1000), dtype=torch.bool), 0.5, 1000)
    kept = pos[0][ok[0]].tolist()
    stop = next(k for k in range(1, len(kept)) if kept[k] // 64 == kept[k - 1] // 64 >= 2
                and 16 <= kept[k - 1] % 64 <= 48)
    half_invalid = np.ones((2, 700), bool)
    half_invalid[1] = False
    return [
        case("N 1000, not a multiple of 64", mid, 1000),
        case(f"limit {stop} mid-chunk (row {kept[stop - 1]} of chunk {kept[stop - 1] // 64})", mid, stop),
        case("3 interleaved chains of 200 across 10 chunks", staircases(rs, 3, 200, True)[None], 1000),
        case("N 1", roi_like_boxes(rs, 2)[:, None], 1),
        case("N 1, limit 3", roi_like_boxes(rs, 2)[:, None], 3),
        case("N 50 < 64, limit 100", roi_like_boxes(rs, 50)[None], 100, 0.3),
        case("N 65", roi_like_boxes(rs, 65)[None], 100, 0.3),
        case("N 300, limit 1000 > N", roi_like_boxes(rs, 300)[None], 1000),
        case("image 1 all invalid", np.stack([roi_like_boxes(rs, 700) for _ in range(2)]), 100, 0.5, half_invalid),
    ]


def hold_nms(calls, flush, extra=()):
    """Kernel identical to plain on each call (timed, with its bound) and on
    each extra case (not timed); the summed times and bounds."""
    timings = []
    cases = [("path", *call[0]) for call in calls] + list(extra)
    for name, boxes_s, valid_s, thr, limit in cases:
        got = nms_kernel.greedy_nms(boxes_s, valid_s, thr, limit)
        want = nms_kernel.greedy_nms_plain(boxes_s, valid_s, thr, limit)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if not same:
            diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
            raise AssertionError(f"NMS kernel disagrees with its plain version ({name}, "
                                 f"{tuple(boxes_s.shape)}, iou {thr}): {diff} entries differ")
        kept = got[1].sum(1).tolist()
        line = f"  {name}: boxes {tuple(boxes_s.shape)} iou {thr} limit {limit} kept {kept}: identical"
        if name == "path":
            k = kernel_ms(lambda: nms_kernel.greedy_nms(boxes_s, valid_s, thr, limit), 20, flush)
            p = kernel_ms(lambda: nms_kernel.greedy_nms_plain(boxes_s, valid_s, thr, limit), 3, flush)
            bt, ot = nms_bound(boxes_s, valid_s, *got)
            timings.append((k, p, bt, ot))
            line += f"; kernel {k:.4f} ms, plain {p:.3f} ms, bound {max(bt, ot) * 1e3:.3f} us"
        log(line)
    return summarize(0.0, timings)  # any differing index or flag raised above


def hold_roi_align(calls, flush):
    """Kernel within one bf16 ulp of plain on each call, and within 1e-5 in
    float32 on the same maps with edge boxes in front; timed with its bound.
    Returns the error and the summed times and bounds."""
    err, timings = 0.0, []
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons in full float32
    torch.backends.cudnn.allow_tf32 = False
    for args, _ in calls:
        features, boxes, pool, image_shape = args[:4]
        features = [f.detach() for f in features]  # the training step's maps require grad
        scale = max(float(f.abs().max()) for f in features)
        # bf16, the path's dtype, on the path's boxes
        got = roi_kernel.roi_align(features, boxes, pool, image_shape)
        want = roi_kernel.roi_align_plain(features, boxes, pool, image_shape)
        torch.cuda.synchronize()
        e16 = float((got.float() - want.float()).abs().max())
        if not e16 <= 2.0**-8 * scale:
            raise AssertionError(f"ROIAlign bf16 error {e16} > 2^-8 * {scale} (pool {pool})")
        # f32 on the same maps, with zero-area and edge boxes in front
        f32 = [f.float().contiguous() for f in features]
        eboxes = edge_boxes(boxes)
        got32 = roi_kernel.roi_align(f32, eboxes, pool, image_shape)
        want32 = roi_kernel.roi_align_plain(f32, eboxes, pool, image_shape)
        torch.cuda.synchronize()
        e32 = float((got32 - want32).abs().max())
        if not e32 <= 1e-5 * scale:
            raise AssertionError(f"ROIAlign f32 error {e32} > 1e-5 * {scale} (pool {pool})")
        if got32[:, 1:3].abs().max() != 0:
            raise AssertionError("zero-area ROIs did not pool zeros")
        k = kernel_ms(lambda: roi_kernel.roi_align(features, boxes, pool, image_shape), 20, flush)
        p = kernel_ms(lambda: roi_kernel.roi_align_plain(features, boxes, pool, image_shape), 5, flush)
        bt, ot = roi_bound(features, boxes, pool)
        timings.append((k, p, bt, ot))
        err = max(err, e16)
        width = roi_kernel.vector_width(features, got)
        log(f"  {pool}x{pool}: boxes {tuple(boxes.shape)} maps {[tuple(f.shape) for f in features]} "
            f"{features[0].dtype}, {width} channels a thread: max err bf16 {e16:.3g}, f32 {e32:.3g} "
            f"(max|f| {scale:.3g}); kernel {k:.4f} ms, plain {p:.3f} ms, bound {max(bt, ot) * 1e3:.3f} us")
    return summarize(err, timings)


def hold_roi_scalar_width(device):
    """The forward kernel's scalar width against the plain version: C = 36 in
    bf16 (72-byte pixels) and float32 maps that start 4 bytes past a 16-byte
    boundary."""
    rs = np.random.RandomState(SEED + 8)
    boxes = torch.from_numpy(roi_like_boxes(rs, 600).reshape(2, 300, 4)).to(device)
    maps = [rs.normal(size=(2, 512 // s, 512 // s, 36)).astype(np.float32) for s in (4, 8, 16, 32)]
    bf16 = [torch.from_numpy(f).to(device, torch.bfloat16) for f in maps]
    unaligned = []
    for f in maps:
        buf = torch.empty(f.size + 1, device=device)
        unaligned.append(buf[1:].view(f.shape).copy_(torch.from_numpy(f)))
    for name, feats, tol in (("C 36 bf16", bf16, 2.0**-8), ("C 36 f32 off by 4 bytes", unaligned, 1e-5)):
        for pool in (7, 14):
            got = roi_kernel.roi_align(feats, boxes, pool, (512, 512))
            want = roi_kernel.roi_align_plain(feats, boxes, pool, (512, 512))
            torch.cuda.synchronize()
            width = roi_kernel.vector_width(feats, got)
            scale = max(float(f.abs().max()) for f in feats)
            e = float((got.float() - want.float()).abs().max())
            if width != 1 or not e <= tol * scale:
                raise AssertionError(f"ROIAlign scalar width ({name}, {pool}x{pool}): width {width}, error {e}")
            log(f"  scalar width, {name}, {pool}x{pool} over {tuple(boxes.shape)}: max err {e:.3g}")


def check_results(results, images, cfg):
    for img, r in zip(images, results):
        n = len(r["class_ids"])
        if n < 1:
            raise AssertionError("a served image got no detection")
        if r["masks"].shape != img.shape[:2] + (n,) or r["masks"].dtype != bool:
            raise AssertionError(f"mask shape {r['masks'].shape} for image {img.shape}")
        if not (np.all(np.isfinite(r["scores"])) and np.all((r["scores"] >= 0) & (r["scores"] <= 1))):
            raise AssertionError("scores outside [0, 1]")
        if not np.all((r["class_ids"] >= 1) & (r["class_ids"] < cfg.num_classes)):
            raise AssertionError("class id outside [1, num_classes)")
        rois = r["rois"]
        if np.any(rois[:, :2] < 0) or np.any(rois[:, 2] > img.shape[0]) or np.any(rois[:, 3] > img.shape[1]):
            raise AssertionError("box outside the image")


def tiny_config() -> MaskRCNNConfig:
    return MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(8, 16, 32, 64, 128),
                          backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64,
                          mask_conv_channels=64, pre_nms_limit=256, post_nms_rois_inference=64,
                          num_classes=3, compute_dtype="float32", detection_min_confidence=0.0)


def tiny_cross_check(device):
    """A small float32 model with the same seeded weights on the card and on
    the CPU: the RPN scores agree, and so do the valid proposal counts."""
    cfg = tiny_config()
    rs = np.random.RandomState(SEED + 2)
    img = torch.from_numpy(np.stack([smooth_image(rs, 128, 128) for _ in range(2)]))
    meta = torch.zeros((2, cfg.meta_size))
    meta[:, 7:11] = torch.tensor([0.0, 0.0, 128.0, 128.0])
    outs = []
    for dev in (device, torch.device("cpu")):
        m = lecun_init_(MaskRCNN(cfg, device=dev), torch.Generator().manual_seed(SEED))
        outs.append({k: v.cpu() for k, v in m(img.to(dev), meta.to(dev)).items()})
    gpu, cpu = outs
    rel = float((gpu["rpn_probs"] - cpu["rpn_probs"]).abs().max())
    if not rel <= 1e-4:
        raise AssertionError(f"tiny model: RPN scores differ by {rel} between card and CPU")
    counts = (gpu["rpn_rois_valid"].sum(1).tolist(), cpu["rpn_rois_valid"].sum(1).tolist())
    if counts[0] != counts[1] or not torch.isfinite(gpu["mrcnn_masks"]).all():
        raise AssertionError(f"tiny model: valid proposals {counts[0]} on the card, {counts[1]} on the CPU")
    log(f"== tiny float32 model, card vs CPU: RPN scores within {rel:.3g}, valid proposals {counts[0]}")


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def flagship_train_config() -> MaskRCNNConfig:
    """The flagship at the JAX package's training defaults: train_bn and
    train_bn_backbone, 56x56 mini masks, 2000 proposals, 200 ROIs per image
    at ratio 0.33, the slim mask head, adamax 1e-3, weight decay 2e-4, the
    loss guard."""
    return MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone="resnet50",
                          compute_dtype="bfloat16", batch_size=2)


@contextlib.contextmanager
def recorded_wrappers(calls):
    """The training path's kernel wrappers, each appending ``(args, kwargs)``
    to ``calls[key]`` before it launches its kernel as usual."""

    def recorder(fn, key):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)

        return wrapped

    with mock.patch.object(nms_op, "greedy_nms", recorder(nms_kernel.greedy_nms, "nms")), \
            mock.patch.object(roi_op, "roi_align", recorder(roi_kernel.roi_align, "roi_align")), \
            mock.patch.object(roi_op, "roi_align_backward",
                              recorder(roi_kernel.roi_align_backward, "roi_align_backward")):
        yield


def check_step_calls(calls):
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"nms": 1, "roi_align": 2, "roi_align_backward": 2}:
        raise RuntimeError(f"a training step called the wrappers {counts} times; expected 1, 2, 2")


def capture_train(device, steps_before=0):
    """The flagship's training state from the seed, after ``steps_before``
    training steps, and one more step through the real path, recording the
    inputs of each kernel wrapper: one NMS call, two ROIAlign forwards, two
    backwards. Returns ``(state, step, batch, gen, calls)``."""
    tcfg = flagship_train_config()
    gen = torch.Generator().manual_seed(SEED)
    state = create_train_state(tcfg, gen, device=device)
    step = make_train_step(tcfg)
    batch = synthetic_batch(tcfg, 2, SEED + 6, device)
    for _ in range(steps_before):
        state, _ = step(state, batch, rng=gen)
    calls = {"nms": [], "roi_align": [], "roi_align_backward": []}
    cotangents = []
    autograd_backward = roi_op.PyramidRoIAlign.backward

    def backward(ctx, dout):
        cotangents.append(f"{tuple(dout.shape)} strides {dout.stride()} contiguous {dout.is_contiguous()}")
        return autograd_backward(ctx, dout)

    with recorded_wrappers(calls), mock.patch.object(roi_op.PyramidRoIAlign, "backward", staticmethod(backward)):
        state, _ = step(state, batch, rng=gen)
    torch.cuda.synchronize()
    log("  cotangents as autograd hands them to PyramidRoIAlign.backward: " + "; ".join(cotangents))
    check_step_calls(calls)
    return state, step, batch, gen, calls


def bwd_bound(dout, boxes, level_hw):
    """Bytes: the cotangent and the boxes read once, the gradient maps written
    once in the cotangent's dtype. Operations: 4 multiplies and 4 adds per
    cotangent element."""
    item = dout.element_size()
    b, c = dout.shape[0], dout.shape[-1]
    nbytes = dout.numel() * item + boxes.numel() * 4 + sum(b * h * w * c for h, w in level_hw) * item
    return nbytes / HBM_BYTES_PER_S * 1e3, dout.numel() * 8 / F32_FLOPS * 1e3


def hold_backward_case(name, dout, boxes, level_hw, image_shape):
    """Kernel against plain: one bf16 ulp of max|plain| in bf16, 1e-5 * max|plain|
    in float32. Two launches give the same bits. The kernel's maps come from
    ``torch.empty`` over memory just filled with NaNs, and are exactly zero
    wherever no ROI reaches: where the plain backward of a cotangent of ones
    (bilinear weights are >= 0) is zero. (A reached pixel's plain sum, in
    ``index_add_``'s order, can cancel to an exact zero that the kernel's
    order of summation does not reproduce.)"""
    want = roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape)
    reached = roi_kernel.roi_align_backward_plain(torch.ones_like(dout, dtype=torch.float32), boxes, level_hw,
                                                  image_shape)
    poison = torch.full((sum(w.numel() for w in want),), float("nan"), dtype=dout.dtype, device=dout.device)
    del poison  # the allocator hands this block to the next torch.empty of its size
    got = roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    again = roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    torch.cuda.synchronize()
    scale = max(float(w.float().abs().max()) for w in want)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    tol = 1e-5 * scale if dout.dtype == torch.float32 else 2.0**-8 * scale
    if not err <= tol:
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}) error {err} > {tol}")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}): two launches differ")
    if not all(bool((g[r == 0] == 0).all()) for g, r in zip(got, reached)):
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}): a pixel no ROI reaches is not zero")
    return err, scale


def backward_work(boxes, level_hw, p, image_shape):
    """What the owner-computes kernel finds on these boxes: the ROIs each of
    its tiles keeps (level and footprint filter) and the corner terms each
    pixel sums, as distributions."""
    th, tw = roi_kernel.BACKWARD_TILE
    idx, _, valid = roi_kernel._geometry(level_hw, boxes.cpu(), p, image_shape, 244.0)
    b = idx.shape[0]
    total = sum(h * w for h, w in level_hw)
    terms = torch.bincount((idx + torch.arange(b)[:, None, None, None, None] * total)[valid].reshape(-1),
                           minlength=b * total).float()
    offsets = np.cumsum([0] + [h * w for h, w in level_hw])
    tiles = [torch.zeros((b, -(-h // th), -(-w // tw))) for h, w in level_hw]
    first, last = idx[:, :, 0, 0, 0], idx[:, :, -1, -1, 3]  # corner 00 of the first sample, 11 of the last
    for img, roi in valid.nonzero().tolist():
        level = int(np.searchsorted(offsets, int(first[img, roi]), side="right")) - 1
        w = level_hw[level][1]
        lo, hi = int(first[img, roi]) - offsets[level], int(last[img, roi]) - offsets[level]
        tiles[level][img, lo // w // th : hi // w // th + 1, lo % w // tw : hi % w // tw + 1] += 1
    per_tile = torch.cat([t.reshape(-1) for t in tiles])

    def dist(v):
        q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99])).tolist()
        return (f"mean {float(v.mean()):.2f}, median {q[0]:.0f}, 90th {q[1]:.0f}, 99th {q[2]:.0f}, "
                f"max {float(v.max()):.0f}, zero {float((v == 0).float().mean()):.3f}")

    by_level = ", ".join(f"{float(t.mean()):.2f}/{float(t.max()):.0f}" for t in tiles)
    return (f"ROIs per {th}x{tw} tile ({len(per_tile)} tiles): {dist(per_tile)}; mean/max by level {by_level}; "
            f"corner terms per pixel: {dist(terms)}")


def backward_shape_cases(device):
    """(name, dout, boxes): boxes aimed at the kernel's tiles on the flagship's
    512x512 pyramid (samples straddling tile borders in both axes; 512x12-pixel
    boxes, the finest level, 128 pixels one way) at C = 256, and ROI-like boxes
    at C = 36, the scalar width in bf16; both dtypes each."""
    rs = np.random.RandomState(SEED + 9)
    lo, hi = 2.5 / 127, 9.5 / 127  # pixels 2.5 .. 9.5 of the 128x128 map
    aimed = np.array([[lo, lo, hi, hi], [lo, 0.0, hi, 6.0 / 127], [0.0, 0.5, 1.0, 0.5 + 12 / 512],
                      [0.25, 0.0, 0.25 + 12 / 512, 1.0]], np.float32)
    boxes = np.stack([np.concatenate([aimed, roi_like_boxes(rs, 60)]) for _ in range(2)])
    cases = []
    for name, bx, p, c in (("tile-straddling and elongated boxes", boxes, 14, 256),
                           ("C 36, 7x7", roi_like_boxes(rs, 600).reshape(2, 300, 4), 7, 36),
                           ("C 36, 14x14", roi_like_boxes(rs, 600).reshape(2, 300, 4), 14, 36)):
        dout = torch.from_numpy(rs.normal(size=bx.shape[:2] + (p, p, c)).astype(np.float32)).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((name, dout.to(dtype), torch.from_numpy(bx).to(device)))
    return cases


def hold_roi_backward(calls, flush, shape_cases=True):
    """The backward kernel against plain on each call (timed, with its
    bound), and with ``shape_cases`` on boxes aimed at its tiles and on a
    pyramid past the TPU's VMEM limit; the error and summed times."""
    log("== holds: pyramid ROIAlign backward kernel (csrc/roi_align.cu) vs roi_align_backward_plain")
    err, timings = 0.0, []
    for args, _ in calls:
        dout, boxes, level_hw, image_shape = args[:4]
        p = dout.shape[2]
        e16, scale = hold_backward_case(f"{p}x{p}", dout, boxes, level_hw, image_shape)
        # float32, with zero-area, full-image, edge and sliver boxes in front
        eboxes = edge_boxes(boxes)
        d32 = dout.float().contiguous()
        e32, _ = hold_backward_case(f"{p}x{p} edge boxes", d32, eboxes, level_hw, image_shape)
        empty = torch.zeros_like(d32)
        empty[:, 1:3] = d32[:, 1:3]  # the zero-height and the all-zero box
        if any(float(g.abs().max()) != 0 for g in roi_kernel.roi_align_backward(empty, eboxes, level_hw, image_shape)):
            raise AssertionError("zero-area ROIs changed the gradient maps")
        k = kernel_ms(lambda: roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape), 20, flush)
        pl = kernel_ms(lambda: roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape), 3, flush)
        bt, ot = bwd_bound(dout, boxes, level_hw)
        timings.append((k, pl, bt, ot))
        err = max(err, e16)
        log(f"  {p}x{p}: dout {tuple(dout.shape)} {dout.dtype} maps {list(level_hw)}: max err bf16 {e16:.3g} "
            f"(max|grad| {scale:.3g}), f32 {e32:.3g}; kernel {k:.4f} ms, plain {pl:.3f} ms, "
            f"bound {max(bt, ot) * 1e3:.3f} us")
        if shape_cases:
            log(f"  {p}x{p}: {backward_work(boxes, level_hw, p, image_shape)}")
    if not shape_cases:
        return summarize(err, timings)
    level_hw = [(512 // s, 512 // s) for s in (4, 8, 16, 32)]
    for name, dout, boxes in backward_shape_cases(dout.device):
        e, scale = hold_backward_case(name, dout, boxes, level_hw, (512, 512))
        log(f"  {name}: dout {tuple(dout.shape)} {dout.dtype}: max err {e:.3g} (max|grad| {scale:.3g})")
    # the TPU falls back to its read-modify-write kernel above 88 MiB of float32
    # pyramid per image; 1024x1024 is 85 MiB, so 1152x1152 (108 MiB)
    rs = np.random.RandomState(SEED + 3)
    level_hw = [(1152 // s, 1152 // s) for s in (4, 8, 16, 32)]
    mib = sum(h * w for h, w in level_hw) * 256 * 4 / 2**20
    boxes = torch.from_numpy(roi_like_boxes(rs, 200)[None]).to(dout.device)
    big = torch.from_numpy(rs.normal(size=(1, 200, 14, 14, 256)).astype(np.float32)).to(dout.device)
    e_big, _ = hold_backward_case("1152x1152", big, boxes, level_hw, (1152, 1152))
    e_big16, _ = hold_backward_case("1152x1152", big.to(torch.bfloat16), boxes, level_hw, (1152, 1152))
    k = kernel_ms(lambda: roi_kernel.roi_align_backward(big, boxes, level_hw, (1152, 1152)), 10, flush)
    pl = kernel_ms(lambda: roi_kernel.roi_align_backward_plain(big, boxes, level_hw, (1152, 1152)), 3, flush)
    bound = max(bwd_bound(big, boxes, level_hw))
    log(f"  pyramid of {mib:.1f} MiB f32 per image (1152x1152, batch 1, 14x14 over 200 ROIs): "
        f"max err f32 {e_big:.3g}, bf16 {e_big16:.3g}; f32 kernel {k:.4f} ms, plain {pl:.3f} ms, "
        f"bound {bound * 1e3:.3f} us")
    log("  library: no single PyTorch call computes the ROIAlign backward (torchvision is absent)")
    return summarize(err, timings)


def _tiny_train_losses_and_grads(cfg, batch, draws, dev):
    model = lecun_init_(MaskRCNN(cfg, device=dev), torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # spread the RPN scores: saturated scores tie in the top-k
        model.rpn.rpn_class_raw.weight.mul_(0.1)
    total, losses = _loss(model, {k: v.to(dev) for k, v in batch.items()},
                          {k: v.to(dev) for k, v in draws.items()}, cfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: g.cpu() for n, g in zip(names, grads) if g is not None})


def tiny_train_cross_check(device):
    """One training step of a small float32 model on the card and on the CPU,
    same weights, batch and draws: every loss within 1e-4 relative, with the
    batch norms on batch statistics (the default) and on their running
    averages; in the latter, every gradient leaf within 1e-4 * (its max + the
    step's largest gradient), the tolerance of the CPU parity test against
    the JAX package. At random weights the gradients are not smooth in the
    inputs (ReLU and max-pool switches, nearly constant channels under batch
    statistics: tests/torch_port_conditioning.py), so card and CPU, which sum
    in other orders, may differ by percents on a few leaves; with batch
    statistics only the losses are held, and the leaf check runs on the
    running averages, where this scene agrees closely."""
    base = MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(32, 48, 64, 96, 128),
                          backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64,
                          mask_conv_channels=64, pre_nms_limit=256, post_nms_rois_training=64,
                          train_rois_per_image=32, max_gt_instances=8, num_classes=3, compute_dtype="float32")
    batch = synthetic_batch(base, 2, SEED + 4, "cpu")
    draws = draw_uniforms(base, 2, torch.Generator().manual_seed(SEED + 5), "cpu")
    for cfg in (base, base.replace(train_bn=False, train_bn_backbone=False)):
        (l_gpu, g_gpu), (l_cpu, g_cpu) = (_tiny_train_losses_and_grads(cfg, batch, draws, dev)
                                          for dev in (device, torch.device("cpu")))
        worst_loss = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12) for k, v in l_cpu.items())
        if not worst_loss <= 1e-4:
            raise AssertionError(f"tiny train step: losses differ by {worst_loss} between card and CPU: "
                                 f"{l_gpu} {l_cpu}")
        if set(g_gpu) != set(g_cpu):
            raise AssertionError("tiny train step: different parameters got gradients on the card and the CPU")
        gmax = max(float(g.abs().max()) for g in g_cpu.values())
        err = {n: float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()}
        leaf = {n: err[n] / max(float(g.abs().max()), 1e-30) for n, g in g_cpu.items()}
        step = {n: err[n] / (float(g.abs().max()) + gmax) for n, g in g_cpu.items()}
        worst_leaf, worst_step = max(leaf, key=leaf.get), max(step, key=step.get)
        if not cfg.train_bn and step[worst_step] > 1e-4:
            raise AssertionError(f"tiny train step: gradient of {worst_step} differs by {err[worst_step]} "
                                 f"between card and CPU (leaf max + step max {err[worst_step] / step[worst_step]})")
        log(f"== tiny float32 train step (batch norms on {'batch statistics' if cfg.train_bn else 'running averages'}),"
            f" card vs CPU: losses within {worst_loss:.3g} relative (mask loss {l_cpu['mrcnn_mask_loss']:.4f});"
            f" gradients within {step[worst_step]:.3g} of (leaf max + step max) at worst ({worst_step}),"
            f" {leaf[worst_leaf]:.3g} of the leaf's max ({worst_leaf})")


def run_training(state, step, batch, gen, card):
    log("== train: 5 steps, flagship training config (ResNet-50-FPN, 512, 81 classes, bf16, batch 2)")
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.greedy_nms.launches = 0
    roi_kernel.roi_align.launches = 0
    roi_kernel.roi_align_backward.launches = 0
    times = []
    for i in range(5):
        start = time.perf_counter()
        state, losses = step(state, batch, rng=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        values = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(v) for v in values.values()) or values["grad_finite"] != 1.0:
            raise AssertionError(f"train step {i}: {values}")
        log(f"  step {i}: loss_sum {values['loss_sum']:.4f} "
            + " ".join(f"{k} {v:.4g}" for k, v in values.items() if k.endswith("_loss"))
            + f"; {times[-1]:.1f} ms")
    launches = {"nms": nms_kernel.greedy_nms.launches, "roi_align": roi_kernel.roi_align.launches,
                "roi_align_backward": roi_kernel.roi_align_backward.launches}
    if launches != {"nms": 5, "roi_align": 10, "roi_align_backward": 10}:
        raise AssertionError(f"5 steps launched {launches}; expected 5, 10, 10")
    names = [n for n, _ in state.model.named_parameters()]
    unchanged = [n for n, p, q in zip(names, state.model.parameters(), before)
                 if n.endswith("weight") and torch.equal(p.detach(), q)]
    if unchanged:
        raise AssertionError(f"weights unchanged after 5 steps: {unchanged}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not all(p.dtype == torch.float32 for p in state.model.parameters()):
        raise AssertionError("the master weights are not float32")
    log(f"  median step {float(np.median(times[1:])):.1f} ms over steps 2-5; peak memory {peak:.0f} MiB; "
        f"launches {launches}; float32 master weights ({card})")
    return launches


# ---------------------------------------------------------------------------
# train_model from a dataset
# ---------------------------------------------------------------------------


def launch_counts():
    return (nms_kernel.greedy_nms.launches, roi_kernel.roi_align.launches, roi_kernel.roi_align_backward.launches)


def zero_launch_counts():
    nms_kernel.greedy_nms.launches = 0
    roi_kernel.roi_align.launches = 0
    roi_kernel.roi_align_backward.launches = 0


class Stop(Exception):
    """Ends a run at the first step of its second epoch, as a crash would."""


def shapes_datasets(root):
    """12 training and 4 validation images of 512x512 synthetic shapes,
    through a COCO directory with COCO's 80 categories."""
    sets = shapes_coco_datasets(root, (12, 4), 512, SEED + 10, class_names=COCO_CLASS_NAMES)
    log(f"  dataset: {len(sets[0])} + {len(sets[1])} images of 512x512 shapes written as COCO (JPEG, RLE; the "
        f"shapes are 3 of its 80 categories) under a temporary directory and read back through CocoDataset")
    return sets


def run_train_model(device, card, root):
    """Phase 10 (see the module's docstring), in ``root``. Returns the launch
    counts of the main run, its configuration and the validation set."""
    log("== train_model: ResNet-50-FPN, 512x512, bf16, batch 2, 81 classes from the dataset, device augmentation, "
        "2 epochs of 3 steps with validation")
    train, val = shapes_datasets(os.path.join(root, "coco"))
    cfg = flagship_train_config().replace(
        num_classes=train.num_classes, epochs=2, log_per_steps=1, augment_on_device=True,
        augment_scale_jitter=0.25, augment_photometric=0.2, reduce_lr_patience=1, reduce_lr_factor=0.5,
        sample_cache_dir=os.path.join(root, "cache"), checkpoints_dir=os.path.join(root, "ckpt"))
    steps = 3

    # the loader alone on the host: decoding, resizing, mini masks, collation
    start = time.perf_counter()
    n_images = sum(len(b["images"]) for b in DataLoader(train, cfg.replace(sample_cache_dir=None)).epoch())
    loader_ips = n_images / (time.perf_counter() - start)

    def run(base, **kw):
        state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
        history = []
        state = train_model(cfg, train, val, state=state, checkpoint_base=os.path.join(root, base),
                            steps_per_epoch=steps, rng_seed=SEED, history=history, **kw)
        return state, history

    # (a), (b), (c): the main run
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
    before = [p.detach().clone() for p in state.model.parameters()]
    losses = []
    history = []
    eval_steps = cfg.epochs * sum(1 for _ in DataLoader(val, cfg, shuffle=False).epoch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    start = time.perf_counter()
    state = train_model(cfg, train, val, state=state, checkpoint_base=os.path.join(root, "main"),
                        steps_per_epoch=steps, rng_seed=SEED, history=history,
                        metric_writer=lambda step, values: losses.append(values))
    wall = time.perf_counter() - start
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    n_steps = sum(h["steps"] for h in history)
    want = (n_steps + eval_steps, 2 * n_steps + 2 * eval_steps, 2 * n_steps)
    if n_steps != cfg.epochs * steps or launches != want:
        raise AssertionError(f"train_model: {n_steps} steps, {eval_steps} eval steps launched (NMS, ROIAlign, "
                             f"backward) = {launches}; expected {want}")
    if not all(np.isfinite(v) for values in losses for v in values.values()) or \
            not all(np.isfinite(v) for h in history for k, v in h.items() if "loss" in k):
        raise AssertionError(f"train_model: a loss is not finite: {losses} {history}")
    names = [n for n, _ in state.model.named_parameters()]
    unchanged = [n for n, p, q in zip(names, state.model.parameters(), before)
                 if n.endswith("weight") and torch.equal(p.detach(), q)]
    if unchanged:
        raise AssertionError(f"train_model: weights unchanged: {unchanged}")
    manager = ckpt_lib.make_manager(cfg, os.path.join(root, "main"))
    files = sorted(f for f in os.listdir(manager.directory) if f.endswith(".pt"))
    if manager.all_steps() != [0, 1] or len(files) != 2 or cfg.save_best_only is not True:
        raise AssertionError(f"train_model: best-only checkpoints {manager.all_steps()}, files {files}")
    log(f"  (a) {n_steps} steps and {eval_steps} eval steps launched NMS, ROIAlign forward, backward "
        f"{launches} times, as expected; (b) finite losses (val_loss_sum by epoch "
        f"{[round(h['val_loss_sum'], 4) for h in history]}), every weight moved; (c) best-only checkpoints "
        f"of epochs {manager.all_steps()} on disk, ranked by val_loss_sum "
        f"{[round(manager.metrics(e)['val_loss_sum'], 4) for e in manager.all_steps()]}")
    final = {"step": state.step, "lr": state.opt_state.hyperparams["learning_rate"],
             "weights": [p.detach().clone() for p in state.model.parameters()]}
    del state, before

    # (d) the SIGTERM drill
    def send_sigterm(step, values):
        if step == 2:  # the second step of epoch 1
            os.kill(os.getpid(), signal.SIGTERM)

    state, _ = run("drill", metric_writer=send_sigterm)
    pre = ckpt_lib.make_preempt_manager(cfg, os.path.join(root, "drill"))
    if state.step != 2 or pre.all_steps() != [0] or ckpt_lib.make_manager(cfg, os.path.join(root, "drill")).all_steps():
        raise AssertionError(f"SIGTERM drill: stopped at step {state.step}, preemption checkpoints {pre.all_steps()}")
    state, _ = run("drill")
    if state.step != 2 + steps:
        raise AssertionError(f"SIGTERM drill: resumed to step {state.step}, expected {2 + steps}")
    log(f"  (d) SIGTERM at step 2 left a preemption checkpoint of epoch 0 (step 2); resume ran epoch 2 to "
        f"step {state.step}")
    del state

    # (e) a run stopped at the epoch boundary, then resumed
    def crash(step, values):
        if step == steps + 1:
            raise Stop

    try:
        run("boundary", metric_writer=crash)
        raise AssertionError("the boundary run did not stop")
    except Stop:
        pass
    saved = ckpt_lib.make_manager(cfg, os.path.join(root, "boundary"))
    extra = saved.restore(0, "cpu")["extra"]
    state, resumed = run("boundary")
    lr = state.opt_state.hyperparams["learning_rate"]
    unbroken_extra = manager.restore(1, "cpu")["extra"]
    resumed_extra = saved.restore(1, "cpu")["extra"]
    if (state.step, lr) != (final["step"], final["lr"]) or resumed_extra["bad_epochs"] != unbroken_extra["bad_epochs"] \
            or resumed_extra["lr"] != unbroken_extra["lr"] or len(resumed) != 1:
        raise AssertionError(f"epoch-boundary resume: step {state.step}, lr {lr}, plateau {resumed_extra}; the "
                             f"unbroken run: step {final['step']}, lr {final['lr']}, plateau {unbroken_extra}")
    diff = max(float((p.detach() - q).abs().max()) for p, q in zip(state.model.parameters(), final["weights"]))
    log(f"  (e) stopped at step {steps + 1}, resumed from epoch 0's checkpoint (step {steps}, plateau {extra}): "
        f"step {state.step}, lr {lr:g}, plateau {resumed_extra}, as the unbroken run's (plateau "
        f"{unbroken_extra}); weights within {diff:.3g} of the unbroken run's")
    del state, final

    step_ips = [h["steps"] * cfg.batch_size / h["train_seconds"] for h in history]
    wait = [h["loader_wait_s"] / h["train_seconds"] for h in history]
    log(f"  loader alone on the host (JPEG decode, resize, mini masks, batches of 2, no cache): "
        f"{loader_ips:.2f} images/s ({card})")
    log(f"  train_model: {step_ips[-1]:.2f} images/s over epoch 2's training steps ({step_ips[0]:.2f} in epoch "
        f"1, its first step included); with validation and checkpoint {history[-1]['images_per_s']:.2f} and "
        f"{history[0]['images_per_s']:.2f} images/s; {wall:.1f} s for the run ({card})")
    log(f"  loader wait: {wait[-1]:.4f} of epoch 2's training time, {wait[0]:.4f} of epoch 1's ({card})")
    log(f"  peak memory {peak:.0f} MiB in train_model ({card})")
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches)), cfg, val, step_ips[-1]


# ---------------------------------------------------------------------------
# pretrained weights, evaluation and the CLIs
# ---------------------------------------------------------------------------


def run_pretrained(device, card, root):
    """Phase 11: fine-tune from a torchvision-keyed ResNet-50 file. Returns the
    launch counts of its 2 steps."""
    log("== pretrained: a seeded torchvision-keyed ResNet-50 state_dict into the flagship's training state")
    path = os.path.join(root, "resnet50.pth")
    sd = resnet_state_dict("resnet50", SEED + 12)
    torch.save(sd, path)
    mib = os.path.getsize(path) / 2**20
    tcfg = flagship_train_config().replace(backbone_init_weights=path)
    printed = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = create_train_state(tcfg, torch.Generator().manual_seed(SEED), device=device)
    load_s = time.perf_counter() - start
    coverage = printed.getvalue().strip()
    if "265/265 leaves" not in coverage:
        raise AssertionError(f"pretrained coverage: {coverage!r}; expected 265/265")
    got = state.model.state_dict()
    differ = [k for k, v in convert_torch_backbone(sd).items() if not torch.equal(got["backbone." + k].cpu(), v)]
    if differ or len(convert_torch_backbone(sd)) != 265:
        raise AssertionError(f"pretrained: backbone entries differ from the file's: {differ[:5]}")
    step = make_train_step(tcfg)
    batch = synthetic_batch(tcfg, 2, SEED + 6, device)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    zero_launch_counts()
    losses = []
    for i in range(2):
        state, values = step(state, batch, rng=gen)
        losses.append({k: float(v) for k, v in values.items()})
        if not all(np.isfinite(v) for v in losses[-1].values()) or losses[-1]["grad_finite"] != 1.0:
            raise AssertionError(f"pretrained step {i}: {losses[-1]}")
    launches = launch_counts()
    if launches != (2, 4, 4):
        raise AssertionError(f"2 fine-tune steps launched (NMS, ROIAlign, backward) = {launches}; expected (2, 4, 4)")
    log(f"  {coverage} ({mib:.1f} MiB file, create_train_state {load_s:.2f} s); every backbone entry equals the "
        f"file's bit for bit; 2 steps: loss_sum {[round(v['loss_sum'], 4) for v in losses]}, grad_finite 1, "
        f"launches {launches} ({card})")
    del state, step, batch
    torch.cuda.empty_cache()
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches))


def rehome_checkpoint(src_cfg, src_base, dst_cfg):
    """Save the best of ``src_cfg``'s checkpoints where ``dst_cfg``'s manager
    (a CLI's) looks for it; returns the model's state_dict."""
    src = ckpt_lib.make_manager(src_cfg, src_base)
    best = min(src.all_steps(), key=lambda e: src.metrics(e)["val_loss_sum"])
    payload = src.restore(best, "cpu")
    ckpt_lib.make_manager(dst_cfg).save(best, payload, src.metrics(best))
    return payload["model"]


def images_per_s(fn, images):
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn(images)
    return len(images) / (time.perf_counter() - start)


def run_evaluate(device, card, root, train_cfg, val):
    """Phase 12. Returns the launch counts of the ``detect`` and the
    ``detect_stream`` routes and the CLI configuration's state_dict."""
    log("== evaluate: phase 10's best checkpoint through cli.evaluate, evaluate_dataset over detect and over "
        "detect_stream (batch 2, depth 2)")
    size = train_cfg.image_shape[0]
    cfg = cli_evaluate.coco_config(backbone=train_cfg.backbone, num_classes=81, image_shape=(size, size, 3),
                                   image_min_dim=size, image_max_dim=size, batch_size=2,
                                   checkpoints_dir=os.path.join(root, "cli"))
    state_dict = rehome_checkpoint(train_cfg, os.path.join(root, "main"), cfg)
    out = os.path.join(root, "ap.json")
    batches = -(-len(val) // cfg.batch_size)
    routes = {}
    for name, run in (
        ("cli", lambda: cli_evaluate.main(["--dataset_path", os.path.join(root, "coco"), "--backbone", cfg.backbone,
                                           "--img_size", str(size), "--batch_size", "2", "--checkpoints_dir",
                                           cfg.checkpoints_dir, "--out", out, "--device", device.type])),
        ("detect", lambda: evaluate_dataset(predictor, val, cfg, verbose=False)),
        ("stream", lambda: evaluate_dataset(predictor, val, cfg, verbose=False, stream_depth=2)),
    ):
        printed = io.StringIO()
        torch.cuda.synchronize()
        zero_launch_counts()
        k8.paste_masks.launches = 0
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            stats = run()
        seconds = time.perf_counter() - start
        launches = launch_counts()
        if launches != (2 * batches, 2 * batches, 0) or k8.paste_masks.launches != batches:
            raise AssertionError(f"evaluate ({name}): {batches} batches launched (NMS, ROIAlign, backward) = "
                                 f"{launches} and K8 {k8.paste_masks.launches} times; expected 2, 2, 0 and 1 a batch")
        if name == "cli":
            if "WARNING" in printed.getvalue():
                raise AssertionError("cli.evaluate found no checkpoint")
            predictor = Predictor(cfg, state_dict, device=device)
        routes[name] = (stats, seconds, launches)
    dicts = {name: json.dumps(r[0], sort_keys=True) for name, r in routes.items()}
    with open(out) as f:
        written = json.dumps(json.load(f), sort_keys=True)
    if len(set(dicts.values())) != 1 or written != dicts["cli"]:
        raise AssertionError(f"evaluate: the AP dicts differ: {dicts}, written {written}")
    for kind, stats in routes["cli"][0].items():
        if not all(0.0 <= v <= 1.0 for k, v in stats.items() if not (k.startswith("AP_") and np.isnan(v))):
            raise AssertionError(f"evaluate: {kind} stats outside [0, 1]: {stats}")
    ap = {k: {m: round(v, 4) for m, v in d.items()} for k, d in routes["cli"][0].items()}
    log(f"  {len(val)} images, {batches} batches of 2: the CLI's, detect's and detect_stream's AP dicts equal: {ap}")
    log(f"  launches (NMS, ROIAlign forward, backward) per route: {routes['detect'][2]}; seconds per image: CLI "
        f"{routes['cli'][1] / len(val):.3f} (restore and model build included), evaluate_dataset over detect "
        f"{routes['detect'][1] / len(val):.3f}, over detect_stream {routes['stream'][1] / len(val):.3f} ({card})")

    # detect_stream against detect over the same chunks, image for image, and
    # their rates in turns (detect, stream, stream, detect)
    images = [val.load_image(i % len(val)) for i in range(8)]
    want = [r for k in range(0, len(images), 2) for r in predictor.detect(images[k:k + 2])]
    got = list(predictor.detect_stream(images, batch_size=2, depth=2))
    for g, w in zip(got, want):
        if g.keys() != w.keys() or not all(np.array_equal(g[k], w[k]) for k in w):
            raise AssertionError("detect_stream differs from detect over the same chunks")
    rates = {"detect": [], "stream": []}
    for name in ("detect", "stream", "stream", "detect"):
        if name == "detect":
            rates[name].append(images_per_s(lambda ims: [predictor.detect(ims[k:k + 2]) for k in range(0, 8, 2)],
                                            images))
        else:
            rates[name].append(images_per_s(lambda ims: list(predictor.detect_stream(ims, 2, 2)), images))
    log(f"  detect_stream equals detect over the same chunks on {len(images)} images "
        f"({sum(len(r['class_ids']) for r in got)} detections at detection_min_confidence "
        f"{cfg.detection_min_confidence}); images/s at batch 2: detect {rates['detect']}, detect_stream (depth 2) "
        f"{rates['stream']} ({card})")
    return routes["detect"][2], routes["stream"][2], cfg, state_dict


def run_detect_cli(device, card, root, eval_cfg, state_dict):
    """Phase 13: ``cli.detect.main`` on 2 JPEGs, against ``Predictor.detect``."""
    log("== detect CLI: 2 JPEGs, --out")
    size = eval_cfg.image_shape[0]
    cfg = cli_detect.MaskRCNNConfig(backbone=eval_cfg.backbone, num_classes=81, image_shape=(size, size, 3),
                                    image_min_dim=size, image_max_dim=size,
                                    checkpoints_dir=os.path.join(root, "cli_detect"))
    ckpt_lib.make_manager(cfg).save(0, {"step": 0, "model": state_dict, "opt_state": {
        "count": 0, "hyperparams": {}, "slots": {}}}, {"val_loss_sum": 0.0})
    rs = np.random.RandomState(SEED + 13)
    paths = []
    for i, hw in enumerate(((480, 640), (375, 500))):
        paths.append(os.path.join(root, f"request_{i}.jpg"))
        image_io.imwrite(paths[-1], smooth_image(rs, *hw))
    out = os.path.join(root, "detect_out")
    printed = io.StringIO()
    torch.cuda.synchronize()
    zero_launch_counts()
    with contextlib.redirect_stdout(printed):
        cli_detect.main(["--backbone", cfg.backbone, "--num_classes", "81", "--img_size", str(size),
                         "--checkpoints_dir", cfg.checkpoints_dir, "--images", *paths, "--out", out,
                         "--device", device.type])
    launches = launch_counts()
    if "WARNING" in printed.getvalue() or launches != (4, 4, 0):
        raise AssertionError(f"cli.detect: {printed.getvalue()!r}, launches {launches}; expected (4, 4, 0)")
    predictor = Predictor(cfg, state_dict, device=device)
    counts = []
    for i, path in enumerate(paths):
        r = predictor.detect([image_io.imread(path)])[0]
        base = os.path.join(out, f"request_{i}")
        with open(base + ".json") as f:
            written = json.load(f)
        want = {"rois": r["rois"].tolist(), "class_ids": r["class_ids"].tolist(), "scores": r["scores"].tolist()}
        if written != want or not os.path.getsize(base + "_det.png"):
            raise AssertionError(f"cli.detect {path}: JSON {written} against Predictor.detect {want}")
        counts.append(len(r["class_ids"]))
    log(f"  JSON equal to Predictor.detect's results ({counts} detections), overlays written; launches "
        f"{launches} ({card})")


# ---------------------------------------------------------------------------
# the backbone zoo
# ---------------------------------------------------------------------------

ZOO_FULL_WIDTH = ("seresnet34", "seresnext50", "senet154", "mobilenet", "mobilenetv2", "efficientnetb0")


def seeded_predictor(cfg, device):
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED))
    params = count_params(model)
    return Predictor(cfg, model.state_dict(), device=device), params


def serve_counted(predictor, images, cfg):
    """One request through ``Predictor.detect``; it must launch NMS and the
    ROIAlign forward twice each. Returns its latency in ms."""
    before = launch_counts()
    start = time.perf_counter()
    results = predictor.detect(images)  # returns host arrays: synchronized
    ms = (time.perf_counter() - start) * 1e3
    rose = tuple(a - b for a, b in zip(launch_counts(), before))
    if rose != (2, 2, 0):
        raise AssertionError(f"{cfg.backbone}: a request launched (NMS, ROIAlign, backward) = {rose}; expected (2, 2, 0)")
    check_results(results, images, cfg)
    return ms


def train_counted(state, step, batch, gen, steps):
    """``steps`` training steps; each must launch (NMS, ROIAlign forward,
    backward) = (1, 2, 2), give finite losses and ``grad_finite`` 1. Returns
    the step times in ms and the last losses."""
    times = []
    for i in range(steps):
        before = launch_counts()
        start = time.perf_counter()
        state, losses = step(state, batch, rng=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        values = {k: float(v) for k, v in losses.items()}
        rose = tuple(a - b for a, b in zip(launch_counts(), before))
        name = state.model.config.backbone
        if rose != (1, 2, 2):
            raise AssertionError(f"{name} step {i}: launched (NMS, ROIAlign, backward) = {rose}; expected (1, 2, 2)")
        if not all(np.isfinite(v) for v in values.values()) or values["grad_finite"] != 1.0:
            raise AssertionError(f"{name} step {i}: {values}")
    return times, values


def zoo_full_width(device, card, requests):
    """Phase 14a: each of ``ZOO_FULL_WIDTH`` at the flagship's serving and
    training configurations: 2 requests and 2 training steps."""
    log("== zoo, full width: 512x512, 81 classes, bf16, 256-wide FPN and heads; 2 requests of 2 images and 2 "
        "training steps of batch 2 each, seeded random weights")
    for name in ZOO_FULL_WIDTH:
        cfg = flagship_config().replace(backbone=name)
        predictor, params = seeded_predictor(cfg, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        latencies = [serve_counted(predictor, images, cfg) for images in requests[:2]]
        serve_peak = torch.cuda.max_memory_allocated() / 2**20
        del predictor
        torch.cuda.empty_cache()

        tcfg = flagship_train_config().replace(backbone=name)
        gen = torch.Generator().manual_seed(SEED)
        state = create_train_state(tcfg, gen, device=device)
        before = [p.detach().clone() for p in state.model.parameters()]
        step, batch = make_train_step(tcfg), synthetic_batch(tcfg, 2, SEED + 6, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, values = train_counted(state, step, batch, gen, 2)
        train_peak = torch.cuda.max_memory_allocated() / 2**20
        unchanged = [n for (n, p), q in zip(state.model.named_parameters(), before)
                     if n.endswith("weight") and torch.equal(p.detach(), q)]
        if unchanged:
            raise AssertionError(f"{name}: weights unchanged after 2 steps: {unchanged[:5]}")
        log(f"  {name}: {params:,d} parameters; requests {latencies[0]:.1f} (the model's first), "
            f"{latencies[1]:.1f} ms, peak {serve_peak:.0f} MiB; training steps {times[0]:.1f} (the first), "
            f"{times[1]:.1f} ms, peak {train_peak:.0f} MiB, loss_sum {values['loss_sum']:.4f}, every weight moved "
            f"({card})")
        del state, step, batch, before
        torch.cuda.empty_cache()


def zoo_sweep(device, card):
    """Phase 14b: every key builds on the card and serves one request of one
    256x256 image."""
    log("== zoo sweep: all 25 keys, one request of 1 image at 256x256 each (bf16, 81 classes; the latency is "
        "the model's first request)")
    rs = np.random.RandomState(SEED + 14)
    image = smooth_image(rs, 256, 256)
    for name in backbone_names():
        cfg = flagship_config().replace(backbone=name, image_shape=(256, 256, 3), image_min_dim=256,
                                        image_max_dim=256)
        predictor, params = seeded_predictor(cfg, device)
        ms = serve_counted(predictor, [image], cfg)
        log(f"  {name:15s} {params:>12,d} parameters  {ms:8.1f} ms")
        del predictor
    torch.cuda.empty_cache()
    log(f"  ({card})")


def zoo_pretrained(device, card, root):
    """Phase 14c: a seeded timm EfficientNet-B0 file and a torchvision
    MobileNetV2 file through ``create_train_state`` at full coverage, bit-equal
    to the file, then one training step each."""
    log("== zoo pretrained: seeded timm efficientnet_b0 and torchvision mobilenet_v2 state_dicts into the "
        "flagship's training state")
    for name, sd, total in (("efficientnetb0", timm_efficientnet_state_dict("efficientnetb0", SEED + 15), 304),
                            ("mobilenetv2", torchvision_mobilenet_v2_state_dict(SEED + 16), 255)):
        path = os.path.join(root, f"{name}.pth")
        torch.save(sd, path)
        tcfg = flagship_train_config().replace(backbone=name, backbone_init_weights=path)
        printed = io.StringIO()
        gen = torch.Generator().manual_seed(SEED)
        with contextlib.redirect_stdout(printed):
            state = create_train_state(tcfg, gen, device=device)
        coverage = printed.getvalue().strip()
        if f"{total}/{total} leaves" not in coverage:
            raise AssertionError(f"{name}: pretrained coverage {coverage!r}; expected {total}/{total}")
        got = state.model.state_dict()
        converted = convert_torch_backbone(sd)
        differ = [k for k, v in converted.items() if not torch.equal(got["backbone." + k].cpu(), v)]
        if differ or len(converted) != total:
            raise AssertionError(f"{name}: backbone entries differ from the file's: {differ[:5]}")
        _, values = train_counted(state, make_train_step(tcfg), synthetic_batch(tcfg, 2, SEED + 6, device), gen, 1)
        log(f"  {name}: {coverage}; every backbone entry equals the file's bit for bit; 1 step: loss_sum "
            f"{values['loss_sum']:.4f}, grad_finite 1, launches (1, 2, 2) ({card})")
        del state
        torch.cuda.empty_cache()


def zoo_cross_check(device):
    """Phase 14d: small float32 backbones with the same seeded weights on the
    card (channels_last, TF32 off) and on the CPU: C1..C5 within 1e-4 of max
    |CPU|, with the batch norms on their running averages (randomised) and on
    batch statistics. EfficientNet-B0 runs cuDNN's 3x3 and 5x5 depthwise
    convs, SENet154's code at one block a stage its grouped 64x4d convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(SEED + 17).normal(size=(2, 3, 128, 128)).astype(np.float32))
    for name, make in (("efficientnetb0", lambda: get_backbone("efficientnetb0")),
                       ("senet154, one block a stage", lambda: ResNet(
                           stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=64, base_width=4, use_se=True,
                           deep_stem=True))):
        cpu = lecun_init_(make(), torch.Generator().manual_seed(SEED))
        g = torch.Generator().manual_seed(SEED + 1)
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 1.5)):
                        t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)
                    for t in (m.bias, m.running_mean):
                        t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        card = copy.deepcopy(cpu).to(device, memory_format=torch.channels_last)
        worst = {}
        for mode in ("running averages", "batch statistics"):
            train = mode == "batch statistics"
            with torch.no_grad():
                want = cpu.train(train)(x)
                got = card.train(train)(x.to(device).contiguous(memory_format=torch.channels_last))
            for level, ref in want.items():
                err = float((got[level].cpu() - ref).abs().max() / ref.abs().max())
                worst[mode] = max(worst.get(mode, 0.0), err)
                if not err <= 1e-4:
                    raise AssertionError(f"{name} ({mode}): {level} differs by {err} of max |CPU| between card and CPU")
        log(f"== zoo cross-check, {name}, float32 at 128x128, card (channels_last, TF32 off) vs CPU: C1..C5 within "
            + ", ".join(f"{v:.3g} on {k}" for k, v in worst.items()))


def run_zoo(device, card, root, requests):
    """Phase 14. Returns the launch counts of its main path (14a-14c)."""
    seconds = [time.perf_counter()]
    torch.cuda.synchronize()
    zero_launch_counts()
    zoo_full_width(device, card, requests)
    seconds.append(time.perf_counter())
    zoo_sweep(device, card)
    seconds.append(time.perf_counter())
    zoo_pretrained(device, card, root)
    launches = launch_counts()
    seconds.append(time.perf_counter())
    zoo_cross_check(device)
    seconds.append(time.perf_counter())
    parts = ", ".join(f"{name} {b - a:.1f} s" for name, a, b in zip(("full width", "sweep", "pretrained", "cross-check"),
                                                                    seconds, seconds[1:]))
    log(f"== zoo phase done in {seconds[-1] - seconds[0]:.1f} s ({parts}); launches (NMS, ROIAlign forward, "
        f"backward) {launches}")
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches))


# ---------------------------------------------------------------------------
# the training CLI with host augmentation
# ---------------------------------------------------------------------------


def single_transform(fn):
    """An ``augment_fn`` applying one transform of the weather or extended set."""
    def augment_fn(image, masks, py_rng, np_rng):
        image = np.ascontiguousarray(image)
        if fn in host_augment.GEOMETRIC:
            return fn(image, masks, py_rng, np_rng)
        return fn(image, py_rng, np_rng), masks
    return augment_fn


def host_augment_rates(train, cfg, card):
    """Loader images/s on the host, 4 threads, one pass over ``train``, for
    each augmentation setting."""
    off = dict(hflip_prob=0.0, rotate_prob=0.0, blur_prob=0.0, noise_prob=0.0)
    settings = [("none", None), ("none", None),  # the first pass warms the decoder and the page cache
                ("default set", host_augment.get_training_augmentation()),
                ("default + weather + extended", host_augment.get_training_augmentation(extended=True, weather=True))]
    for name in ("hflip", "vflip", "rotate", "blur", "noise"):
        settings.append((name, host_augment.get_training_augmentation(**{**off, f"{name}_prob": 1.0})))
    settings.append(("channel_shuffle", host_augment.get_training_augmentation(
        extended=True, extended_prob=0.0, channel_shuffle_prob=1.0, **off)))
    for fn in host_augment.WEATHER + host_augment.EXTENDED:
        settings.append((fn.__name__.lstrip("_"), single_transform(fn)))
    rates = {}
    for name, fn in settings:
        start = time.perf_counter()
        n = sum(len(b["images"]) for b in DataLoader(train, cfg, augment_fn=fn, seed=SEED).epoch(num_workers=4))
        rates[name] = n / (time.perf_counter() - start)
    log(f"  loader alone on the host, 4 threads, {len(train)} JPEGs of 512x512, images/s by augmentation "
        f"({card}):\n    " + "\n    ".join(f"{k}: {v:.2f}" for k, v in rates.items()))
    return rates


def run_train_cli(device, card, root):
    """Phase 15 (see the module's docstring), on phase 10's COCO directory
    in ``root``. Returns the CLI run's launch counts."""
    log("== train CLI: cli.coco_train at the flagship's widths (ResNet-50, 512x512, batch 2, 81 classes), host "
        "augmentation with the weather and extended sets, 6 + 2 images, 2 epochs")
    start_phase = time.perf_counter()
    coco, ckpt_dir = os.path.join(root, "coco"), os.path.join(root, "cli_ckpt")
    probe = make_tb_writer(os.path.join(root, "tb_probe"))
    if probe is None:
        log("  tensorboard: absent on this machine; --tensorboard is left out")
    else:
        import tensorboard
        log(f"  tensorboard: {tensorboard.__version__} present; --tensorboard writes the losses")
    argv = ["-dataset_path", coco, "-backbone", "resnet50", "-img_size", "512", "-batch_size", "2", "-epochs", "2",
            "--n_train", "6", "--n_val", "2", "--augment_weather", "--augment_extended", "--checkpoints_dir", ckpt_dir,
            "--device", "cuda"]
    if probe is not None:
        argv += ["--tensorboard", os.path.join(root, "tb")]
    seen = {}
    real_train_model = cli_train.train_model

    def recording(cfg, train, val, metric_writer=None, **kw):  # the CLI's own call, with a history kept
        history, losses = [], []

        def write(step, values):
            losses.append(values)
            if metric_writer is not None:
                metric_writer(step, values)

        seen.update(cfg=cfg, train=train, val=val, augment=kw.get("augment_fn"), history=history, losses=losses)
        return real_train_model(cfg, train, val, metric_writer=write, history=history, **kw)

    torch.cuda.synchronize()
    zero_launch_counts()
    with mock.patch.object(cli_train, "train_model", recording):
        state = cli_train.main(argv)
    launches = launch_counts()
    cfg, history = seen["cfg"], seen["history"]
    if seen["augment"] is None or len(seen["train"]) != 6 or len(seen["val"]) != 2 or cfg.num_classes != 81:
        raise AssertionError(f"train CLI: augment {seen['augment']}, {len(seen['train'])} + {len(seen['val'])} "
                             f"images, {cfg.num_classes} classes")
    n_steps = sum(h["steps"] for h in history)
    eval_steps = cfg.epochs * sum(1 for _ in DataLoader(seen["val"], cfg, shuffle=False).epoch())
    want = (n_steps + eval_steps, 2 * n_steps + 2 * eval_steps, 2 * n_steps)
    if not n_steps or state.step != n_steps or launches != want:
        raise AssertionError(f"train CLI: {n_steps} steps (state at {state.step}), {eval_steps} eval steps launched "
                             f"(NMS, ROIAlign, backward) = {launches}; expected {want}")
    if not all(np.isfinite(v) for values in seen["losses"] for v in values.values()) or \
            not all(np.isfinite(v) for h in history for k, v in h.items() if "loss" in k):
        raise AssertionError(f"train CLI: a loss is not finite: {seen['losses']} {history}")
    manager = ckpt_lib.make_manager(cfg)
    kept = manager.all_steps()
    if not os.path.basename(manager.directory).endswith(cfg.md5()[:8]) or not kept or \
            not set(kept) <= {0, 1} or cfg.save_best_only is not True:
        raise AssertionError(f"train CLI: checkpoints {kept} in {manager.directory} for md5 {cfg.md5()}")
    if probe is not None and not any(f.startswith("events.") for f in os.listdir(os.path.join(root, "tb"))):
        raise AssertionError("train CLI: --tensorboard wrote no event file")
    log(f"  {n_steps} steps and {eval_steps} eval steps launched NMS, ROIAlign forward, backward {launches} times, "
        f"as expected; finite losses (loss_sum by epoch {[round(h['loss_sum'], 4) for h in history]}); best-only "
        f"checkpoints of epochs {kept} in {os.path.basename(manager.directory)} (md5 {cfg.md5()})")

    # the same run from a YAML with one flag typed: the same md5, its checkpoint resumed
    path = os.path.join(root, "cli.yaml")
    cfg.to_yaml(path)
    again = ["-dataset_path", coco, "--config", path, "-epochs", "2", "--n_train", "6", "--n_val", "2",
             "--augment_weather", "--augment_extended", "--device", "cuda"]
    zero_launch_counts()
    with mock.patch.object(cli_train, "train_model", recording):
        resumed = cli_train.main(again)
    if seen["cfg"].md5() != cfg.md5() or resumed.step != state.step or launch_counts() != (0, 0, 0):
        raise AssertionError(f"train CLI from {path}: md5 {seen['cfg'].md5()} (want {cfg.md5()}), resumed at step "
                             f"{resumed.step} (want {state.step}), launches {launch_counts()}")
    log(f"  --config YAML with -epochs typed: md5 {cfg.md5()} again; resumed the checkpoint at step {resumed.step} "
        f"with nothing left to train")
    del state, resumed

    step_ips = [h["steps"] * cfg.batch_size / h["train_seconds"] for h in history]
    wait = [h["loader_wait_s"] / h["train_seconds"] for h in history]
    log(f"  the CLI's train_model: {step_ips[-1]:.2f} images/s over epoch 2's training steps ({step_ips[0]:.2f} in "
        f"epoch 1, its first step included) with the host augmentation; loader wait {wait[-1]:.4f} of epoch 2's "
        f"training time, {wait[0]:.4f} of epoch 1's ({card})")
    train = CocoDataset()
    train.load_coco(coco, "train")  # all 12 training images
    train.prepare()
    host_augment_rates(train, cfg.replace(sample_cache_dir=None), card)
    log(f"== train CLI phase done in {time.perf_counter() - start_phase:.1f} s")
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches))

# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

DP_RANKS = 2


def all_reduce_ms(tensors, group, reps=3):
    """Median ms of ``fused_all_reduce_mean`` of ``tensors`` on the host clock,
    after one warm-up (the card synchronized around each)."""
    fused_all_reduce_mean(tensors, group)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fused_all_reduce_mean(tensors, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


def emulate_first_step(cfg, device, dp_params, dp_stats, dp_mu):
    """Rank 0's first data-parallel step emulated in one process: each half
    of the batch through ``_loss`` with that rank's draws from the seeded
    start, the gradients and running statistics averaged, then the optimizer.
    The step's reduced gradients, read from its first adamax moment (``mu =
    0.1 * clip(g)`` from zero), are held leaf by leaf within 1e-4 * (max
    |emulated leaf| + the step's largest |emulated mu|), the whole-step
    test's rule; the parameters within 1e-3 * lr where |g| >= 1e-4 (adamax's
    first update is about lr * sign(g), so only the moment binds the
    gradients' size); the running statistics within 1e-5 of max(1, |stat|).
    Returns the errors and the counts of bit-equal moments and parameters."""
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
    model, lr = state.model, cfg.learning_rate
    params, stats = list(model.parameters()), _bn_stats(model)
    start_stats = [t.clone() for t in stats]
    full = synthetic_batch(cfg, DP_RANKS, SEED + 16, device)
    grads, new_stats = None, None
    for r in range(DP_RANKS):
        with torch.no_grad():
            for t, s0 in zip(stats, start_stats):
                t.copy_(s0)
        half = shard_batch(full, r, DP_RANKS)
        total, _ = _loss(model, half, _draws(cfg, half, step_generator(SEED, 0, r), None), cfg, augment=True)
        g = torch.autograd.grad(total, params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(params, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        new_stats = [t.clone() for t in stats] if new_stats is None else [a + b for a, b in zip(new_stats, stats)]
    grads = [g / DP_RANKS for g in grads]
    updates, new_opt = build_optimizer(cfg).update(grads, state.opt_state, params)
    mu = new_opt.slots["mu"]
    mu_max = max(float(m.abs().max()) for m in mu)
    mu_err, mu_equal = 0.0, 0
    for m, q in zip(mu, dp_mu):
        d = float((m - q).abs().max())
        if not d <= 1e-4 * (float(m.abs().max()) + mu_max):
            raise AssertionError(f"data parallel vs its emulation: a reduced gradient's moment off by {d} "
                                 f"(leaf max {float(m.abs().max())}, step max {mu_max})")
        mu_err = max(mu_err, d)
        mu_equal += int(bool(torch.equal(m, q)))
    err, err_big, equal = 0.0, 0.0, 0
    for p, u, g, q in zip(params, updates, grads, dp_params):
        d = ((p.detach() + u) - q).abs()
        err = max(err, float(d.max()))
        big = g.abs() >= 1e-4
        if bool(big.any()):
            err_big = max(err_big, float(d[big].max()))
        equal += int(bool(torch.equal(p.detach() + u, q)))
    stat_err = max(float((s / DP_RANKS - q).abs().max()) for s, q in zip(new_stats, dp_stats))
    if err_big > 1e-3 * lr or stat_err > 1e-5 * max(1.0, max(float(q.abs().max()) for q in dp_stats)):
        raise AssertionError(f"data parallel vs its emulation: params {err} (where |g| >= 1e-4: {err_big}), "
                             f"statistics {stat_err}; lr {lr}")
    return dict(mu_err=mu_err, mu_max=mu_max, mu_equal=mu_equal, err=err, err_big=err_big, stat_err=stat_err,
                equal=equal, n=len(params))


def dp_steps(rank, cfg, device, group, batch, out, calls=None):
    """Phase 16(a) on one rank: 3 data-parallel steps of the flagship at one
    image a rank; the ranks bit-identical after each; launches, step times,
    the all-reduces of each step (counted through ``torch.distributed.
    all_reduce``: the fused one is the buffer of the gradients, the total,
    the losses and, without sync-BN, the running statistics; every other is
    a sync-BN's). With ``calls`` the first step records the kernel wrappers'
    inputs there. Returns the first step's parameters, running statistics
    and first adamax moments."""
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device, group=group)
    step = make_train_step(cfg, group)
    params = list(state.model.parameters())
    numels = []
    all_reduce = torch.distributed.all_reduce

    def counted_all_reduce(tensor, *args, **kwargs):
        numels.append(tensor.numel())
        return all_reduce(tensor, *args, **kwargs)

    torch.cuda.synchronize()
    zero_launch_counts()
    times, first, per_step = [], None, []
    for i in range(3):
        start = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(torch.distributed, "all_reduce", counted_all_reduce))
            if calls is not None and i == 0:
                stack.enter_context(recorded_wrappers(calls))
            state, losses = step(state, batch, rng=step_generator(SEED, i, rank))
            torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        per_step.append(len(numels))
        values = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(v) for v in values.values()) or values["grad_finite"] != 1.0:
            raise AssertionError(f"rank {rank} data-parallel step {i} (sync_bn={cfg.sync_bn}): {values}")
        if i == 0:
            launches = launch_counts()
            first = ([p.detach().clone() for p in params], [t.clone() for t in _bn_stats(state.model)],
                     [m.clone() for m in state.opt_state.slots["mu"]])
        check_replicated(state.model, group, f"the state after step {i} (sync_bn={cfg.sync_bn})")
    if launches != (1, 2, 2) or launch_counts() != (3, 6, 6):
        raise AssertionError(f"rank {rank}: launches {launches} in step 1, {launch_counts()} in 3 steps")
    stats_numel = 0 if cfg.sync_bn else sum(t.numel() for t in _bn_stats(state.model))
    numel = sum(p.numel() for p in params) + len(values) + stats_numel  # + the total - grad_finite
    fused = [n for n in numels if n == numel]
    bn = [n for n in numels if n != numel]
    if len(fused) != 3 or per_step != [len(numels) // 3 * k for k in (1, 2, 3)] or bool(bn) != cfg.sync_bn:
        raise AssertionError(f"rank {rank}: {len(fused)} all-reduces of {numel} elements in 3 steps, "
                             f"{per_step} all-reduces in all after each step (sync_bn={cfg.sync_bn})")
    key = "sync" if cfg.sync_bn else "per_rank"
    out[key] = dict(times=times, loss=values["loss_sum"], fused=len(fused), numel=numel,
                    bn_per_step=len(bn) // 3)
    if not cfg.sync_bn:
        out["gloo_ms"] = all_reduce_ms([p.detach() for p in params], group)
    if calls is not None:
        check_step_calls(calls)
    return first


def hold_dp_calls(calls, device, what=f"data-parallel inputs (rank 0 of {DP_RANKS}, one image a rank)"):
    """Each kernel of the data-parallel step against its plain version on the
    inputs its wrapper got in rank 0's first step (one image a rank), timed
    beside its bound; the matmul and cuDNN TF32 flags, which the ROIAlign
    hold clears, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=device)
    try:
        log(f"== holds, {what}: greedy NMS and pyramid ROIAlign forward kernels vs their plain versions")
        return dict(nms=hold_nms(calls["nms"], flush), roi_align=hold_roi_align(calls["roi_align"], flush),
                    roi_align_backward=hold_roi_backward(calls["roi_align_backward"], flush, shape_cases=False))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def dp_sync_bn_c2(rank, device, group):
    """The sync BatchNorm at the flagship's C2 (``[1, 256, 128, 128]`` bf16
    a rank) against one BatchNorm over the concatenated batch: outputs within
    2**-7 of max |y|, running statistics within 1e-5 of max(1, |stat|)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    scale = torch.rand(256, generator=gen, device=device) * 1.5 + 0.5
    shift = torch.randn(256, generator=gen, device=device)
    x = (torch.randn(DP_RANKS, 256, 128, 128, generator=gen, device=device) * scale[:, None, None]
         + shift[:, None, None]).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    sync = layers.sync_batch_norms_(layers.BatchNorm(256).to(device), group).train()
    plain = layers.BatchNorm(256).to(device).train()
    with torch.no_grad():
        y = sync(x[rank:rank + 1]).float()
        want = plain(x)[rank:rank + 1].float()
    err = float((y - want).abs().max())
    stat = max(float((a - b).abs().max()) for a, b in ((sync.running_mean, plain.running_mean),
                                                         (sync.running_var, plain.running_var)))
    ymax = float(want.abs().max())
    smax = max(1.0, float(plain.running_var.abs().max()), float(plain.running_mean.abs().max()))
    if err > 2 ** -7 * ymax or stat > 1e-5 * smax:
        raise AssertionError(f"rank {rank}: sync BatchNorm at C2 off by {err} (max |y| {ymax}), statistics {stat}")
    return err, ymax, stat


def dp_train_model(rank, device, group, root):
    """Phase 16(c) on one rank: train_model under the group with sync-BN on
    phase 10's COCO directory, 2 epochs of 3 steps with validation; then the
    preemption drill (rank 1 signals itself after rank 0's second step) and
    the resume."""
    train, val = CocoDataset(), CocoDataset()
    train.load_coco(os.path.join(root, "coco"), "train")
    val.load_coco(os.path.join(root, "coco"), "val")
    train.prepare()
    val.prepare()
    cfg = flagship_train_config().replace(num_classes=train.num_classes, epochs=2, log_per_steps=1, sync_bn=True,
                                          sample_cache_dir=os.path.join(root, "dp_cache"),
                                          checkpoints_dir=os.path.join(root, "dp_ckpt"))
    writes = []
    save = ckpt_lib.CheckpointManager.save

    def counted_save(self, step, *args):
        writes.append(os.path.basename(self.directory) + f"/{step}")
        return save(self, step, *args)

    history, losses = [], []
    with mock.patch.object(ckpt_lib.CheckpointManager, "save", counted_save):
        zero_launch_counts()
        state = train_model(cfg, train, val, steps_per_epoch=3, rng_seed=SEED, device=device, group=group,
                            history=history, checkpoint_base=os.path.join(root, "dp_main"),
                            metric_writer=lambda step, values: losses.append(values))
        launches = launch_counts()
        check_replicated(state.model, group, "train_model's final state")
        main_step = state.step
        del state
        trigger = os.path.join(root, "dp_sigterm_rank1")
        marks = []

        def mark(step, values):
            marks.append(step)
            if len(marks) == 2:
                open(trigger, "w").close()

        if rank == 1:
            multihost_dryrun.signal_self_on(trigger)
        drill = os.path.join(root, "dp_drill")
        state = train_model(cfg, train, val, steps_per_epoch=3, rng_seed=SEED, device=device, group=group,
                            checkpoint_base=drill, metric_writer=mark)
        stopped = state.step
        del state
        pre = sorted(f for f in os.listdir(ckpt_lib.make_preempt_manager(cfg, drill).directory) if f.endswith(".pt"))
        state = train_model(cfg, train, val, steps_per_epoch=3, rng_seed=SEED, device=device, group=group,
                            checkpoint_base=drill)
        check_replicated(state.model, group, "the resumed state")
        resumed = state.step
    eval_steps = cfg.epochs * (len(val) // cfg.batch_size)
    n_steps = sum(h["steps"] for h in history)
    want = (n_steps + eval_steps, 2 * n_steps + 2 * eval_steps, 2 * n_steps)
    if n_steps != 6 or main_step != 6 or launches != want:
        raise AssertionError(f"rank {rank}: train_model {n_steps} steps, launches {launches}; expected {want}")
    if not all(np.isfinite(v) for h in history for k, v in h.items() if "loss" in k) or \
            not all(np.isfinite(v) for values in losses for v in values.values()):
        raise AssertionError(f"rank {rank}: a loss is not finite: {history}")
    if pre != ["ckpt_0.pt"] or not 2 <= stopped <= 3 or resumed != stopped + 3:
        raise AssertionError(f"rank {rank}: drill stopped at {stopped}, preemption files {pre}, resumed {resumed}")
    want_writes = ["maskrcnn_resnet50_" + cfg.md5()[:8] + "/0", "maskrcnn_resnet50_" + cfg.md5()[:8] + "/1",
                   "preempt/0", "maskrcnn_resnet50_" + cfg.md5()[:8] + "/1"]
    if writes != (want_writes if rank == 0 else []) or (rank == 0 and len(losses) != 6) or (rank and losses):
        raise AssertionError(f"rank {rank}: checkpoint writes {writes}, metric writes {len(losses)}")
    ips = [h["steps"] * cfg.batch_size / h["train_seconds"] for h in history]
    return dict(launches=launches, stopped=stopped, resumed=resumed, ips=ips, writes=len(writes),
                val_loss=[h["val_loss_sum"] for h in history])


def dp_rank(rank, size, init_method, root):
    """Phase 16(a) and (c) on one of two gloo ranks that share the card."""
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    group = distributed.initialize("gloo", rank, size, init_method, timeout_s=300, device=device)
    start = time.perf_counter()
    out = {"rank": rank}
    cfg = flagship_train_config()  # batch 2: one image a rank
    batch = shard_batch(synthetic_batch(cfg, size, SEED + 16, device), rank, size)
    calls = {"nms": [], "roi_align": [], "roi_align_backward": []} if rank == 0 else None
    first = dp_steps(rank, cfg, device, group, batch, out, calls)
    if rank == 0:
        out["emulation"] = emulate_first_step(cfg, device, *first)
        out["holds"] = hold_dp_calls(calls, device)
    del first, calls
    dp_steps(rank, cfg.replace(sync_bn=True), device, group, batch, out)
    out["c2"] = dp_sync_bn_c2(rank, device, group)
    torch.cuda.empty_cache()
    out["seconds_a"] = time.perf_counter() - start
    out["train_model"] = dp_train_model(rank, device, group, root)
    out["seconds"] = time.perf_counter() - start
    return out


def dp_nccl_one_rank(device, card):
    """Phase 16(b): one NCCL rank set up as ``torchrun --standalone
    --nproc_per_node 1`` sets it up; 2 data-parallel steps against
    ``make_train_step`` from the same seed, bit for bit (cuDNN and PyTorch
    held to deterministic algorithms for both)."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(multihost_dryrun.free_port()))
    with mock.patch.dict(os.environ, env):
        group = distributed.initialize()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        backend = torch.distributed.get_backend(group)
        if backend != "nccl":
            raise AssertionError(f"initialize() chose {backend} for the card")
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        cfg = flagship_train_config()
        batch = synthetic_batch(cfg, 2, SEED + 16, device)
        ends = {}
        for name, g in (("plain", None), ("dp", group)):
            state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
            step = make_train_step(cfg, g)
            for i in range(2):
                state, losses = step(state, batch, rng=step_generator(SEED, i))
            ends[name] = ([t.clone() for t in state.model.state_dict().values()],
                          {k: v.clone() for k, v in losses.items()}, state.opt_state.slots)
            if name == "dp":
                nccl_ms = all_reduce_ms([p.detach() for p in state.model.parameters()], group)
            del state
        (sd, lo, slots), (sd_dp, lo_dp, slots_dp) = ends["plain"], ends["dp"]
        differ = [i for i, (a, b) in enumerate(zip(sd, sd_dp)) if not torch.equal(a, b)]
        differ += [k for k in lo if not torch.equal(lo[k], lo_dp[k])]
        differ += [f"{k}{i}" for k in slots for i, (a, b) in enumerate(zip(slots[k], slots_dp[k]))
                   if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"one NCCL rank: 2 data-parallel steps differ from make_train_step in {differ[:8]}")
        log(f"  (b) one NCCL rank through parallel.distributed.initialize() (torchrun's variables): 2 data-parallel "
            f"steps bit-equal to make_train_step ({len(sd)} state tensors, the losses, the optimizer slots); "
            f"the fused all-reduce {nccl_ms:.3f} ms under NCCL at one rank ({card})")
        return nccl_ms
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        torch.use_deterministic_algorithms(False)
        distributed.destroy()


def dp_cli_torchrun(root, card):
    """Phase 16(d): ``cli.coco_train --sync_bn`` under ``torchrun --standalone
    --nproc_per_node 1``: 1 epoch of 2 steps, a finite loss, the checkpoint."""
    argv = ["-dataset_path", os.path.join(root, "coco"), "-backbone", "resnet50", "-img_size", "512",
            "-batch_size", "2", "-epochs", "1", "--n_train", "4", "--n_val", "2", "--no_augment", "--sync_bn",
            "--checkpoints_dir", os.path.join(root, "dp_cli_ckpt")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "maskrcnn_tf2_tpu_torch.cli.coco_train"] + argv
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.abspath(__file__)),
                                                       os.environ.get("PYTHONPATH", "")]))
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - start
    lines = [ln for ln in text.splitlines() if ln.startswith("epoch 1/1 loss=")]
    loss = float(lines[0].split("loss=")[1].split()[0]) if lines else float("nan")
    cfg = cli_train.build_config(cli_train.build_argparser().parse_args(argv), argv)
    kept = ckpt_lib.make_manager(cfg).all_steps()
    if proc.returncode != 0 or not np.isfinite(loss) or kept != [0] or not cfg.sync_bn:
        raise AssertionError(f"torchrun cli.coco_train --sync_bn: exit {proc.returncode}, loss {loss}, "
                             f"checkpoints {kept}:\n{text[-4000:]}")
    log(f"  (d) torchrun --standalone --nproc_per_node 1 -m maskrcnn_tf2_tpu_torch.cli.coco_train --sync_bn: "
        f"1 epoch of 2 steps, loss_sum {loss:.4f}, checkpoint of epoch 0 under md5 {cfg.md5()[:8]}; "
        f"{seconds:.1f} s with the process start ({card})")


def run_data_parallel(device, card, root, single_ips):
    """Phase 16 (see the module's docstring). Returns rank 0's launch counts
    in train_model under two ranks."""
    log("== data parallel: two gloo ranks sharing the card (flagship, 1 image a rank), one NCCL rank, the CLI "
        "under torchrun")
    start = time.perf_counter()
    out = multihost_dryrun.launch(dp_rank, DP_RANKS, (root,), timeout_s=600, num_threads=4)
    r0 = out[0]
    for key, what in (("per_rank", "per-rank BN"), ("sync", "sync-BN")):
        a = [o[key] for o in out]
        if any(x["fused"] != 3 for x in a) or a[0]["loss"] != a[1]["loss"]:
            raise AssertionError(f"{what}: fused all-reduces {[x['fused'] for x in a]}, losses "
                                 f"{[x['loss'] for x in a]}")
        log(f"  (a) {what}: 3 steps on each rank, launches (1, 2, 2) a step on each, the ranks bit-identical "
            f"after every step (state checksums all-reduced), 1 fused all-reduce a step of "
            f"{a[0]['numel']} float32 elements ({a[0]['numel'] * 4 / 1e9:.4f} GB), {a[0]['bn_per_step']} sync-BN "
            f"all-reduces a step; step ms rank 0 {[round(t, 1) for t in a[0]['times']]}, rank 1 "
            f"{[round(t, 1) for t in a[1]['times']]} ({card})")
    e = r0["emulation"]
    log(f"  (a) the 2-rank update against its single-process emulation (each half through _loss with its rank's "
        f"draws, averaged, then adamax): the reduced gradients' first moments within {e['mu_err']:.3g} (held "
        f"per leaf <= 1e-4 (leaf max + step max {e['mu_max']:.3g})), {e['mu_equal']} of {e['n']} bit-equal; "
        f"max |param diff| {e['err']:.3g}, {e['err_big']:.3g} where |grad| >= 1e-4 (held <= 1e-3 lr), "
        f"{e['equal']} of {e['n']} parameters bit-equal; running statistics {e['stat_err']:.3g} (held <= 1e-5 "
        f"of max)")
    c2 = [o["c2"] for o in out]
    log(f"  (a) the sync BatchNorm at C2 ([1, 256, 128, 128] bf16 a rank) against one BatchNorm over the "
        f"concatenated batch: outputs within {max(c[0] for c in c2):.3g} (held <= 2**-7 of max |y| "
        f"{c2[0][1]:.3g}), statistics within {max(c[2] for c in c2):.3g}")
    log(f"  the fused all-reduce of the {r0['per_rank']['numel']}-element buffer's parameters under gloo, two "
        f"ranks sharing the card: {r0['gloo_ms']:.1f} ms ({card})")
    tm = [o["train_model"] for o in out]
    if tm[0]["launches"] != tm[1]["launches"] or tm[0]["stopped"] != tm[1]["stopped"] or \
            tm[0]["resumed"] != tm[1]["resumed"]:
        raise AssertionError(f"train_model under two ranks: {tm}")
    log(f"  (c) train_model with sync-BN under two gloo ranks on phase 10's COCO directory: 2 epochs of 3 steps, "
        f"launches {tm[0]['launches']} on each rank (6 steps x (1, 2, 2) + 4 eval steps x (1, 2, 0)); "
        f"val_loss_sum {[round(v, 4) for v in tm[0]['val_loss']]}; rank 0 alone wrote the {tm[0]['writes']} "
        f"checkpoints and the metrics; SIGTERM to rank 1 after rank 0's second step: both ranks stopped after "
        f"step {tm[0]['stopped']}, one preemption checkpoint, the resume ran to step {tm[0]['resumed']}")
    log(f"  (c) images/s of train_model's steps, two gloo ranks sharing one card (no scaling number: the fused "
        f"all-reduce goes through host memory): {tm[0]['ips'][-1]:.2f} in epoch 2 ({tm[0]['ips'][0]:.2f} in "
        f"epoch 1); single-process train_model in this call (phase 10): {single_ips:.2f} ({card})")
    log(f"  the two ranks' processes took {max(o['seconds'] for o in out):.1f} s ((a) "
        f"{max(o['seconds_a'] for o in out):.1f} s)")
    dp_nccl_one_rank(device, card)
    dp_cli_torchrun(root, card)
    log(f"== data parallel phase done in {time.perf_counter() - start:.1f} s")
    names = ("nms", "roi_align", "roi_align_backward")
    return {name: dict(data_parallel_launches=n, data_parallel_ms=r0["holds"][name]["ms"],
                       data_parallel_plain_ms=r0["holds"][name]["plain_ms"],
                       data_parallel_bound_ms=r0["holds"][name]["bound_ms"],
                       data_parallel_max_abs_err=r0["holds"][name]["max_abs_err"])
            for name, n in zip(names, tm[0]["launches"])}


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

INT8_OPS = 1979e12  # H100 SXM, dense int8 tensor-core operations a second
# Floors a wiring fault (a wrong scale, a site fed the wrong tensor) falls far
# below and rounding flips do not (readings on an H100: top-5 0.875; the
# small model card vs CPU 0.0295 relative L2, 0.99 of classes equal)
TOP5_FLOOR = 0.5
CROSS_MAX_REL_L2 = 0.1
CROSS_MIN_CLASSES = 0.9


def request_batches(requests, cfg):
    """Each request as the (images, meta) batch the inference forward takes."""
    for images in requests:
        molded, metas = zip(*(process_input(im, cfg, i) for i, im in enumerate(images)))
        yield torch.from_numpy(np.stack(molded)), torch.from_numpy(np.stack(metas))


def int8_predictor(cfg, state_dict, batches, device):
    qcfg, qstate = quantize_for_inference(cfg, state_dict, batches, device=device)
    return Predictor(qcfg, qstate, device=device)


def capture_int8(predictor, images):
    """One request through the int8 path, recording K7's wrapper inputs.
    Returns ``(calls, results, launches)``: launches counted by the wrapper."""
    calls = []

    def wrapped(*args):
        calls.append(args)
        return int8_kernel.int8_conv(*args)

    before = int8_kernel.int8_conv.launches
    with mock.patch.object(quant, "int8_conv", wrapped):
        results = predictor.detect(images)
    torch.cuda.synchronize()
    return calls, results, int8_kernel.int8_conv.launches - before


def int8_cases(device):
    """K7's edge cases: (name, x, w, sx, sw, bias, stride, groups)."""
    rs = np.random.RandomState(SEED + 17)

    def case(name, x_shape, w_shape, stride, groups, bias=True, zeros=False):
        x = np.zeros(x_shape) if zeros else rs.randint(-127, 128, x_shape)
        amax = 0.0 if zeros else 3.0
        t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
        o = w_shape[0]
        return (name, t(x, torch.int8), t(rs.randint(-127, 128, w_shape), torch.int8),
                t(max(amax, 1e-6) / 127.0, torch.float32), t(rs.uniform(1e-4, 1e-2, o), torch.float32),
                t(rs.normal(size=o), torch.float32) if bias else None, stride, groups)

    return [
        case("ResNeXt-50 C2 grouped 3x3, 32 groups of 4", (2, 128, 128, 128), (128, 3, 3, 4), 1, 32, bias=False),
        case("ResNeXt-50 C3 grouped 3x3/2, 32 groups of 8", (2, 128, 128, 256), (256, 3, 3, 8), 2, 32, bias=False),
        case("depthwise 3x3 (MASKRCNN_TPU_INT8_DW=1), C 144", (2, 128, 128, 144), (144, 3, 3, 1), 1, 144, bias=False),
        case("depthwise 5x5/2 on odd H, W, C 240", (2, 63, 65, 240), (240, 5, 5, 1), 2, 240, bias=False),
        case("I 3, 7x7/2 on odd H, W", (2, 255, 253, 3), (64, 7, 7, 3), 2, 1),
        case("I 36, 3x3/2 on odd H, W", (2, 63, 65, 36), (72, 3, 3, 36), 2, 1),
        case("dense 3x3/2 on odd H, W, C 256", (2, 33, 31, 256), (512, 3, 3, 256), 2, 1),
        case("classifier FC, K 12544 (quant_classifier)", (2000, 1, 1, 12544), (1024, 1, 1, 12544), 1, 1),
        case("input amax 0", (2, 64, 64, 256), (256, 3, 3, 256), 1, 1, zeros=True),
        case("I 4, 3x3, M, N and K tails", (3, 37, 29, 4), (40, 3, 3, 4), 1, 1),
        case("I 40, 3x3/2 (8-byte copies)", (2, 31, 33, 40), (72, 3, 3, 40), 2, 1, bias=False),
        case("split K: C5's 3x3 at M 512", (2, 16, 16, 512), (512, 3, 3, 512), 1, 1),
        case("split K with M, N and K tails, I 112", (3, 7, 9, 112), (200, 3, 3, 112), 1, 1),
    ]


def hold_int8(name, x, w, sx, sw, bias, stride, groups):
    """K7 bit-equal to int8_conv_plain in float32 and bfloat16; a second
    launch the same bits. Returns the largest ``|kernel - plain|`` and
    ``|kernel - kernel again|`` over both dtypes."""
    err = gap = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        got = int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype)
        again = int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype)
        want = int8_kernel.int8_conv_plain(x, w, sx, sw, bias, stride, groups, dtype)
        torch.cuda.synchronize()
        err = max(err, float((got.float() - want.float()).abs().max()))
        gap = max(gap, float((got.float() - again.float()).abs().max()))
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"K7 ({name}, {dtype}): {int((got != want).sum())} values differ from the plain "
                                 f"version (at most {err}), {int((got != again).sum())} between two launches")
    return err, gap


def plan_text(p):
    """A K7 plan (``int8_conv.last_plan``) for the log."""
    tile = f", {p.tile}x{p.tile} tiles" if p.tile else ""
    split = f", split {p.split} x {p.steps_per_split} steps of K" if p.split > 1 else ""
    return f"{p.kernel}{tile}, {p.vec}-byte copies, grid {p.grid}{split}"


def int8_site_table(calls, flush):
    """Each distinct site shape of one request: held (both dtypes, twice),
    then timed at the path's dtype beside its bound, the plain version, the
    bf16 cuDNN convolution of the same shape and, for every 1x1 stride-1
    site, ``torch._int_mm`` on the same int8 operands; a site of one group
    must run on the tensor-core path. Returns the summed per-request fields."""
    shapes = {}
    for args in calls:
        x, w, sx, sw, bias, stride, groups, dtype = args
        key = (tuple(x.shape), tuple(w.shape), stride, groups, bias is not None, dtype)
        shapes.setdefault(key, [args, 0])[1] += 1
    totals = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, cudnn_ms=0.0, int_mm_ms=0.0, fc_ms=0.0,
                  pointwise_ms=0.0, pointwise_int_mm_ms=0.0, max_abs_err=0.0, relaunch_max_abs_diff=0.0)
    for (xs, ws, stride, groups, has_bias, dtype), (args, count) in shapes.items():
        x, w, sx, sw, bias = args[:5]
        err, gap = hold_int8("path", x, w, sx, sw, bias, stride, groups)
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        totals["relaunch_max_abs_diff"] = max(totals["relaunch_max_abs_diff"], gap)
        n, h, wd, c = xs
        o, kh, kw, cg = ws
        ho, wo = -(-h // stride), -(-wd // stride)
        ops = 2.0 * n * ho * wo * o * kh * kw * cg
        nbytes = x.numel() + w.numel() + 4 * (1 + o + (o if has_bias else 0)) + n * ho * wo * o * y_item(dtype)
        k = kernel_ms(lambda: int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype), 10, flush)
        path, plan = int8_kernel.int8_conv.last_path, int8_kernel.int8_conv.last_plan
        if groups == 1 and path != "tensor-core":
            raise AssertionError(f"K7 ran {xs} * {ws} (one group) on {path}, not the tensor-core path")
        p = kernel_ms(lambda: int8_kernel.int8_conv_plain(x, w, sx, sw, bias, stride, groups, dtype), 3, flush)
        lib, mm = int8_library_ms(x, w, stride, groups, flush)
        line = (f"  {xs} * {ws} /{stride} g{groups} x{count}: kernel {k:.4f} ms ({plan_text(plan)}),"
                f" bound {max(ops / INT8_OPS, nbytes / HBM_BYTES_PER_S) * 1e3:.4f} ms, plain {p:.3f} ms, "
                f"bf16 cuDNN {lib:.4f} ms")
        if isinstance(mm, str):
            line += f", torch._int_mm refused: {mm}"
        elif mm is not None:
            line += f", torch._int_mm {mm:.4f} ms"
            totals["pointwise_int_mm_ms"] += mm * count
            totals["pointwise_ms"] += k * count
            if h == wd == 1:
                totals["int_mm_ms"] += mm * count
                totals["fc_ms"] += k * count
        log(line)
        totals["ms"] += k * count
        totals["plain_ms"] += p * count
        totals["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3 * count
        totals["ops_ms"] += ops / INT8_OPS * 1e3 * count
        totals["cudnn_ms"] += lib * count
    return totals, len(shapes)


def int8_library_ms(x, w, stride, groups, flush, reps=10):
    """A K7 call's yardsticks, never used by the port: the float op the site
    replaces (cuDNN on the same shape in bf16, pads applied beforehand) and,
    at a 1x1 stride-1 site of one group, ``torch._int_mm`` on the same int8
    operands (``None`` elsewhere, the first line of its error where it
    refuses the shape)."""
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    top, bottom = layers.same_pad_amounts(h, kh, stride)
    left, right = layers.same_pad_amounts(wd, kw, stride)
    xf = F.pad(x.permute(0, 3, 1, 2).to(torch.bfloat16), (left, right, top, bottom))
    xf = xf.contiguous(memory_format=torch.channels_last)
    wf = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cudnn = kernel_ms(lambda: F.conv2d(xf, wf, None, stride, 0, 1, groups), reps, flush)
    if not (kh == kw == 1 and stride == 1 and groups == 1):
        return cudnn, None
    a, b = x.reshape(n * h * wd, c), w.reshape(o, c).t()
    try:
        return cudnn, kernel_ms(lambda: torch._int_mm(a, b), reps, flush)
    except RuntimeError as e:
        return cudnn, str(e).splitlines()[0][:80]


def y_item(dtype):
    return torch.empty((), dtype=dtype).element_size()


def forward_ms(model, images, metas, reps=10):
    """Median ms of the device forward ``model(images, metas)`` (a model or an
    engine's ``run``) by CUDA events, after 3 warm-up calls."""
    with torch.no_grad():
        for _ in range(3):
            model(images, metas)
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model(images, metas)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def box_iou(a, b):
    y1, x1 = np.maximum(a[:, None, 0], b[None, :, 0]), np.maximum(a[:, None, 1], b[None, :, 1])
    y2, x2 = np.minimum(a[:, None, 2], b[None, :, 2]), np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area = lambda r: (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def top5_match(ref, got):
    """Share of ``ref``'s top-5 detections that ``got`` has too (same class, IoU >= 0.9)."""
    top = np.argsort(-ref["scores"])[:5]
    if len(top) == 0 or len(got["scores"]) == 0:
        return 0.0
    iou = box_iou(ref["rois"][top].astype(np.float64), got["rois"].astype(np.float64))
    same = ref["class_ids"][top][:, None] == got["class_ids"][None, :]
    return float(np.mean(((iou >= 0.9) & same).any(axis=1)))


def int8_cross_check(device):
    """Phase 17d: a small float32 int8 model (both head switches), calibrated
    once on the CPU, served on the card (cast for serving, TF32 off) and on
    the CPU. Every int8 site call of the CPU's forward, its input handed to the
    card's site, gives the CPU's output bit for bit (quantization on the
    card, K7, the epilogue). End to end the two only agree in distribution:
    a float op rounded another way (cuDNN's batch norm, say) moves a value
    across a rounding boundary of the next quantization, and the flip spreads.
    So end to end holds only floors that a wiring fault falls below: C2-C5
    and P2-P6 within ``CROSS_MAX_REL_L2`` relative L2, and
    ``CROSS_MIN_CLASSES`` of detection classes equal."""
    cfg = MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(8, 16, 32, 64, 128), backbone="resnet18",
                         top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
                         pre_nms_limit=256, post_nms_rois_inference=64, num_classes=3, compute_dtype="float32",
                         detection_min_confidence=0.0, quant_classifier=True, quant_mask_head=True)
    rs = np.random.RandomState(SEED + 18)
    img = torch.from_numpy(np.stack([smooth_image(rs, 128, 128) for _ in range(2)]))
    meta = torch.zeros((2, cfg.meta_size))
    meta[:, 7:11] = torch.tensor([0.0, 0.0, 128.0, 128.0])
    state = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
    qcfg, qstate = quantize_for_inference(cfg, state, [(img, meta)], device="cpu")
    models, outs, sites = {}, {}, []
    for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
        m = MaskRCNN(qcfg, device=dev)
        m.load_state_dict(qstate)
        m.cast_for_serving_()
        seen = {}
        m.backbone.register_forward_hook(lambda mod, i, o: seen.update(ends=o))
        m.fpn.register_forward_hook(lambda mod, i, o: seen.update(pyramid=o[0]))
        if key == "cpu":
            for name, mod in m.named_modules():
                if isinstance(mod, quant._Int8Site):
                    mod.register_forward_hook(lambda mod, i, o, name=name: sites.append((name, i, o)))
        with torch.no_grad():
            out = m(img.to(dev), meta.to(dev))
        feats = [seen["ends"][f"C{i}"] for i in range(2, 6)] + list(seen["pyramid"])
        feats = [(f.q.float() * f.scale if isinstance(f, quant.QTensor) else f).cpu().double() for f in feats]
        models[key], outs[key] = m, ({k: v.cpu() for k, v in out.items()}, feats)
    to_card = lambda v: quant.QTensor(v.q.to(device), v.scale.to(device), v.dtype) if isinstance(v, quant.QTensor) \
        else v.to(device)
    with torch.no_grad():
        for name, inputs, want in sites:
            got = models["card"].get_submodule(name)(*(to_card(v) for v in inputs))
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"int8 site {name} on the card differs from the CPU on the CPU's input: "
                                     f"{int((got.cpu() != want).sum())} of {want.numel()} values")
    (gpu, gfeats), (cpu, cfeats) = outs["card"], outs["cpu"]
    rel = max(float((g - c).norm() / c.norm()) for g, c in zip(gfeats, cfeats))
    errs = {k: float((gpu[k] - cpu[k]).abs().max()) for k in ("rpn_logits", "mrcnn_probs")}
    classes = float((gpu["detections"][..., 4] == cpu["detections"][..., 4]).float().mean())
    log(f"  (d) tiny float32 int8 model (ResNet-18, 128x128, both head switches), card vs CPU with one calibration: "
        f"all {len(sites)} int8 site calls bit-equal on the CPU's inputs; end to end C2-C5 and P2-P6 within "
        f"{rel:.3g} relative L2, RPN logits {errs['rpn_logits']:.3g}, probabilities {errs['mrcnn_probs']:.3g}, "
        f"{classes:.2f} of detection classes equal (rounding flips spread; held: relative L2 <= {CROSS_MAX_REL_L2}, "
        f"classes >= {CROSS_MIN_CLASSES})")
    if not (rel <= CROSS_MAX_REL_L2 and classes >= CROSS_MIN_CLASSES):
        raise AssertionError(f"int8 card vs CPU: relative L2 {rel:.3g} (want <= {CROSS_MAX_REL_L2}), classes equal "
                             f"{classes:.3f} (want >= {CROSS_MIN_CLASSES})")


def tensor_core_instructions(name="int8_conv", kernel="int8_conv_mma_kernel"):
    """The int8 tensor-core instructions (``IGMMA`` from wgmma, or ``IMMA``
    from mma.sync) in the SASS of each instantiation of ``kernel`` in the
    built ``csrc/<name>.cu``, by ``cuobjdump --dump-sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(_build._target(name))], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1].strip()
            if kernel in function:
                counts[function] = 0
        elif function in counts and any(op in line for op in (" IGMMA", " IMMA")):
            counts[function] += 1
    return counts


def run_int8(device, card, requests, flush, root):
    """Phase 17 (see the module's docstring). Returns the calibrated ``(int8
    config, state_dict)`` and K7's kernels-line fields."""
    start_phase = time.perf_counter()
    sass = tensor_core_instructions()
    log(f"== int8 serving: cuobjdump --dump-sass of csrc/int8_conv.cu: int8 tensor-core instructions in each "
        f"instantiation of int8_conv_mma_kernel: {sorted(sass.values())} ({len(sass)} instantiations)")
    if not sass or min(sass.values()) == 0:
        raise AssertionError(f"the tensor-core kernel has no int8 tensor-core instruction in its SASS: {sass}")
    sass_imma = min(sass.values())
    cfg = flagship_config()
    state = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
    batches = list(request_batches(requests, cfg))
    t = time.perf_counter()
    qcfg, qstate = quantize_for_inference(cfg, state, batches, device=device)
    calib_s = time.perf_counter() - t
    amax = {k: float(v) for k, v in qstate.items() if quant.is_quant_buffer(k)}
    log(f"  (a) quantize_for_inference on the flagship over the 4 requests in {calib_s:.2f} s: "
        f"{len(amax)} amax entries, all > 0: {min(amax.values()) > 0}")
    if not min(amax.values()) > 0:
        raise AssertionError("a site's calibrated amax is 0")
    int8 = Predictor(qcfg, qstate, device=device)
    bf16 = Predictor(cfg, state, device=device)

    log("  (b) K7 (csrc/int8_conv.cu) vs int8_conv_plain, bit for bit in float32 and bf16, each launched twice; "
        "every site shape of one int8 request, timed at bf16 (L2 flushed before each launch)")
    calls = capture_int8(int8, requests[0])[0]
    if len(calls) != 65:
        raise AssertionError(f"one int8 request made {len(calls)} K7 calls; expected 65")
    totals, distinct = int8_site_table(calls, flush)
    hcfg = cfg.replace(quant_classifier=True, quant_mask_head=True)
    heads = int8_predictor(hcfg, state, batches, device)
    seen = {(tuple(a[0].shape), tuple(a[1].shape)) for a in calls}
    head_calls = [a for a in capture_int8(heads, requests[0])[0]
                  if (tuple(a[0].shape), tuple(a[1].shape)) not in seen]
    log("  the 6 head sites with quant_classifier and quant_mask_head:")
    head_totals, _ = int8_site_table(head_calls, flush)
    errs = [totals["max_abs_err"], head_totals["max_abs_err"]]
    gaps = [totals["relaunch_max_abs_diff"], head_totals["relaunch_max_abs_diff"]]
    for case in int8_cases(device):
        err, gap = hold_int8(*case)
        errs.append(err)
        gaps.append(gap)
        x, w = case[1], case[2]
        log(f"  {case[0]}: x {tuple(x.shape)}, w {tuple(w.shape)} ({plan_text(int8_kernel.int8_conv.last_plan)}): "
            "bit-equal in float32 and bf16, twice")
    del calls, head_calls
    bound = max(totals["bytes_ms"], totals["ops_ms"])
    log(f"  K7 a request of 2 images: {totals['ms']:.3f} ms over 65 launches ({distinct} shapes), bound "
        f"{bound:.4f} ms ({'operations' if totals['ops_ms'] >= totals['bytes_ms'] else 'bytes'}: ops "
        f"{totals['ops_ms']:.4f}, bytes {totals['bytes_ms']:.4f}), plain {totals['plain_ms']:.2f} ms, the bf16 cuDNN "
        f"convolutions of the same shapes {totals['cudnn_ms']:.3f} ms; its 1x1 stride-1 sites "
        f"{totals['pointwise_ms']:.3f} ms against torch._int_mm's {totals['pointwise_int_mm_ms']:.3f} ms; the heads' "
        f"FCs {head_totals['fc_ms']:.4f} ms against {head_totals['int_mm_ms']:.4f} ms ({card})")

    torch.cuda.synchronize()
    zero_launch_counts()
    int8_kernel.int8_conv.launches = 0
    int8_results = []
    for images in requests:
        before = launch_counts()[:2] + (int8_kernel.int8_conv.launches,)
        results = int8.detect(images)
        rose = tuple(a - b for a, b in zip(launch_counts()[:2] + (int8_kernel.int8_conv.launches,), before))
        if rose != (2, 2, 65):
            raise AssertionError(f"an int8 request launched (NMS, ROIAlign, K7) = {rose}; expected (2, 2, 65)")
        check_results(results, images, cfg)
        int8_results.append(results)
    launches = {"nms": nms_kernel.greedy_nms.launches, "roi_align": roi_kernel.roi_align.launches,
                "int8_conv": int8_kernel.int8_conv.launches}
    log(f"  (c) 4 int8 requests of 2 images: launches {launches}, (2, 2, 65) each; detections "
        f"{[[len(r['class_ids']) for r in rr] for rr in int8_results]}")

    before = int8_kernel.int8_conv.launches
    check_results(heads.detect(requests[1]), requests[1], cfg)
    heads_launches = int8_kernel.int8_conv.launches - before
    if heads_launches != 71:
        raise AssertionError(f"with both head switches a request launched K7 {heads_launches} times; expected 71")
    del heads
    # ResNeXt-50: 16 blocks x 3 convs + 4 downsamples, 8 FPN convs, 5 RPN levels; MobileNet V2: the expand
    # and project convs of its 17 blocks but the first's expand (depthwise sites stay in bf16), 8 + 5
    zoo_counts, zoo_ms, zoo_want = {}, {}, {"resnext50": 65, "mobilenetv2": 46}
    for name, want in zoo_want.items():
        zcfg = cfg.replace(backbone=name)
        zstate = lecun_init_(MaskRCNN(zcfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
        pred = int8_predictor(zcfg, zstate, batches[:1], device)
        zcalls, results, zoo_counts[name] = capture_int8(pred, requests[1])
        check_results(results, requests[1], zcfg)
        if zoo_counts[name] != want or len(zcalls) != want:
            raise AssertionError(f"an int8 request on {name} launched K7 {zoo_counts[name]} times; expected {want}")
        log(f"  {name}: {want} K7 launches a request; its site shapes:")
        ztotals, zdistinct = int8_site_table(zcalls, flush)
        zoo_ms[name] = ztotals["ms"]
        errs.append(ztotals["max_abs_err"])
        gaps.append(ztotals["relaunch_max_abs_diff"])
        log(f"  {name}: K7 {ztotals['ms']:.3f} ms a request of 2 images over {want} launches ({zdistinct} shapes), "
            f"bound {max(ztotals['bytes_ms'], ztotals['ops_ms']):.4f} ms, the bf16 cuDNN convolutions of the same "
            f"shapes {ztotals['cudnn_ms']:.3f} ms ({card})")
        del pred, zcalls
        torch.cuda.empty_cache()
    log(f"  K7 launches a request: {heads_launches} with quant_classifier and quant_mask_head; ResNeXt-50 "
        f"{zoo_counts['resnext50']}, MobileNet V2 {zoo_counts['mobilenetv2']} (depthwise sites in bf16); every "
        f"held shape {max(errs)} from the plain version, {max(gaps)} between two launches")

    bf16_results = [bf16.detect(images) for images in requests]
    shares = [top5_match(b, q) for bb, qq in zip(bf16_results, int8_results) for b, q in zip(bb, qq)]
    molded = torch.cat([m for m, _ in batches]).to(device)
    metas = torch.cat([m for _, m in batches]).to(device)
    times = {}
    for b in (2, 8):
        for name, pred in (("bf16", bf16), ("int8", int8)):
            times[(name, b)] = forward_ms(pred.model, molded[:b], metas[:b])
    log(f"  top-5 bf16 detections that int8 matches (same class, IoU >= 0.9), per image: "
        f"{[round(v, 2) for v in shares]}, mean {np.mean(shares):.3f} (held >= {TOP5_FLOOR})")
    if not np.mean(shares) >= TOP5_FLOOR:
        raise AssertionError(f"int8 matches {np.mean(shares):.3f} of bf16's top-5 detections; want >= {TOP5_FLOOR}")
    log(f"  forward (CUDA events, median of 10 after 3 warm-up): batch 2 bf16 {times[('bf16', 2)]:.2f} ms, int8 "
        f"{times[('int8', 2)]:.2f} ms; batch 8 bf16 {times[('bf16', 8)]:.2f} ms, int8 {times[('int8', 8)]:.2f} ms "
        f"({card})")
    del int8, bf16
    torch.cuda.empty_cache()

    int8_cross_check(device)

    rs = np.random.RandomState(SEED + 19)
    paths = []
    for i, hw in enumerate(((480, 640), (375, 500), (512, 384))):
        paths.append(os.path.join(root, f"int8_{i}.jpg"))
        image_io.imwrite(paths[-1], smooth_image(rs, *hw))
    printed = io.StringIO()
    before = int8_kernel.int8_conv.launches
    with contextlib.redirect_stdout(printed):
        results = cli_detect.main(["--images", *paths, "--int8", "--checkpoints_dir", os.path.join(root, "int8_cli"),
                                   "--out", os.path.join(root, "int8_out"), "--device", device.type])
    served = int8_kernel.int8_conv.launches - before
    for img_path, r in zip(paths, results):
        if not (np.all(np.isfinite(r["scores"])) and np.all(np.isfinite(r["rois"]))
                and os.path.getsize(os.path.join(root, "int8_out", os.path.basename(img_path)[:-4] + ".json"))):
            raise AssertionError(f"cli.detect --int8 on {img_path}: {r}")
    if len(results) != 3 or served != 3 * 65:
        raise AssertionError(f"cli.detect --int8 served {len(results)} images with {served} K7 launches; "
                             "expected 3 and 195")
    log(f"  (e) cli.detect --int8 on 3 JPEGs (random weights, no checkpoint; detection_min_confidence 0.7): "
        f"{[len(r['class_ids']) for r in results]} detections, finite, JSON written, K7 launched {served} times")
    log(f"== int8 phase done in {time.perf_counter() - start_phase:.1f} s")
    return (qcfg, qstate), dict(
        name="int8_conv", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/int8_conv.cu",
        replaces="maskrcnn_tf2_tpu/models/quant.py:76 (XLA's s8 conv_general_dilated; no Pallas counterpart)",
        launches=launches["int8_conv"], max_abs_err=max(errs), relaunch_max_abs_diff=max(gaps), ms=totals["ms"],
        plain_ms=totals["plain_ms"], bound_ms=bound, bound_by="operations" if totals["ops_ms"] >= totals["bytes_ms"] else "bytes",
        library_ms=totals["cudnn_ms"],
        library="bf16 cuDNN convolutions (F.conv2d) of the same shapes: no PyTorch call computes an int8 "
                "convolution on CUDA",
        fc_ms=head_totals["fc_ms"], fc_int_mm_ms=head_totals["int_mm_ms"], heads_ms=head_totals["ms"],
        pointwise_ms=totals["pointwise_ms"], pointwise_int_mm_ms=totals["pointwise_int_mm_ms"],
        tensor_core_sass=sass_imma,
        heads_library_ms=head_totals["cudnn_ms"],
        forward_ms={f"{name}_batch{b}": v for (name, b), v in times.items()},
        top5_match=float(np.mean(shares)), heads_launches=heads_launches, zoo_launches=zoo_counts,
        zoo_ms=zoo_ms,
    )


# ---------------------------------------------------------------------------
# serving engines and program export
# ---------------------------------------------------------------------------

# Floors of a flagship engine's agreement with eager serving of the same
# weights on the same batches. The engine keeps eager's roundings
# (``export/engine.py::_eager_numerics``), but its kernels sum in other
# orders, and with seeded random weights near-tied class scores and ranks
# can flip; a wiring fault (a dropped constant, a wrong stride) falls far
# below. Readings on an H100, bf16 and int8 alike: class ids equal on every
# slot of every request, mask pixels 1.000
ENGINE_MATCH_FLOOR = 0.7
ENGINE_MASK_FLOOR = 0.95

SERVE_ENGINE = """
import json, os, sys, time
import numpy as np, torch
from maskrcnn_tf2_tpu_torch.export.engine import load_engine
from maskrcnn_tf2_tpu_torch.kernels import _build, int8_conv, nms, roi_align

def listing():
    return sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir())

path, batches, out = sys.argv[1:4]
built = listing()
t = time.perf_counter()
engine = load_engine(path)
load_s = time.perf_counter() - t
data = np.load(batches)
counters = (nms.greedy_nms, roi_align.roi_align, int8_conv.int8_conv)
for fn in counters:
    fn.launches = 0
results, first_s = {}, None
for i in range(len(data.files) // 2):
    t = time.perf_counter()
    det, masks = engine(data[f"images{i}"], data[f"metas{i}"])
    first_s = first_s if first_s is not None else time.perf_counter() - t
    results[f"det{i}"], results[f"masks{i}"] = det, masks
launches = [fn.launches for fn in counters]
np.savez(out, **results)
cache = os.environ["TORCHINDUCTOR_CACHE_DIR"]
print(json.dumps({"load_s": load_s, "first_call_s": first_s, "launches": launches,
                  "build_dir_untouched": listing() == built,
                  "inductor_cache": sorted(os.listdir(cache)) if os.path.isdir(cache) else []}))
"""


def rewrite_engine(path, out, edit=None, trailing=b""):
    """``path`` with its metadata edited by ``edit`` and ``trailing`` bytes
    after the sections, under a header whose sha256 matches."""
    metadata, weights, package = engine_mod.read_engine(path)
    if edit is not None:
        edit(metadata)
    body = io.BytesIO()
    for section in (json.dumps(metadata).encode(), weights, package):
        engine_mod._write_section(body, section)
    blob = body.getvalue() + trailing
    with open(out, "wb") as f:
        f.write(engine_mod.MAGIC + b" " + hashlib.sha256(blob).hexdigest().encode() + b"\n" + blob)
    return out


def engine_gates(path, device, root):
    """18(d): each altered copy of the engine at ``path`` refused, with its error."""
    raw = bytearray(open(path, "rb").read())
    raw[raw.index(b"\n") + 100] ^= 0xFF
    flipped = os.path.join(root, "flipped.engine")
    open(flipped, "wb").write(bytes(raw))

    def edit(key, value):
        return lambda m: m.update({key: value})

    def foreign_kernel(m):
        m["kernels"]["roi_align"] = "0" * 64

    cases = [("a flipped byte", flipped, ValueError, "corrupt"),
             ("a trailing byte", rewrite_engine(path, os.path.join(root, "trailing.engine"), trailing=b"\0"),
              ValueError, "trailing bytes"),
             ("a foreign device name", rewrite_engine(path, os.path.join(root, "device.engine"),
                                                      edit("device_name", "NVIDIA A100-SXM4-80GB")),
              RuntimeError, "device .*rebuild"),
             ("a foreign torch version", rewrite_engine(path, os.path.join(root, "torch.engine"),
                                                        edit("torch_version", "2.0.0")),
              RuntimeError, "torch .*rebuild"),
             ("a foreign kernel digest", rewrite_engine(path, os.path.join(root, "kernel.engine"), foreign_kernel),
              RuntimeError, "csrc/roi_align.cu.*rebuild")]
    for what, bad, error, match in cases:
        try:
            load_engine(bad, device)
        except error as e:
            if not re.search(match, str(e)):
                raise AssertionError(f"an engine with {what} raised {e!r}, not /{match}/") from e
            log(f"  (d) {what}: {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"an engine with {what} loaded")


def engine_tiny(device, root):
    """18(a): the tiny float32 model's engine and program against eager on
    the card (TF32 off), within 1e-4 with equal class ids. Returns the
    engine's path."""
    cfg = tiny_config()
    state = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
    rs = np.random.RandomState(SEED + 20)
    img = torch.from_numpy(np.stack([smooth_image(rs, 128, 128) for _ in range(2)])).to(device)
    meta = torch.zeros((2, cfg.meta_size), device=device)
    meta[:, 7:11] = torch.tensor([0.0, 0.0, 128.0, 128.0])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.perf_counter()
        path = build_engine(cfg, state, os.path.join(root, "tiny.engine"), batch_size=2, device=device)
        build_s = time.perf_counter() - t
        program_path = export_program(cfg, state, os.path.join(root, "tiny.pt2"), batch_size=2, device=device)
        eager = MaskRCNN(cfg, device=device)
        eager.load_state_dict(state)
        eager.cast_for_serving_()
        engine = load_engine(path, device)
        program = load_program(program_path, device)
        with torch.no_grad():
            ref = eager(img, meta)
            before = launch_counts()[:2]
            det, masks = engine.run(img, meta)
            rose = tuple(a - b for a, b in zip(launch_counts()[:2], before))
            pdet, pmasks = program(img.float(), meta)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {"engine detections": (det, ref["detections"]), "engine masks": (masks, gather_class_masks(ref)),
            "program detections": (pdet, ref["detections"]), "program masks": (pmasks, ref["mrcnn_masks"])}
    errs = {k: float((a - b).abs().max()) for k, (a, b) in errs.items()}
    same = [bool(torch.equal(d[..., 4], ref["detections"][..., 4])) for d in (det, pdet)]
    valid = int((ref["detections"][..., 4] > 0).sum())
    log(f"  (a) tiny float32 model (ResNet-18, 128x128, batch 2): engine built in {build_s:.1f} s "
        f"({os.path.getsize(path) / 2**20:.1f} MiB), program {os.path.getsize(program_path) / 2**20:.1f} MiB; "
        f"against eager on the card (TF32 off): {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; class ids "
        f"equal (engine, program): {same} over {valid} valid detections; launches in the engine's call (NMS, "
        f"ROIAlign) {rose}")
    if not (max(errs.values()) <= 1e-4 and all(same) and valid > 0 and rose == (2, 2)):
        raise AssertionError(f"tiny engine/program vs eager: {errs}, classes equal {same}, valid {valid}, "
                             f"launches {rose} (want <= 1e-4, equal, > 0, (2, 2))")
    engine_tiny_int8(cfg, state, img, meta, device, root)
    return path


def engine_tiny_int8(cfg, state, img, meta, device, root):
    """18(a), int8: the tiny model calibrated on its batch, its engine against
    the live int8 model on the card (TF32 off). Two float32 implementations
    on the card round a few values another way, a quantization step flips and
    the flip spreads (as between card and CPU in phase 17(d)), so the engine
    is held at phase 17(d)'s class floor, with K7 launched as often as eager
    launches it; the share of eager's detections matched and the largest
    difference are printed."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        qcfg, qstate = quantize_for_inference(cfg, state, [(img, meta)], device=device)
        path = build_engine(qcfg, qstate, os.path.join(root, "tiny_int8.engine"), batch_size=2, device=device)
        live = MaskRCNN(qcfg, device=device)
        live.load_state_dict(qstate)
        live.cast_for_serving_()
        engine = load_engine(path, device)
        with torch.no_grad():
            before = int8_kernel.int8_conv.launches
            out = live(img, meta)
            eager_k7 = int8_kernel.int8_conv.launches - before
            det, masks = engine(img, meta)
            engine_k7 = int8_kernel.int8_conv.launches - before - eager_k7
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ref = out["detections"].cpu().numpy()
    stats = agreement(det, masks, ref, gather_class_masks(out).cpu().numpy())
    log(f"  (a) tiny int8 engine against the live int8 model on the card: class ids equal over all slots "
        f"{stats['all_slot_classes']:.3f} (held >= {CROSS_MIN_CLASSES}), eager's {stats['valid']} detections "
        f"matched {stats['matched']:.3f}, max |diff| {float(np.abs(det - ref).max()):.3g}; K7 launches engine "
        f"{engine_k7}, eager {eager_k7}")
    if not (stats["all_slot_classes"] >= CROSS_MIN_CLASSES and engine_k7 == eager_k7 > 0):
        raise AssertionError(f"tiny int8 engine vs live: classes equal {stats['all_slot_classes']:.3f} (want >= "
                             f"{CROSS_MIN_CLASSES}), K7 launches {engine_k7} against eager's {eager_k7}")


def agreement(det, masks, ref_det, ref_masks):
    """Of eager's valid detections (``ref_*``), the share the engine has too
    (a detection of the same class at IoU >= 0.9, or with every corner within
    1e-3: a box clipped to no area overlaps nothing, not even itself), the
    mask pixels of those pairs that agree at 0.5, and the share of equal
    class ids over all slots (phase 17(d)'s measure, which a rank flip
    moves)."""
    matched, pixels = 0, []
    for b in range(ref_det.shape[0]):
        got = det[b][det[b][:, 4] > 0]
        got_masks = masks[b][det[b][:, 4] > 0]
        for ref, ref_mask in zip(ref_det[b][ref_det[b][:, 4] > 0], ref_masks[b][ref_det[b][:, 4] > 0]):
            iou = box_iou(ref[None, :4].astype(np.float64), got[:, :4].astype(np.float64))[0]
            iou = np.where(np.abs(got[:, :4] - ref[:4]).max(axis=1) <= 1e-3, 1.0, iou)
            iou = np.where(got[:, 4] == ref[4], iou, 0.0)
            if iou.size and iou.max() >= 0.9:
                matched += 1
                pixels.append(((got_masks[int(iou.argmax())] > 0.5) == (ref_mask > 0.5)).mean())
    valid = int((ref_det[..., 4] > 0).sum())
    return dict(valid=valid, matched=matched / max(valid, 1), mask_pixels=float(np.mean(pixels)) if pixels else 0.0,
                all_slot_classes=float((det[..., 4] == ref_det[..., 4]).mean()))


def engine_flagship(name, cfg, state, predictor, batches, device, card, root):
    """18(b) and (c): build the flagship's engine at batch 2, serve the 4
    requests from a fresh process (load and first call timed; no build and
    no compile), hold the launches and the agreement with ``predictor``'s
    eager ``_forward``, and time both forwards. Returns the phase's numbers."""
    t = time.perf_counter()
    path = build_engine(cfg, state, os.path.join(root, f"{name}.engine"), batch_size=2, device=device)
    build_s = time.perf_counter() - t
    shutdown_compile_workers()  # the build's Triton compile processes
    data = os.path.join(root, f"{name}_batches.npz")
    np.savez(data, **{f"{k}{i}": v.numpy() for i, (m, me) in enumerate(batches)
                      for k, v in (("images", m), ("metas", me))})
    out = os.path.join(root, f"{name}_out.npz")
    env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=os.path.join(root, f"{name}_inductor_cache"),
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.abspath(__file__)),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", SERVE_ENGINE, path, data, out], capture_output=True, text=True,
                          env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"serving the {name} engine in a fresh process failed:\n{proc.stderr[-4000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    want = [8, 8, 260 if cfg.quant_mode == "int8" else 0]
    if sub["launches"] != want or not sub["build_dir_untouched"] or sub["inductor_cache"]:
        raise AssertionError(f"the {name} engine in a fresh process: launches (NMS, ROIAlign, K7) "
                             f"{sub['launches']} (want {want}), _build/ untouched {sub['build_dir_untouched']}, "
                             f"Inductor cache {sub['inductor_cache']} (want empty)")
    served = np.load(out)
    stats = []
    for i, (molded, metas) in enumerate(batches):
        ref_det, ref_masks = (t.float().cpu().numpy() for t in predictor._forward(molded.numpy(), metas.numpy()))
        stats.append(agreement(served[f"det{i}"], served[f"masks{i}"], ref_det, ref_masks))
    mean = {k: float(np.mean([s[k] for s in stats])) for k in stats[0]}
    engine = load_engine(path, device)
    images = torch.cat([m for m, _ in batches[:1]]).to(device)
    metas = torch.cat([m for _, m in batches[:1]]).to(device)
    times = {"engine": forward_ms(engine.run, images, metas), "eager": forward_ms(predictor.model, images, metas)}
    log(f"  ({'c' if cfg.quant_mode == 'int8' else 'b'}) {name} flagship engine (ResNet-50-FPN, 512x512, 81 classes, "
        f"batch 2): built in {build_s:.1f} s, {os.path.getsize(path) / 2**20:.1f} MiB; in a fresh process loaded in "
        f"{sub['load_s']:.2f} s, first call {sub['first_call_s'] * 1e3:.1f} ms, _build/ untouched, Inductor cache "
        f"empty; 4 requests: launches (NMS, ROIAlign, K7) {sub['launches']}; against eager per request (eager's "
        f"valid detections, the share the engine has too at the same class and IoU >= 0.9 or corners within "
        f"1e-3, their mask pixels equal at 0.5, class ids equal over all slots; held >= {ENGINE_MATCH_FLOOR}, "
        f"{ENGINE_MASK_FLOOR}, {CROSS_MIN_CLASSES}): "
        f"{[[s['valid'], round(s['matched'], 3), round(s['mask_pixels'], 4), round(s['all_slot_classes'], 3)] for s in stats]}")
    log(f"  {name} forward at batch 2 (CUDA events, median of 10 after 3 warm-up, uint8 images on the card): engine "
        f"{times['engine']:.2f} ms, eager {times['eager']:.2f} ms ({card})")
    floors = dict(matched=ENGINE_MATCH_FLOOR, mask_pixels=ENGINE_MASK_FLOOR, all_slot_classes=CROSS_MIN_CLASSES)
    low = {k: (mean[k], v) for k, v in floors.items() if not mean[k] >= v}
    if low:
        raise AssertionError(f"the {name} engine against eager, mean over the requests (measured, floor): {low}")
    del engine
    return dict(build_s=build_s, size_mib=os.path.getsize(path) / 2**20, load_s=sub["load_s"],
                first_call_ms=sub["first_call_s"] * 1e3, launches=sub["launches"], agreement=mean,
                engine_ms=times["engine"], eager_ms=times["eager"])


def run_engine(device, card, requests, int8_state, root):
    """Phase 18 (see the module's docstring). Returns the phase's numbers."""
    start_phase = time.perf_counter()
    log("== serving engines and program export (export/engine.py, export/serialize.py)")
    tiny_path = engine_tiny(device, root)
    cfg = flagship_config()
    state = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
    batches = list(request_batches(requests, cfg))
    bf16 = engine_flagship("bf16", cfg, state, Predictor(cfg, state, device=device), batches, device, card, root)
    torch.cuda.empty_cache()
    qcfg, qstate = int8_state
    int8 = engine_flagship("int8", qcfg, qstate, Predictor(qcfg, qstate, device=device), batches, device, card,
                           root)
    torch.cuda.empty_cache()
    engine_gates(tiny_path, device, root)
    log(f"== engine phase done in {time.perf_counter() - start_phase:.1f} s")
    return {"bf16": bf16, "int8": int8}


# ---------------------------------------------------------------------------
# tensor parallel and data-parallel serving
# ---------------------------------------------------------------------------

TP_SHARDS = 2


def tp_config() -> MaskRCNNConfig:
    """The flagship's training configuration with its classifier FCs split
    over two model ranks (1024 = 512 + 512)."""
    return flagship_train_config().replace(parallel_mode="gspmd", tp_shards=TP_SHARDS)


def group_all_reduce_ms(shape, group, device, reps=3):
    """Median ms of one float32 all-reduce of ``shape`` over ``group`` on the
    host clock (the card synchronized around each), after one warm-up."""
    t = torch.ones(shape, dtype=torch.float32, device=device)
    torch.distributed.all_reduce(t, group=group)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        torch.distributed.all_reduce(t, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


def tp_draws(cfg, mesh, step, device):
    """The global batch's draws of ``step``: each data rank's, drawn as its
    rank draws them (``step_generator`` by data rank), concatenated."""
    per = cfg.batch_size // mesh.n_data
    parts = [draw_uniforms(cfg, per, step_generator(SEED, step, r), device) for r in range(mesh.n_data)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def data_group_norm(x, weight, bias, eps, n_data):
    """``layers.BatchNorm._sync_forward``'s arithmetic in one process over
    ``n_data`` data ranks that each hold an equal block of ``x``'s rows
    (image-major, as the ranks split the global batch): each block's E[x]
    and E[x^2] in float32, summed and divided by ``n_data``, var = E[x^2] -
    E[x]^2. Returns the output in ``x``'s dtype, the mean and the variance."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    x32 = x.to(torch.float32)
    mean, mean2 = sum(torch.stack([b.mean(dims), (b * b).mean(dims)]) for b in x32.chunk(n_data)) / n_data
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    y = (x32 - mean.reshape(shape)) * (torch.rsqrt(var + eps) * weight).reshape(shape) + bias.reshape(shape)
    return y.to(x.dtype), mean, var


def data_group_batch_norms_(model, n_data):
    """Every batch norm of ``model`` in training computes ``data_group_norm``
    over ``n_data`` data ranks, as a gspmd step's batch norms do over its
    data group."""

    def forward(m, x):
        if not m.training:
            return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)
        y, mean, var = data_group_norm(x, m.weight, m.bias, m.eps, n_data)
        with torch.no_grad():
            m.running_mean.mul_(layers.FLAX_MOMENTUM).add_(mean * m.momentum)
            m.running_var.mul_(layers.FLAX_MOMENTUM).add_(var * m.momentum)
        return y

    for m in model.modules():
        if isinstance(m, layers.BatchNorm):
            m.forward = functools.partial(forward, m)


def split_head_forward(head, k, n_data=1):
    """``head``'s forward with the tensor-parallel head's arithmetic in one
    process: FC1 and its batch norm as ``k`` blocks of output features, each
    block's FC2 partial product in float32, the partials summed in order and
    FC2's bias added once before the one rounding to the compute dtype; with
    ``n_data`` > 1 the blocks' batch norms take ``data_group_norm``'s
    statistics. The whole parameters stay the model's, so the update
    compares leaf by leaf with the gathered one."""
    fc1, bn1, fc2 = head.mrcnn_class_conv1, head.mrcnn_class_bn1, head.mrcnn_class_conv2

    def block_batch_norm(h, rows):
        if not bn1.training:
            return F.batch_norm(h, bn1.running_mean[rows], bn1.running_var[rows], bn1.weight[rows], bn1.bias[rows],
                                False, 0.0, bn1.eps)
        if n_data > 1:
            y, mean, var = data_group_norm(h, bn1.weight[rows], bn1.bias[rows], bn1.eps, n_data)
            with torch.no_grad():
                bn1.running_mean[rows] = bn1.running_mean[rows] * layers.FLAX_MOMENTUM + mean * bn1.momentum
                bn1.running_var[rows] = bn1.running_var[rows] * layers.FLAX_MOMENTUM + var * bn1.momentum
            return y
        mean, var = torch.zeros_like(bn1.running_mean[rows]), torch.ones_like(bn1.running_var[rows])
        y = F.batch_norm(h, mean, var, bn1.weight[rows], bn1.bias[rows], True, 1.0, bn1.eps)
        n = h.numel() // h.shape[1]
        with torch.no_grad():  # as layers.BatchNorm updates its running statistics
            bn1.running_mean[rows] = bn1.running_mean[rows] * layers.FLAX_MOMENTUM + mean * bn1.momentum
            bn1.running_var[rows] = bn1.running_var[rows] * layers.FLAX_MOMENTUM + var * ((n - 1) / n) * bn1.momentum
        return y

    def forward(roi_features):
        b, n = roi_features.shape[:2]
        x = roi_features.reshape(b * n, -1)
        dtype, f, total = x.dtype, fc1.weight.shape[0] // k, None
        for m in range(k):
            rows = slice(m * f, (m + 1) * f)
            h = head.act(block_batch_norm(F.linear(x, fc1.weight[rows].to(dtype), fc1.bias[rows].to(dtype)), rows))
            part = F.linear(h.to(torch.float32), fc2.weight[:, rows].to(dtype).to(torch.float32))
            total = part if total is None else total + part
        x = head.act(head.mrcnn_class_bn2((total + fc2.bias).to(dtype)))
        logits = head.mrcnn_class_logits(x).reshape(b, n, head.num_classes).to(torch.float32)
        deltas = head.mrcnn_bbox_fc(x).reshape(b, n, head.num_classes, 4).to(torch.float32)
        return logits, torch.softmax(logits, dim=-1), deltas

    return forward


def tp_emulate(cfg, device, batch, draws, n_data=1):
    """One process's ``make_train_step`` on the seeded state, a global batch
    and its draws, the classifier computing the split head's arithmetic
    (``split_head_forward``) and, with ``n_data`` > 1, every batch norm the
    arithmetic of a data group of ``n_data`` ranks (``data_group_norm``):
    the state dict after the step, the parameters' names, their first
    adamax moments and the losses."""
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
    if n_data > 1:
        data_group_batch_norms_(state.model, n_data)
    head = state.model.classifier
    head.forward = split_head_forward(head, TP_SHARDS, n_data)
    names = [n for n, _ in state.model.named_parameters()]
    state, losses = make_train_step(cfg)(state, batch, draws=draws)
    return (state.model.state_dict(), names, dict(zip(names, state.opt_state.slots["mu"])),
            {k: float(v) for k, v in losses.items()})


def stat_errors(sd, whole_sd):
    """Of every batch norm's running mean and variance: the largest
    difference, and the largest in units of 1e-5 * max(1, |stat|) (each
    tensor's own)."""
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    errs = {k: float((sd[k] - whole_sd[k]).abs().max()) for k in stats}
    budgets = {k: errs[k] / (1e-5 * max(1.0, float(sd[k].abs().max()))) for k in stats}
    worst = max(budgets, key=budgets.get)
    return max(errs.values()), worst, budgets[worst]


def tp_hold_update(cfg, device, batch, draws, whole_sd, whole_mu):
    """The first gspmd step's whole update against ``tp_emulate``'s, by
    phase 16's rule: each first adamax moment within 1e-4 * (max |emulated
    leaf| + the step's largest |emulated moment|), the parameters within
    1e-3 * lr where |g| >= 1e-4, the running statistics within 1e-5 of
    max(1, |stat|)."""
    sd, names, mu, _ = tp_emulate(cfg, device, batch, draws)
    mu_max = max(float(m.abs().max()) for m in mu.values())
    lr = cfg.learning_rate
    mu_err, err_big, mu_equal, equal, over = 0.0, 0.0, 0, 0, []
    for i, name in enumerate(names):
        m, q = mu[name], whole_mu[i]
        d = float((m - q).abs().max())
        budget = 1e-4 * (float(m.abs().max()) + mu_max)
        if not d <= budget:
            over.append(f"{name} {d:.3g} ({d / budget:.2f} budgets)")
        mu_err, mu_equal = max(mu_err, d), mu_equal + int(bool(torch.equal(m, q)))
        diff = (sd[name] - whole_sd[name]).abs()
        big = (m / 0.1).abs() >= 1e-4
        if bool(big.any()):
            err_big = max(err_big, float(diff[big].max()))
        equal += int(bool(torch.equal(sd[name], whole_sd[name])))
    stat_err, worst, stat_budgets = stat_errors(sd, whole_sd)
    if over or err_big > 1e-3 * lr or stat_budgets > 1:
        raise AssertionError(f"gspmd vs one process: first moments off {over}; parameters {err_big} where "
                             f"|grad| >= 1e-4 (lr {lr}), statistics {stat_err} ({worst}: {stat_budgets:.2f} budgets)")
    return dict(mu_err=mu_err, mu_max=mu_max, mu_equal=mu_equal, err_big=err_big, equal=equal, n=len(names),
                stat_err=stat_err)


def tp_hold_forward(cfg, device, batch, draws, whole_sd, losses, n_data):
    """What the forward of the first gspmd step alone computes, against
    ``tp_emulate``'s with the data group's arithmetic: each loss within
    1e-5 * max(1, |loss|), and every batch norm's running mean and variance
    after the step within 1e-5 of max(1, |stat|). On batch statistics over
    the data group these are the values a wrong data group or a wrong count
    would move; the backward's amplification at random weights does not
    reach them."""
    sd, _, _, want = tp_emulate(cfg, device, batch, draws, n_data)
    loss_err = {k: abs(losses[k] - v) / max(1.0, abs(v)) for k, v in want.items()}
    stat_err, worst, stat_budgets = stat_errors(sd, whole_sd)
    if max(loss_err.values()) > 1e-5 or stat_budgets > 1:
        raise AssertionError(f"gspmd vs one process on batch statistics: losses (gspmd, one process) "
                             f"{[(k, losses[k], want[k]) for k in want]}, relative {loss_err}; statistics "
                             f"{stat_err} ({worst}: {stat_budgets:.2f} budgets)")
    return dict(loss_err=max(loss_err.values()), stat_err=stat_err, stat_budgets=stat_budgets, worst=worst,
                losses=len(want))


def tp_steps(rank, cfg, device, mesh, steps, calls=None, hold=False):
    """Phase 19(a)/(b) on one rank: ``steps`` gspmd steps of the flagship
    from the seed on the rank's rows of a synthetic global batch of 2. After
    every step: launches exactly (1, 2, 2) on this rank, finite losses, the
    replicated leaves bit-identical over the world and each shard over its
    data group (``check_replicated``), and FC1's input (the pooled ROI
    features) bit-identical over the model group. With ``calls`` the first
    step records the kernel wrappers' inputs; with ``hold`` rank 0 holds the
    first update against one process (``tp_emulate``)."""
    gbatch = synthetic_batch(cfg, cfg.batch_size, SEED + 16, device)
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
    step, state = gspmd.make_gspmd_train_step(cfg, mesh, state)
    batch = gspmd.shard_global_batch(gbatch, mesh, cfg)
    head = state.model.classifier
    shapes = (tuple(head.mrcnn_class_conv1.weight.shape), tuple(head.mrcnn_class_conv2.weight.shape))
    fc, pooled = cfg.fpn_cls_fc_layers_size, cfg.pool_size ** 2 * cfg.top_down_pyramid_size
    if shapes != ((fc // TP_SHARDS, pooled), (fc, fc // TP_SHARDS)):
        raise AssertionError(f"rank {rank}: FC shard shapes {shapes}")
    fc1_in = []
    hook = head.mrcnn_class_conv1.register_forward_pre_hook(lambda mod, args: fc1_in.append(tensor_checksum(args[0])))
    zero_launch_counts()
    times, first = [], None
    try:
        for i in range(steps):
            before = launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            with recorded_wrappers(calls) if calls is not None and i == 0 else contextlib.nullcontext():
                state, losses = step(state, batch, rng=step_generator(SEED, i, mesh.data_rank))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            rose = tuple(a - b for a, b in zip(launch_counts(), before))
            values = {k: float(v) for k, v in losses.items()}
            if rose != (1, 2, 2) or not all(np.isfinite(v) for v in values.values()) or values["grad_finite"] != 1:
                raise AssertionError(f"rank {rank} gspmd step {i}: launches {rose}, losses {values}")
            check_replicated(state.model, None, f"the state after gspmd step {i}", mesh=mesh)
            check_equal(fc1_in[-1], mesh.model_group, f"FC1's input in step {i}")
            if i == 0 and hold:  # copies: the replicated entries are the live model's tensors
                sd, slots = gspmd.gather_state_dict(state, mesh)
                first = ({k: v.clone() for k, v in sd.items()}, {"mu": [t.clone() for t in slots["mu"]]})
    finally:
        hook.remove()
    out = dict(times=times, loss=values["loss_sum"], launches=launch_counts(), shapes=shapes)
    if hold and rank == 0:
        del state
        out["emulation"] = tp_hold_update(cfg, device, gbatch, tp_draws(cfg, mesh, 0, device), first[0],
                                          first[1]["mu"])
    return out


def tp_first_step(rank, cfg, device, mesh, forward_only=False):
    """Phase 19(b)'s holds of a float32 gspmd step (TF32 off) from the seed,
    gathered whole, on rank 0 against one process. With the batch norms on
    their running averages (``cfg``'s ``train_bn`` off) the whole update is
    held (``tp_hold_update``): the two differ by summation order alone. On
    batch statistics over the data group the ranks sum each statistic in
    another order than one process does, and at random weights the
    backbone's gradients amplify a float32 rounding of the statistics past
    the update's rule (as ``tests/test_torch_port_gspmd.py`` finds on the
    CPU), so ``forward_only`` holds the losses and the statistics
    (``tp_hold_forward``)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gbatch = synthetic_batch(cfg, cfg.batch_size, SEED + 16, device)
        state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
        step, state = gspmd.make_gspmd_train_step(cfg, mesh, state)
        state, losses = step(state, gspmd.shard_global_batch(gbatch, mesh, cfg),
                             rng=step_generator(SEED, 0, mesh.data_rank))
        whole_sd, slots = gspmd.gather_state_dict(state, mesh)
        del state
        if rank != 0:
            return None
        draws = tp_draws(cfg, mesh, 0, device)
        if forward_only:
            return tp_hold_forward(cfg, device, gbatch, draws, whole_sd, {k: float(v) for k, v in losses.items()},
                                   mesh.n_data)
        return tp_hold_update(cfg, device, gbatch, draws, whole_sd, slots["mu"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def tp_train_model(rank, device, root):
    """Phase 19(c) on one rank: ``train_model`` in gspmd mode under the two
    ranks on phase 10's COCO directory, 1 epoch of 3 steps with validation:
    launches exact, rank 0 alone writes, and the checkpoint is whole."""
    train, val = CocoDataset(), CocoDataset()
    train.load_coco(os.path.join(root, "coco"), "train")
    val.load_coco(os.path.join(root, "coco"), "val")
    train.prepare()
    val.prepare()
    cfg = tp_train_model_config(train, root)
    writes = []
    save = ckpt_lib.CheckpointManager.save

    def counted_save(self, step, *args):
        writes.append(step)
        return save(self, step, *args)

    history = []
    with mock.patch.object(ckpt_lib.CheckpointManager, "save", counted_save):
        zero_launch_counts()
        state = train_model(cfg, train, val, steps_per_epoch=3, rng_seed=SEED, device=device, history=history,
                            checkpoint_base=os.path.join(root, "tp_main"))
        launches = launch_counts()
    eval_steps = len(val) // cfg.batch_size
    want = (3 + eval_steps, 6 + 2 * eval_steps, 6)
    if state.step != 3 or launches != want or not all(np.isfinite(v) for k, v in history[0].items() if "loss" in k):
        raise AssertionError(f"rank {rank}: gspmd train_model step {state.step}, launches {launches} (want {want}), "
                             f"{history}")
    if writes != ([0] if rank == 0 else []) or gspmd.mesh_of(state.model).n_model != TP_SHARDS:
        raise AssertionError(f"rank {rank}: checkpoint writes {writes}")
    return dict(launches=launches, val_loss=history[0]["val_loss_sum"], eval_steps=eval_steps)


def tp_train_model_config(train, root):
    return tp_config().replace(num_classes=train.num_classes, epochs=1, log_per_steps=1,
                               sample_cache_dir=os.path.join(root, "tp_cache"),
                               checkpoints_dir=os.path.join(root, "tp_ckpt"))


def tp_rank(rank, size, init_method, root, n_data, steps):
    """Phase 19(a) and (c) (``n_data`` 1) or (b) (``n_data`` 2) on one of the
    gloo ranks that share the card."""
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    distributed.initialize("gloo", rank, size, init_method, timeout_s=300, device=device)
    mesh = make_mesh_2d(n_data, TP_SHARDS)
    start = time.perf_counter()
    cfg = tp_config()
    calls = {"nms": [], "roi_align": [], "roi_align_backward": []} if rank == 0 and n_data == 1 else None
    out = dict(rank=rank, coords=(mesh.data_rank, mesh.model_rank))
    out["steps"] = tp_steps(rank, cfg, device, mesh, steps, calls, hold=n_data == 1)
    torch.cuda.empty_cache()
    if n_data > 1:
        f32 = cfg.replace(compute_dtype="float32")
        out["steps"]["emulation"] = tp_first_step(rank, f32.replace(train_bn=False, train_bn_backbone=False),
                                                  device, mesh)
        torch.cuda.empty_cache()
        out["steps"]["batch_statistics"] = tp_first_step(rank, f32, device, mesh, forward_only=True)
    rows = cfg.batch_size // n_data * cfg.train_rois_per_image
    shapes = {"fc2_partial": (rows, cfg.fpn_cls_fc_layers_size),
              "fc1_input_cotangent": (rows, cfg.pool_size ** 2 * cfg.top_down_pyramid_size)}
    out["all_reduce"] = {k: (int(np.prod(v)) * 4, group_all_reduce_ms(v, mesh.model_group, device))
                         for k, v in shapes.items()}
    if calls is not None:
        out["holds"] = hold_dp_calls(calls, device, f"tensor-parallel inputs (rank 0 of DP1xTP{TP_SHARDS})")
    del calls
    torch.cuda.empty_cache()
    if n_data == 1:
        out["train_model"] = tp_train_model(rank, device, root)
    out["seconds"] = time.perf_counter() - start
    return out


def single_step_ms(device, steps=3):
    """Median ms of the flagship's single-process training step (steps 2 on)."""
    cfg = flagship_train_config()
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
    step, batch, times = make_train_step(cfg), synthetic_batch(cfg, 2, SEED + 16, device), []
    for i in range(steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, _ = step(state, batch, rng=step_generator(SEED, i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times[1:]))


def serve_one_from_checkpoint(device, root, requests):
    """Phase 19(c), after the ranks: their whole checkpoint restored into one
    process's state, served through ``Predictor`` (2/2 launches)."""
    train = CocoDataset()
    train.load_coco(os.path.join(root, "coco"), "train")
    train.prepare()
    cfg = tp_train_model_config(train, root)
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED + 1), device=device)
    manager = ckpt_lib.make_manager(cfg, os.path.join(root, "tp_main"))
    state, start, _ = ckpt_lib.restore(manager, state)
    head = state.model.classifier
    if start != 1 or state.step != 3 or head.tp is not None or \
            tuple(head.mrcnn_class_conv1.weight.shape) != (cfg.fpn_cls_fc_layers_size, 12544):
        raise AssertionError(f"the gspmd checkpoint in one process: epoch {start}, step {state.step}, FC1 "
                             f"{tuple(head.mrcnn_class_conv1.weight.shape)}")
    predictor = Predictor(cfg.replace(detection_min_confidence=0.0), state.model.state_dict(), device=device)
    zero_launch_counts()
    results = predictor.detect(requests[0])
    check_results(results, requests[0], cfg)
    if launch_counts()[:2] != (2, 2):
        raise AssertionError(f"serving the restored checkpoint launched {launch_counts()}")
    return [len(r["class_ids"]) for r in results]


def host_forward_ms(fn, reps=5):
    """Median ms of ``fn()`` on the host clock, the card synchronized around
    each, after 2 warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


def dp_serving(device, card, requests, int8_state):
    """Phase 19(d): ``Predictor(data_parallel=True)`` with two replicas on
    the card against the single predictor; ``detect_stream`` through it;
    one int8 request."""
    cfg = flagship_config()
    sd = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
    single = Predictor(cfg, sd, device=device)
    dp = Predictor(cfg, sd, data_parallel=True, devices=["cuda:0", "cuda:0"])
    if dp.num_devices != 2:
        raise AssertionError(f"the data-parallel predictor has {dp.num_devices} replicas")
    batches = [(m.numpy(), me.numpy()) for m, me in request_batches(requests, cfg)]
    stats, per_request = [], []
    zero_launch_counts()
    with torch.no_grad():
        for molded, metas in batches:
            before = launch_counts()
            det, masks = (t.float().cpu().numpy() for t in dp._forward(molded, metas))
            per_request.append(tuple(a - b for a, b in zip(launch_counts(), before))[:2])
            # the single predictor on each replica's rows: cuDNN picks its algorithms by batch size, and
            # at seeded random weights a bf16 rounding reorders near-tied detections
            ref = [single._forward(molded[i:i + 1], metas[i:i + 1]) for i in range(len(molded))]
            ref_det, ref_masks = (torch.cat([r[k] for r in ref]).float().cpu().numpy() for k in range(2))
            stats.append(agreement(det, masks, ref_det, ref_masks))
    if any(p != (4, 4) for p in per_request):
        raise AssertionError(f"(NMS, ROIAlign) launches a request of 2 replicas: {per_request}; want (4, 4)")
    mean = {k: float(np.mean([s[k] for s in stats])) for k in stats[0]}
    if not (mean["matched"] >= ENGINE_MATCH_FLOOR and mean["all_slot_classes"] >= CROSS_MIN_CLASSES):
        raise AssertionError(f"the data-parallel predictor against the single one: {mean}")
    images = [im for req in requests for im in req]
    k8.paste_masks.launches = 0
    stream = list(dp.detect_stream(iter(images), batch_size=2))
    want = [r for req in requests for r in dp.detect(req)]
    if k8.paste_masks.launches != 2 * len(requests):
        raise AssertionError(f"{2 * len(requests)} batches through the data-parallel predictor launched K8 "
                             f"{k8.paste_masks.launches} times; want 1 a batch")
    for a, b in zip(stream, want):
        if not (np.array_equal(a["class_ids"], b["class_ids"]) and np.allclose(a["rois"], b["rois"], atol=1e-4)
                and np.allclose(a["scores"], b["scores"], atol=1e-4)):
            raise AssertionError("detect_stream through the data-parallel predictor differs from detect")
    if len(stream) != len(images):
        raise AssertionError(f"detect_stream returned {len(stream)} results for {len(images)} images")
    molded, metas = batches[0]
    ms = {"dp": host_forward_ms(lambda: dp._forward(molded, metas)),
          "single": host_forward_ms(lambda: single._forward(molded, metas))}
    del single, dp
    qcfg, qstate = int8_state
    dpq = Predictor(qcfg, qstate, data_parallel=True, devices=["cuda:0", "cuda:0"])
    zero_launch_counts()
    int8_kernel.int8_conv.launches = 0
    check_results(dpq.detect(requests[0]), requests[0], qcfg)
    int8_launches = launch_counts()[:2] + (int8_kernel.int8_conv.launches,)
    if int8_launches != (4, 4, 130):
        raise AssertionError(f"one int8 request through 2 replicas launched (NMS, ROIAlign, K7) {int8_launches}; "
                             f"want (4, 4, 130)")
    log(f"  (d) Predictor(data_parallel=True, devices=['cuda:0', 'cuda:0']), replicas sharing one card (no scaling "
        f"number): 4 requests of 2 images, (NMS, ROIAlign) launches {per_request[0]} a request (2, 2 a replica), "
        f"against the single predictor on each replica's rows, per request (its valid detections, the share "
        f"matched at the same class and IoU >= 0.9, class ids equal over all slots; held >= "
        f"{ENGINE_MATCH_FLOOR}, {CROSS_MIN_CLASSES}): "
        f"{[[s['valid'], round(s['matched'], 3), round(s['all_slot_classes'], 3)] for s in stats]}; "
        f"detect_stream equal to detect over {len(images)} images; one int8 request: (NMS, ROIAlign, K7) "
        f"{int8_launches} (65 K7 a replica)")
    log(f"  (d) forward of a request of 2 images (host clock, median of 5): data-parallel predictor "
        f"{ms['dp']:.2f} ms, single {ms['single']:.2f} ms, replicas sharing one card: no scaling number ({card})")
    return dict(launches=(4 * per_request[0][0], 4 * per_request[0][1]), int8=int8_launches, ms=ms, agreement=mean)


def run_tensor_parallel(device, card, root, requests, int8_state):
    """Phase 19 (see the module's docstring). Returns the phase's launches
    and times for the kernels' line."""
    start_phase = time.perf_counter()
    log("== tensor parallel and data-parallel serving (parallel/gspmd.py, Predictor(data_parallel=True)): gloo "
        "ranks and replicas sharing one card")
    single_ms = single_step_ms(device)
    torch.cuda.empty_cache()
    one = multihost_dryrun.launch(tp_rank, TP_SHARDS, (root, 1, 3), timeout_s=600, num_threads=4)
    two = multihost_dryrun.launch(tp_rank, 2 * TP_SHARDS, (root, 2, 2), timeout_s=600, num_threads=2)
    for name, out in (("DP1xTP2", one), ("DP2xTP2", two)):
        st = [o["steps"] for o in out]
        e = st[0]["emulation"]
        if len({s["loss"] for s in st}) != 1:
            raise AssertionError(f"{name}: the ranks' losses differ: {[s['loss'] for s in st]}")
        ar = out[0]["all_reduce"]
        log(f"  ({'a' if name == 'DP1xTP2' else 'b'}) {name}, ranks sharing one card (no scaling number): "
            f"{len(st[0]['times'])} steps on each of {len(out)} ranks, launches (1, 2, 2) a step on each, FC shards "
            f"{st[0]['shapes']}, replicated leaves bit-identical over the world and shards over their data group "
            f"after every step, FC1's input bit-identical over each model group; the first update "
            f"{'of the first step' if name == 'DP1xTP2' else 'of a float32 step on running averages (TF32 off)'} "
            f"gathered against one process's make_train_step with the split head's arithmetic: moments within "
            f"{e['mu_err']:.3g} (held per leaf <= 1e-4 (leaf max + "
            f"step max {e['mu_max']:.3g})), {e['mu_equal']} of {e['n']} bit-equal; parameters within "
            f"{e['err_big']:.3g} where |grad| >= 1e-4 (held <= 1e-3 lr), {e['equal']} of {e['n']} bit-equal; "
            f"statistics {e['stat_err']:.3g}")
        if "batch_statistics" in st[0]:
            f = st[0]["batch_statistics"]
            log(f"  (b) {name}, a float32 step on batch statistics over the data group (TF32 off) against one "
                f"process: its {f['losses']} losses within {f['loss_err']:.3g} relative (held <= 1e-5 of max(1, "
                f"|loss|)); every running mean and variance within {f['stat_err']:.3g}, at most "
                f"{f['stat_budgets']:.3f} of its budget 1e-5 max(1, |stat|) ({f['worst']})")
        log(f"  ({'a' if name == 'DP1xTP2' else 'b'}) {name} step ms by rank "
            f"{[[round(t, 1) for t in s['times']] for s in st]}; single-process step in this call {single_ms:.1f} "
            f"ms; model-group all-reduces a step (float32, ranks sharing one card): FC2's partial output "
            f"{ar['fc2_partial'][0] / 2**20:.2f} MiB {ar['fc2_partial'][1]:.2f} ms, FC1's input cotangent "
            f"{ar['fc1_input_cotangent'][0] / 2**20:.2f} MiB {ar['fc1_input_cotangent'][1]:.2f} ms ({card})")
    tm = [o["train_model"] for o in one]
    served = serve_one_from_checkpoint(device, root, requests)
    log(f"  (c) train_model in gspmd mode under DP1xTP2 on phase 10's COCO directory: 1 epoch of 3 steps and "
        f"{tm[0]['eval_steps']} eval steps, launches {tm[0]['launches']} on each rank, val_loss_sum "
        f"{tm[0]['val_loss']:.4f}, rank 0 alone wrote the whole checkpoint; restored into one process and served "
        f"one request: detections {served}, launches (2, 2)")
    torch.cuda.empty_cache()
    dp = dp_serving(device, card, requests, int8_state)
    log(f"  the ranks' processes took {max(o['seconds'] for o in one):.1f} s (DP1xTP2) and "
        f"{max(o['seconds'] for o in two):.1f} s (DP2xTP2)")
    log(f"== tensor parallel phase done in {time.perf_counter() - start_phase:.1f} s")
    holds = one[0]["holds"]
    names = ("nms", "roi_align", "roi_align_backward")
    out = {name: dict(tensor_parallel_launches=n, tensor_parallel_train_model_launches=m,
                      tensor_parallel_ms=holds[name]["ms"], tensor_parallel_bound_ms=holds[name]["bound_ms"])
           for name, n, m in zip(names, one[0]["steps"]["launches"], tm[0]["launches"])}
    for name, n in zip(names[:2], dp["launches"]):
        out[name]["data_parallel_serving_launches"] = n
    out["int8_conv"] = dict(data_parallel_serving_launches=dp["int8"][2])
    return out


# ---------------------------------------------------------------------------
# the last modules: the C RLE decoder, auto_download, profiling, box helpers
# ---------------------------------------------------------------------------

CROWD_RUNS = (60, 2000, 20000)  # runs in each crowd-style 480x640 mask


def encode_counts(counts):
    """COCO's compressed counts string of run lengths (pycocotools'
    rleToString): runs past the third delta-coded against counts[i - 2],
    then base-48 6-bit varints, bit 5 the continuation bit."""
    s = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            s.append(chr((c | 0x20 if more else c) + 48))
    return "".join(s)


def runs_to_mask(counts, h, w):
    """The mask of run lengths that cover ``h * w`` exactly, by ``np.repeat``:
    neither decoder under test."""
    flat = np.repeat(np.arange(len(counts)) % 2, counts).astype(bool)
    if flat.size != h * w:
        raise AssertionError(f"runs cover {flat.size} pixels of {h * w}")
    return flat.reshape(w, h).T


def crowd_mask(rs, h, w, runs):
    """Run lengths of exactly ``runs`` runs over ``h * w`` (the first a 0-run),
    as a crowd annotation's RLE has, and their mask."""
    cuts = np.sort(rs.choice(np.arange(1, h * w), runs - 1, replace=False))
    counts = np.diff(np.concatenate([[0], cuts, [h * w]])).tolist()
    return counts, runs_to_mask(counts, h, w)


def rle_directory(src, dst, rs):
    """Phase 10's COCO directory copied to ``dst`` with every instance's counts
    compressed to a string, plus one 480x640 training image for each of
    ``CROWD_RUNS`` holding a crowd annotation of that many runs and a
    rectangle instance. Returns ``{(subset, annotation id): source mask}``
    and the crowd masks' run lengths."""
    shutil.copytree(src, dst)
    sources, crowds = {}, {}
    for subset in ("train", "val"):
        path = os.path.join(dst, "annotations", f"instances_{subset}2017.json")
        with open(path) as f:
            data = json.load(f)
        sizes = {im["id"]: (im["height"], im["width"]) for im in data["images"]}
        for ann in data["annotations"]:
            h, w = sizes[ann["image_id"]]
            sources[(subset, ann["id"])] = runs_to_mask(ann["segmentation"]["counts"], h, w)
            ann["segmentation"]["counts"] = encode_counts(ann["segmentation"]["counts"])
        if subset == "train":
            for runs in CROWD_RUNS:
                image_id, h, w = max(sizes) + 1, 480, 640
                sizes[image_id] = (h, w)
                name = f"crowd_{runs}.jpg"
                image_io.imwrite(os.path.join(dst, "train2017", name), smooth_image(rs, h, w), 95)
                data["images"].append({"id": image_id, "file_name": name, "width": w, "height": h})
                counts, mask = crowd_mask(rs, h, w, runs)
                crowd = {"id": len(data["annotations"]) + 1, "image_id": image_id, "category_id": 1, "iscrowd": 1,
                         "segmentation": {"counts": encode_counts(counts), "size": [h, w]},
                         "area": int(mask.sum()), "bbox": [0, 0, w, h]}
                box = {"id": len(data["annotations"]) + 2, "image_id": image_id, "category_id": 2, "iscrowd": 0,
                       "segmentation": [[40.0, 30.0, 200.0, 30.0, 200.0, 150.0, 40.0, 150.0]],
                       "area": 160 * 120, "bbox": [40, 30, 160, 120]}
                data["annotations"] += [crowd, box]
                sources[(subset, crowd["id"])] = mask
                crowds[runs] = (crowd["segmentation"], h, w)
        with open(path, "w") as f:
            json.dump(data, f)
    return sources, crowds


def per_call_ms(fn, reps):
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


def loader_pass(ds, cfg):
    """One epoch of the loader's 4 threads: its images/s and its batches."""
    start = time.perf_counter()
    batches = list(DataLoader(ds, cfg).epoch(num_workers=4))
    return sum(len(b["images"]) for b in batches) / (time.perf_counter() - start), batches


def tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def check_rle_decoder(card, root, loop_cfg):
    """Phase 20(a): the C decoder against numpy and the source masks on the
    re-encoded directory, their ms a mask and the loader's images/s under
    each; then auto_download through file:// zips of that directory."""
    rs = np.random.RandomState(SEED + 20)
    dst = os.path.join(root, "coco_rle")
    sources, crowds = rle_directory(os.path.join(root, "coco"), dst, rs)
    n = 0
    for subset in ("train", "val"):
        ds = CocoDataset()
        ds.load_coco(dst, subset)
        for info in ds.image_info:
            for ann in info["annotations"]:
                if not isinstance(ann["segmentation"], dict):
                    continue  # the crowd images' rectangles are polygons
                h, w = info["height"], info["width"]
                c = coco_mod.rle_to_mask(ann["segmentation"], h, w)
                plain = coco_mod.rle_to_mask_plain(ann["segmentation"], h, w)
                source = sources[(subset, ann["id"])]
                if not (np.array_equal(c, plain) and np.array_equal(c, source)):
                    raise AssertionError(f"RLE decoders: {subset} annotation {ann['id']} differs (C vs numpy "
                                         f"{np.array_equal(c, plain)}, C vs source {np.array_equal(c, source)})")
                n += 1
    log(f"  (a) {n} instances of the re-encoded directory (compressed string counts; {len(CROWD_RUNS)} crowd "
        f"masks of {CROWD_RUNS} runs at 480x640): C decoder == numpy decoder == source mask, bit for bit")
    for runs, (seg, h, w) in crowds.items():
        c_ms = per_call_ms(lambda: coco_mod.rle_to_mask(seg, h, w), 200)
        np_ms = per_call_ms(lambda: coco_mod.rle_to_mask_plain(seg, h, w), 20 if runs > 2000 else 100)
        log(f"  (a) a 480x640 mask of {runs} runs: C {c_ms:.4f} ms, numpy {np_ms:.4f} ms per mask (median; host "
            f"clock on the card's machine, {card})")
    train = CocoDataset()
    train.load_coco(dst, "train")
    train.prepare()
    cfg = loop_cfg.replace(sample_cache_dir=None)
    rates = {"numpy": [], "C": []}
    batches = {}
    for decoder in ("numpy", "C", "C", "numpy"):
        with mock.patch.dict(os.environ):
            os.environ.pop("MASKRCNN_TPU_NO_NATIVE_RLE", None)
            if decoder == "numpy":
                os.environ["MASKRCNN_TPU_NO_NATIVE_RLE"] = "1"
            ips, out = loader_pass(train, cfg)
        rates[decoder].append(ips)
        batches.setdefault(decoder, out)
    for a, b in zip(batches["numpy"], batches["C"]):
        for key in a:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"the loader's batches differ between the decoders at {key}")
    log(f"  (a) loader (4 threads, {len(train)} images, batches of {cfg.batch_size}, no cache) over the re-encoded "
        f"directory: numpy decoder {[round(r, 2) for r in rates['numpy']]} images/s, C decoder "
        f"{[round(r, 2) for r in rates['C']]} images/s (in turns numpy, C, C, numpy; equal batches; host clock on the "
        f"card's machine, {card})")

    zips = os.path.join(root, "coco_zips")
    os.makedirs(zips)
    for name, top in (("train2017.zip", "train2017"), ("annotations_trainval2017.zip", "annotations")):
        shutil.make_archive(os.path.join(zips, name[:-4]), "zip", dst, top)
    urls = tuple(pathlib.Path(zips, name).as_uri() for name in ("train2017.zip", "annotations_trainval2017.zip"))
    fetched = os.path.join(root, "coco_fetched")
    with mock.patch.dict(coco_mod.COCO_URLS, {("train", "2017"): urls}):
        start = time.perf_counter()
        coco_mod.auto_download(fetched, "train")
        seconds = time.perf_counter() - start
        got = tree_bytes(fetched)
        want = {k: v for k, v in tree_bytes(dst).items() if k.startswith(("train2017", "annotations"))}
        if got != want:
            raise AssertionError(f"auto_download: {sorted(set(got) ^ set(want))[:5]} differ from the source")
        shutil.rmtree(zips)  # a second call that fetched anything would now raise
        coco_mod.auto_download(fetched, "train")
        if tree_bytes(fetched) != want:
            raise AssertionError("auto_download: the second call changed the directory")
    log(f"  (a) auto_download through file:// zips of that directory: {len(got)} files in {seconds:.2f} s, equal "
        f"to the source, the zips deleted; a second call with the sources gone extracted nothing")


def check_profiling(device, card, root, requests):
    """Phase 20(b): ``utils/profiling`` over one flagship request."""
    cfg = flagship_config()
    predictor, _ = seeded_predictor(cfg, device)
    predictor.detect(requests[0])  # warm-up
    zero_launch_counts()
    trace_dir = profiling.trace(lambda: predictor.detect(requests[0]), os.path.join(root, "trace"))
    launches = launch_counts()[:2]
    if launches != (2, 2):
        raise AssertionError(f"a traced request launched (NMS, ROIAlign) = {launches}; expected (2, 2)")
    ops = profiling.top_ops(trace_dir, k=10**6, device_only=True)
    names = [name for name, _ in ops]
    device_names = set()
    for path in pathlib.Path(trace_dir).rglob("*.trace.json.gz"):
        with gzip.open(path, "rt") as f:
            device_names |= {ev["name"] for ev in json.load(f)["traceEvents"]
                             if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() in profiling.DEVICE_CATEGORIES}
    if not names or set(names) - device_names:
        raise AssertionError(f"top_ops(device_only=True) lists events off the device: {sorted(set(names) - device_names)[:5]}")
    found = {}
    for kernel in ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel"):
        found[kernel] = [name for name in names if re.search(rf"(^|\W){kernel}\b", name)]
        if not found[kernel]:
            raise AssertionError(f"top_ops lists no {kernel}: {names[:20]}")
    busy = sum(us for _, us in ops)
    log(f"  (b) utils/profiling.trace of one flagship request (ResNet-50-FPN, 512x512, 81 classes, bf16, 2 images) "
        f"through Predictor.detect: launches (NMS, ROIAlign) {launches}; top_ops(device_only=True) lists "
        f"{len(ops)} device ops, {busy / 1e3:.3f} ms in all, every one a device event, with "
        + ", ".join(f"{k} as {v}" for k, v in found.items()) + f"; the top 10 ({card}):")
    for name, us in ops[:10]:
        log(f"      {us / 1e3:9.4f} ms  {name[:110]}")
    del predictor


def check_box_helpers(device, card):
    """Phase 20(c): the tensor box helpers on the card against the CPU."""
    rs = np.random.RandomState(SEED + 21)
    shape = (512, 512)
    y, x = (np.sort(rs.uniform(0, 512, size=(2, 1000, 2)), axis=-1) for _ in range(2))
    pix = torch.from_numpy(np.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], axis=-1).astype(np.float32))
    masks = np.zeros((16, *shape), bool)
    for i in range(1, 16):  # mask 0 stays empty
        y1, y2 = np.sort(rs.randint(0, 512, size=2))
        x1, x2 = np.sort(rs.randint(0, 512, size=2))
        masks[i, y1:y2 + 1, x1:x2 + 1] = rs.rand(y2 + 1 - y1, x2 + 1 - x1) < 0.3
    masks = torch.from_numpy(masks)
    cpu_boxes = boxes_op.extract_bboxes_from_masks(masks)
    card_boxes = boxes_op.extract_bboxes_from_masks(masks.to(device)).cpu()
    if not torch.equal(cpu_boxes, card_boxes):
        raise AssertionError("extract_bboxes_from_masks: the card's boxes differ from the CPU's")
    worst = {}
    for name, fn in (("norm_boxes", lambda b: boxes_op.norm_boxes(b, shape)),
                     ("denorm(norm_boxes)", lambda b: boxes_op.denorm_boxes(boxes_op.norm_boxes(b, shape), shape))):
        cpu, card_out = fn(pix).numpy(), fn(pix.to(device)).cpu().numpy()
        ulps = np.abs(cpu - card_out) / np.spacing(np.abs(cpu).astype(np.float32))
        worst[name] = float(ulps.max())
        if worst[name] > 1:
            raise AssertionError(f"{name}: the card is {worst[name]} float32 ulps from the CPU")
    log(f"  (c) box helpers on the card against the CPU: extract_bboxes_from_masks of 16 512x512 masks exact; "
        f"norm_boxes and denorm(norm_boxes) of 2x1000 boxes within {worst} float32 ulps (held <= 1)")


def run_last_modules(device, card, root, requests, loop_cfg):
    """Phase 20 (see the module's docstring)."""
    start = time.perf_counter()
    log("== last modules: the C RLE decoder, auto_download, utils/profiling, the tensor box helpers")
    check_rle_decoder(card, root, loop_cfg)
    check_profiling(device, card, root, requests)
    check_box_helpers(device, card)
    log(f"== last modules phase done in {time.perf_counter() - start:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; this script needs the card")
    device = torch.device("cuda")
    t0 = time.time()
    card = card_line()
    log(f"== device: {torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")

    logs = _build.build(["nms", "roi_align", "int8_conv", "paste_masks"])
    for name, out in logs.items():
        log(f"== build {name}.cu:\n" + "\n".join("  " + ln for ln in out.strip().splitlines()))
    log(f"== build done at {time.time() - t0:.1f} s (into {_build.BUILD_DIR})")

    cfg = flagship_config()
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED))
    predictor = Predictor(cfg, model.state_dict(), device=device)
    del model
    rs = np.random.RandomState(SEED)
    requests = [[smooth_image(rs, *hw) for hw in pair] for pair in REQUEST_SIZES]
    calls = capture_inputs(predictor, requests[0])
    log(f"== capture: warm-up request done at {time.time() - t0:.1f} s")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=device)  # > 50 MB L2
    log("== holds: greedy NMS kernel (csrc/nms.cu) vs greedy_nms_plain")
    nms_stats = hold_nms(calls["nms"], flush, [("chains", *chain_case(device), 0.5, 1000)] + nms_edge_cases(device))
    log("  library: no single PyTorch call computes greedy NMS (torchvision is absent)")
    log("== holds: pyramid ROIAlign kernel (csrc/roi_align.cu) vs roi_align_plain")
    roi_stats = hold_roi_align(calls["roi_align"], flush)
    hold_roi_scalar_width(device)
    log("  library: no single PyTorch call computes pyramid ROIAlign (torchvision is absent)")
    del calls
    tiny_cross_check(device)

    log("== serving: 4 requests of 2 images, flagship config (ResNet-50-FPN, 512, 81 classes, bf16)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.greedy_nms.launches = 0
    roi_kernel.roi_align.launches = 0
    k8.paste_masks.launches = 0
    latencies, all_results = [], []
    for images in requests:
        before = (nms_kernel.greedy_nms.launches, roi_kernel.roi_align.launches, k8.paste_masks.launches)
        start = time.perf_counter()
        results = predictor.detect(images)  # returns host arrays: synchronized
        latencies.append((time.perf_counter() - start) * 1e3)
        all_results.append((images, results))
        rose = (nms_kernel.greedy_nms.launches - before[0], roi_kernel.roi_align.launches - before[1],
                k8.paste_masks.launches - before[2])
        if min(rose[:2]) < 2 or rose[2] != 1:
            raise AssertionError(f"a request launched (nms, roi_align, paste_masks) = {rose} times; expected >= 2, "
                                 f">= 2 and exactly 1")
    launches = {"nms": nms_kernel.greedy_nms.launches, "roi_align": roi_kernel.roi_align.launches,
                "paste_masks": k8.paste_masks.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    for i, ((images, results), ms) in enumerate(zip(all_results, latencies)):
        check_results(results, images, cfg)
        log(f"  request {i}: sizes {[im.shape[:2] for im in images]} latency {ms:.1f} ms, "
            f"detections {[len(r['class_ids']) for r in results]}")
    # valid proposal and detection counts of the last request, from a direct forward
    molded, metas = zip(*(process_input(im, cfg, i) for i, im in enumerate(requests[-1])))
    out = predictor.model(torch.from_numpy(np.stack(molded)).to(device),
                          torch.from_numpy(np.stack(metas)).to(device))
    log(f"  valid proposals per image {out['rpn_rois_valid'].sum(1).tolist()}, valid detections "
        f"{(out['detections'][..., 4] > 0).sum(1).tolist()}; peak memory {peak:.0f} MiB; "
        f"launches {launches} ({card})")

    del out
    paste = run_paste_masks(predictor, device, card, flush)
    del predictor
    torch.cuda.empty_cache()

    state, step, batch, gen, tcalls = capture_train(device)
    log(f"== train capture: one step done at {time.time() - t0:.1f} s")
    log("== holds, training inputs: greedy NMS and pyramid ROIAlign forward kernels vs their plain versions")
    nms_train = hold_nms(tcalls["nms"], flush)
    roi_train = hold_roi_align(tcalls["roi_align"], flush)
    bwd_stats = hold_roi_backward(tcalls["roi_align_backward"], flush)
    del tcalls
    tiny_train_cross_check(device)
    train_launches = run_training(state, step, batch, gen, card)
    del state, step, batch
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        loop_launches, loop_cfg, val, loop_ips = run_train_model(device, card, root)
        torch.cuda.empty_cache()
        pretrained_launches = run_pretrained(device, card, root)
        eval_launches, stream_launches, eval_cfg, state_dict = run_evaluate(device, card, root, loop_cfg, val)
        run_detect_cli(device, card, root, eval_cfg, state_dict)
        zoo_launches = run_zoo(device, card, root, requests)
        torch.cuda.empty_cache()
        cli_launches = run_train_cli(device, card, root)
        torch.cuda.empty_cache()
        dp = run_data_parallel(device, card, root, loop_ips)
        torch.cuda.empty_cache()
        int8_state, k7 = run_int8(device, card, requests, flush, root)
        torch.cuda.empty_cache()
        engines = run_engine(device, card, requests, int8_state, root)
        torch.cuda.empty_cache()
        tp = run_tensor_parallel(device, card, root, requests, int8_state)
        torch.cuda.empty_cache()
        run_last_modules(device, card, root, requests, loop_cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    extra = {name: {"eval_launches": eval_launches[i], "stream_launches": stream_launches[i],
                    "pretrained_launches": pretrained_launches[name], "zoo_launches": zoo_launches[name],
                    "train_cli_launches": cli_launches[name], **dp[name], **tp[name]}
             for i, name in enumerate(("nms", "roi_align", "roi_align_backward"))}

    for i, name in enumerate(("nms", "roi_align")):
        extra[name].update(engine_launches=engines["bf16"]["launches"][i],
                           int8_engine_launches=engines["int8"]["launches"][i])
    k7["engine_launches"] = engines["int8"]["launches"][2]
    k7.update(tp["int8_conv"])
    k7["engine_forward_ms"] = {f"{name}_{kind}": engines[name][f"{kind}_ms"] for name in ("bf16", "int8")
                               for kind in ("engine", "eager")}
    kernels = [
        dict(name="greedy_nms", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/nms.cu",
             replaces="maskrcnn_tf2_tpu/kernels/nms_pallas.py:29", launches=launches["nms"],
             train_launches=train_launches["nms"], train_model_launches=loop_launches["nms"], **nms_stats,
             library_ms=None,
             train_ms=nms_train["ms"], train_bound_ms=nms_train["bound_ms"], **extra["nms"]),
        dict(name="pyramid_roi_align", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:484",
             also_replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:224",
             launches=launches["roi_align"], train_launches=train_launches["roi_align"],
             train_model_launches=loop_launches["roi_align"],
             **roi_stats, library_ms=None, train_ms=roi_train["ms"], train_bound_ms=roi_train["bound_ms"],
             **extra["roi_align"]),
        dict(name="pyramid_roi_align_backward", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:967",
             also_replaces=["maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:865",
                            "maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:1316"],
             launches=train_launches["roi_align_backward"],
             train_model_launches=loop_launches["roi_align_backward"], **bwd_stats, library_ms=None,
             **extra["roi_align_backward"]),
        k7,
        dict(name="paste_masks", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/paste_masks.cu", replaces=None,
             launches=launches["paste_masks"], **paste, library_ms=None),
    ]
    log(f"== done at {time.time() - t0:.1f} s; forward kernels' times per served batch of 2 images "
        f"(ms) and per training step (train_ms), the backward's per training step of 2 images (both "
        f"call sites summed); launches: serving's 4 requests, train_launches and the backward's: the 5 "
        f"training steps; train_model_launches: train_model's 6 steps and 4 eval steps; eval_launches and "
        f"stream_launches: evaluate_dataset over 4 images through detect and detect_stream; "
        f"pretrained_launches: 2 fine-tune steps from a pretrained file; zoo_launches: the backbone zoo's "
        f"{2 * len(ZOO_FULL_WIDTH)} requests and {2 * len(ZOO_FULL_WIDTH)} steps at full width, "
        f"{len(backbone_names())} requests of the sweep and 2 steps from pretrained files; train_cli_launches: "
        f"the training CLI's steps and eval steps with host augmentation; data_parallel_launches: rank 0's "
        f"in train_model under two gloo ranks, 6 steps and 4 eval steps; data_parallel_ms and its plain and "
        f"bound: rank 0's first data-parallel step (one image a rank, both call sites summed); int8_conv: ms, "
        f"plain_ms, bound_ms and library_ms summed over the 65 sites of one int8 request of 2 images, launches "
        f"the 4 int8 requests'; engine_launches and int8_engine_launches: the 4 requests through the bf16 and the "
        f"int8 flagship engine, each in a fresh process; tensor_parallel_launches: rank 0's in 3 DP1xTP2 steps, "
        f"tensor_parallel_ms and its bound: rank 0's first DP1xTP2 step; tensor_parallel_train_model_launches: "
        f"rank 0's in train_model under DP1xTP2 (3 steps, 2 eval steps); data_parallel_serving_launches: the 4 "
        f"requests through two replicas (K7: one int8 request); paste_masks (K8): launches the 4 requests', "
        f"stream_launches the crowd phase's 2 batches of 8 through detect_stream, ms and bound_ms into device "
        f"memory, pinned_ms and pinned_bound_ms into pinned host memory (the predictor's way), plain_ms the host "
        f"loop, all for one crowd batch of 8 images")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
