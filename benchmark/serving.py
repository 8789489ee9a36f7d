"""What the serving loops share: the predictor under test, the capture of
what a sample of forwards produced, host spans around the serving stages, and
the check of the captured outputs against the plain reference.

The check follows the program stage by stage on the program's own inputs to
each stage, so that a rounding upstream cannot reorder what a later stage
selects (at seeded weights the class scores are near ties):

- ingress: the reference molds each raw image itself; the molded image and
  its meta must equal the program's;
- backbone, FPN, RPN: the RPN logits over every anchor, relative L2 gap to
  the reference's float32 logits on its own molded image (``rpn_rel``);
- proposals (K1): the reference's top-k, decode, clip and greedy NMS on the
  program's RPN probabilities and deltas must give the program's proposals;
- 7x7 ROIAlign (K2) and classifier: class log-probabilities and box deltas,
  on the program's proposals over the reference's float32 pyramid, relative
  L2 (``class_logp_rel``, ``box_delta_rel``);
- detection (class-offset NMS, K1): the reference's refinement of the
  program's proposals, probabilities and deltas must give its detections;
- 14x14 ROIAlign (K3), mask head and the class gather: mask logits at the
  program's detections and classes, relative L2 (``mask_logit_rel``);
- unmold: the reference's unmold of the program's detections and masks must
  give the program's boxes, classes, scores and full-size masks.

A cell compares the numbers its ``limits/<cell>.json`` names; the others are
reported among the run's diagnostics.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness import Check, Spans, patched, program_config, serving_state_dict, sync


def make_predictor(cfg: dict, seed: int, calib_images, control: Optional[str] = None, device="cuda"):
    """The program's ``Predictor`` with the seed's weights (the class logits
    scaled on ``calib_images``, ``harness.serving_state_dict``), those
    weights on the host for the check, and the seconds the reference took to
    scale them; ``control="int8"`` gives the program's own int8 path, its
    scales calibrated on the same images."""

    from maskrcnn_tf2_tpu_torch.export.inference import process_input
    from maskrcnn_tf2_tpu_torch.export.quantize import quantize_for_inference
    from maskrcnn_tf2_tpu_torch.predictor import Predictor

    config = program_config(cfg)
    state, calib_s = serving_state_dict(cfg, seed, calib_images, device)
    host = {k: v.cpu() for k, v in state.items()}
    if control == "int8":  # every int8 site the program has: backbone, FPN, RPN, classifier, mask head
        molded = [process_input(img, config) for img in calib_images]
        batches = [(np.stack([m for m, _ in molded]), np.stack([x for _, x in molded]))]
        config, state = quantize_for_inference(config.replace(quant_classifier=True, quant_mask_head=True), state,
                                               batches, device=device)
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    predictor = Predictor(config, state, device=device)
    del state
    sync(device)
    return predictor, host, calib_s


class Capture:
    """Keeps, for the forward calls whose index ``want`` holds, the inputs and
    the per-image outputs of the forward (references, no copies: the timed
    path does no extra device work)."""

    KEYS = ("rpn_logits", "rpn_probs", "rpn_bbox", "rpn_rois", "mrcnn_probs", "mrcnn_deltas", "detections")

    def __init__(self, want):
        self.want = set(want)
        self.calls = 0
        self.records: Dict[int, dict] = {}
        self._out = None

    @contextlib.contextmanager
    def installed(self):
        from maskrcnn_tf2_tpu_torch import predictor as pmod

        def gather_wrap(fn):
            def wrapped(out):
                self._out = out
                return fn(out)
            return wrapped

        def forward_wrap(fn):
            def wrapped(pred, molded, metas):
                k = self.calls
                self.calls += 1
                detections, masks = fn(pred, molded, metas)
                if k in self.want:
                    out = self._out
                    self.records[k] = dict({key: out[key] for key in self.KEYS}, molded=molded, metas=metas,
                                           masks=masks)
                self._out = None
                return detections, masks
            return wrapped

        with patched([(pmod, "gather_class_masks", gather_wrap), (pmod.Predictor, "_forward", forward_wrap)]):
            yield


@contextlib.contextmanager
def stage_spans(spans: Spans):
    """Host spans: ``ingress`` per image, ``forward`` per forward call (its
    issue, which returns after the forward's last host sync),
    ``forward_fetch`` from a forward's start to the start of its unmold
    (the fetch of its outputs included), ``unmold`` per image."""
    from maskrcnn_tf2_tpu_torch import predictor as pmod

    starts: List[float] = []

    def forward_wrap(fn):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            starts.append(t)
            try:
                return fn(*args, **kwargs)
            finally:
                spans.add("forward", t, time.perf_counter())
        return wrapped

    def unmold_batch_wrap(fn):
        def wrapped(*args, **kwargs):
            if starts:
                spans.add("forward_fetch", starts.pop(0), time.perf_counter())
            return fn(*args, **kwargs)
        return wrapped

    with patched([(pmod, "process_input", lambda fn: spans.wrap(fn, "ingress")),
                  (pmod, "unmold_detections", lambda fn: spans.wrap(fn, "unmold")),
                  (pmod.Predictor, "_forward", forward_wrap), (pmod.Predictor, "_unmold", unmold_batch_wrap)]):
        yield


def span_medians(spans: Spans) -> Dict[str, float]:
    """Median milliseconds of each stage span (diagnostics of every run)."""
    import statistics

    names = {n for n, _, _ in spans.items}
    return {n: statistics.median(spans.durations(n)) * 1e3 for n in sorted(names)}


def _log(p):
    """Log-probabilities from probabilities (the program returns no logits)."""
    import torch

    return torch.log(p.float().clamp(min=1e-30))


def _logit(p):
    """Mask logits from the sigmoid's output."""
    import torch

    p = p.float().clamp(1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def rel(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def readings(cfg: dict, state: Dict, items: List[dict], device="cuda") -> Dict[str, float]:
    """The numbers compared, over ``items``: one dict per captured image with
    ``raw``, ``image_id``, ``molded``, ``meta``, the forward's outputs for
    that image (``Capture.KEYS``, ``masks``) and ``result`` (what the program
    returned for it). Builds the float32 reference from ``state``, the
    weights the program was given."""
    import torch

    from benchmark.reference import ops
    from benchmark.reference.model import load_reference, plain_float32

    with torch.no_grad(), plain_float32():
        ref = load_reference(cfg, {k: v.to(device) for k, v in state.items()}, device)
        r = {k: 0.0 for k in ("ingress_max_abs", "rpn_rel", "proposal_mismatch", "class_logp_rel", "box_delta_rel",
                              "detection_mismatch", "mask_logit_rel", "unmold_mismatch")}
        for it in items:
            molded, meta = ops.mold_image(it["raw"], cfg, it["image_id"])
            r["ingress_max_abs"] = max(r["ingress_max_abs"],
                                       float(np.abs(molded.astype(np.int32) - it["molded"].astype(np.int32)).max()),
                                       float(np.abs(meta - it["meta"]).max()))
            feats, logits, _, _ = ref.features(molded)
            r["rpn_rel"] = max(r["rpn_rel"], rel(it["rpn_logits"], logits))
            rois, _ = ops.generate_proposals(it["rpn_probs"], it["rpn_bbox"], ref.anchors, cfg,
                                             cfg["post_nms_rois_inference"])
            same = (rois == it["rpn_rois"]).all(dim=1)
            r["proposal_mismatch"] = max(r["proposal_mismatch"], float((~same).float().mean()))
            prois = it["rpn_rois"].float()
            probs, deltas = ref.classify(feats, prois)
            r["class_logp_rel"] = max(r["class_logp_rel"], rel(_log(it["mrcnn_probs"]), _log(probs)))
            r["box_delta_rel"] = max(r["box_delta_rel"], rel(it["mrcnn_deltas"], deltas))
            det = ops.refine_detections(prois, it["mrcnn_probs"].float(), it["mrcnn_deltas"].float(), ref.window(meta),
                                        cfg, cfg["detection_min_confidence"])
            pdet = it["detections"].float()
            r["detection_mismatch"] = max(r["detection_mismatch"], float((~(det == pdet).all(dim=1)).float().mean()))
            n = int((pdet[:, 4] > 0).sum())
            if n:
                masks = ref.masks(feats, pdet[:n, :4], pdet[:n, 4].long())
                r["mask_logit_rel"] = max(r["mask_logit_rel"], rel(_logit(it["masks"][:n]), _logit(masks)))
            want = ops.unmold(pdet.cpu().numpy(), it["masks"].float().cpu().numpy(), it["raw"].shape, cfg, meta[7:11])
            r["unmold_mismatch"] = max(r["unmold_mismatch"], unmold_gap(it["result"], want))
        del ref
    return r


def unmold_gap(got: dict, want: dict) -> float:
    """Share of the reference's instances that the program's result does not
    reproduce exactly (box, class, score and every mask pixel); 1 when the
    counts differ."""
    n = len(want["class_ids"])
    if len(got["class_ids"]) != n:
        return 1.0
    if n == 0:
        return 0.0
    bad = ~((got["rois"] == want["rois"]).all(axis=1) & (got["class_ids"] == want["class_ids"])
            & (got["scores"] == want["scores"]) & (got["masks"] == want["masks"]).all(axis=(0, 1)))
    return float(bad.mean())


def checks(values: Dict[str, float], limits: Dict[str, float], missing: int) -> List[Check]:
    """The numbers that have a limit beside it, and the count of sampled
    images the check could not judge (limit 0)."""
    return [Check(k, values[k], limits[k]) for k in limits] + [Check("unjudged_images", float(missing), 0.0)]


def items_from(capture: Capture, batches: Dict[int, tuple], results: Dict[int, dict]):
    """Per-image items of the captured forwards, and the number of images
    whose outputs a forward, or whose result the stream, did not give.
    ``batches[k]`` is forward ``k``'s ``(raw images, index of its first
    result)``; ``results`` maps a result's index in the stream to it."""
    items, missing = [], 0
    for k, rec in sorted(capture.records.items()):
        raws, first = batches[k]
        for b, raw in enumerate(raws):
            if (any(rec[key].shape[0] <= b for key in Capture.KEYS) or len(rec["molded"]) <= b
                    or first + b not in results):
                missing += 1
                continue
            item = {key: rec[key][b] for key in Capture.KEYS}
            item.update(raw=raw, image_id=b, molded=rec["molded"][b], meta=rec["metas"][b], masks=rec["masks"][b],
                        result=results[first + b])
            items.append(item)
    return items, missing
