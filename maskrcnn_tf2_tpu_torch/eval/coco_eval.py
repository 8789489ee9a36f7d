"""COCO-style evaluation (AP@[.5:.95], AP50, AP75, area breakdown) — no
pycocotools dependency, but pycocotools-exact semantics.

A copy of ``maskrcnn_tf2_tpu/eval/coco_eval.py`` (the port imports nothing
of the JAX package); ``evaluate_dataset`` runs over the port's ``Predictor``
and datasets, through ``detect`` or, with ``stream_depth``,
``detect_stream``.

Fulfils the role of the reference's ``evaluate_coco`` + pycocotools
``COCOeval`` (samples/coco/coco.py:445-521): collect per-image results
(``build_coco_results`` equivalent) and compute the standard COCO metrics.

Semantics matched to pycocotools cocoeval.py (validated by the golden tests
in tests/test_cocoeval_golden.py):
  * greedy per-(image, class) matching, detections in score order, ground
    truth visited non-ignored-first; a detection prefers ANY non-ignored gt
    over every ignored gt (COCOeval's early ``break``), ties on IoU go to
    the later gt in visit order;
  * a matched gt is consumed even when it is ignored (COCOeval sets
    ``gtm`` unconditionally); only crowd gt may absorb multiple detections;
  * crowd IoU uses the detection area as denominator;
  * gt ignore = iscrowd OR annotation *segmentation* area outside the range
    (COCOeval reads ``gt['area']``, the segmentation area, for BOTH bbox and
    segm evaluation — NOT the bbox area);
  * dt area is bbox area for bbox eval and mask area for segm eval
    (COCO.loadRes semantics); an UNMATCHED detection whose area is outside
    the range is ignored, a matched one is not;
  * precision = tp/(tp+fp+eps), 101-point interpolation via
    ``searchsorted(rc, recall_points, side='left')``, monotone envelope;
    classes with no in-range gt are excluded from the mean (NaN ≡ -1).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from maskrcnn_tf2_tpu_torch.eval.metrics import compute_overlaps_boxes, compute_overlaps_masks

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
AREA_KEYS = ("all", "small", "medium", "large")


def _crowd_adjusted_iou(dt_boxes, gt_boxes, iscrowd, dt_masks=None, gt_masks=None):
    """IoU matrix; for crowd GT the denominator is the detection area only
    (COCO convention: IoU(dt, crowd) = inter / area(dt))."""
    if dt_masks is not None and gt_masks is not None:
        iou = compute_overlaps_masks(dt_masks, gt_masks)
        if iscrowd.any() and iou.size:  # no detection: nothing to adjust (the JAX copy fails here)
            m1 = dt_masks.reshape(-1, dt_masks.shape[-1]).astype(bool)
            m2 = gt_masks.reshape(-1, gt_masks.shape[-1]).astype(bool)
            inter = m1.T.astype(np.float32) @ m2.astype(np.float32)
            dt_area = np.maximum(m1.sum(0).astype(np.float32), 1e-10)
            crowd_iou = inter / dt_area[:, None]
            iou = np.where(iscrowd[None, :], crowd_iou, iou)
        return iou
    iou = compute_overlaps_boxes(dt_boxes, gt_boxes)
    if iscrowd.any():
        y1 = np.maximum(dt_boxes[:, None, 0], gt_boxes[None, :, 0])
        x1 = np.maximum(dt_boxes[:, None, 1], gt_boxes[None, :, 1])
        y2 = np.minimum(dt_boxes[:, None, 2], gt_boxes[None, :, 2])
        x2 = np.minimum(dt_boxes[:, None, 3], gt_boxes[None, :, 3])
        inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
        dt_area = np.maximum(
            (dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1]),
            1e-10,
        )
        iou = np.where(iscrowd[None, :], inter / dt_area[:, None], iou)
    return iou


def _match_image(iou, dt_out_of_range, gt_ignore, iscrowd):
    """COCOeval.evaluateImg matching for ALL (threshold, area range) states
    of one (image, class) at once.

    iou: [D, G]; dt_out_of_range: [A, D]; gt_ignore: [A, G]; iscrowd: [G].
    Returns (dt_matched[A, T, D], dt_ignored[A, T, D]).

    The greedy walk over detections is inherently sequential (each match
    consumes a gt), but the 10 IoU-threshold x 4 area-range states are
    independent — they are carried as a vectorized [A, T, G] ``gt_used`` so
    the python loop runs once per detection, not per (area, threshold,
    detection). ~5x on the val2017-scale benchmark
    (scripts/bench_cocoeval.py) with identical semantics (pinned by
    tests/test_cocoeval_golden.py).

    COCOeval visits gts sorted non-ignored-first; that permutation is a
    no-op here: candidates are split into the non-ignored and ignored
    groups explicitly (the reg/ig branches), each group preserves original
    relative order under the stable sort, and the last-index tie-break is
    resolved within one group — so matching runs on the unpermuted arrays.
    """
    t = len(IOU_THRESHOLDS)
    a = gt_ignore.shape[0]
    d, g = iou.shape
    dt_matched = np.zeros((a, t, d), bool)
    dt_ignored = np.zeros((a, t, d), bool)
    if d == 0:
        return dt_matched, dt_ignored
    if g == 0:
        dt_ignored[:] = dt_out_of_range[:, None, :]
        return dt_matched, dt_ignored
    not_ignored = ~gt_ignore[:, None, :]  # [A, 1, G]
    gt_ig = gt_ignore[:, None, :]
    thr = IOU_THRESHOLDS[None, :, None]  # [1, T, 1]
    gt_used = np.zeros((a, t, g), bool)
    for di in range(d):
        iou_d = iou[di][None, None, :]  # [1, 1, G]
        cand = (iou_d >= thr) & (~gt_used | iscrowd[None, None, :])  # [A, T, G]
        cand_reg = cand & not_ignored
        any_reg = cand_reg.any(axis=-1)  # [A, T]
        # last-index argmax per state (COCOeval replaces its best match on
        # >=, so later gts win ties): argmax on the reversed axis.
        vals = np.where(cand_reg, iou_d, -np.inf)
        best_reg = g - 1 - np.argmax(vals[..., ::-1], axis=-1)
        cand_ig = cand & gt_ig
        any_ig = cand_ig.any(axis=-1)
        vals = np.where(cand_ig, iou_d, -np.inf)
        best_ig = g - 1 - np.argmax(vals[..., ::-1], axis=-1)
        # matched to an ignored gt: detection ignored, gt consumed
        # (COCOeval sets gtm unconditionally).
        use_ig = ~any_reg & any_ig
        dt_matched[:, :, di] = any_reg
        dt_ignored[:, :, di] = use_ig | (
            ~any_reg & ~any_ig & dt_out_of_range[:, None, di]
        )
        hit = any_reg | use_ig
        ai, ti = np.nonzero(hit)
        gt_used[ai, ti, np.where(any_reg, best_reg, best_ig)[hit]] = True
    return dt_matched, dt_ignored


class CocoEvalLite:
    """Accumulates per-image detections + GT, computes COCO metrics.

    Usage:
      ev = CocoEvalLite(use_masks=True)
      ev.add_image(gt_boxes, gt_class_ids, dt_boxes, dt_class_ids, dt_scores,
                   gt_masks=..., dt_masks=..., gt_areas=...)  # crowd gt = negative ids
      stats = ev.summarize()

    ``gt_areas`` should be the annotation (segmentation) areas — COCOeval
    uses them for the S/M/L ignore test in BOTH bbox and segm evaluation.
    Defaults: mask areas when gt_masks given, else bbox areas.
    """

    def __init__(self, use_masks: bool = False, max_dets: int = 100):
        self.use_masks = use_masks
        self.max_dets = max_dets
        self._images: List[Dict] = []
        self._classes: set = set()
        self._cache = None  # per-(class, area) accumulation inputs

    def add_image(
        self,
        gt_boxes: np.ndarray,
        gt_class_ids: np.ndarray,
        dt_boxes: np.ndarray,
        dt_class_ids: np.ndarray,
        dt_scores: np.ndarray,
        gt_masks: Optional[np.ndarray] = None,  # [H, W, G]
        dt_masks: Optional[np.ndarray] = None,  # [H, W, D]
        gt_areas: Optional[np.ndarray] = None,  # annotation (segm) areas
    ):
        gt_boxes = np.asarray(gt_boxes, np.float64)
        if gt_areas is not None:
            gt_areas = np.asarray(gt_areas, np.float64)
        elif gt_masks is not None:
            gt_areas = gt_masks.astype(bool).sum(axis=(0, 1)).astype(np.float64)
        else:
            gt_areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        self._images.append(
            dict(
                gt_boxes=gt_boxes,
                gt_class_ids=np.asarray(gt_class_ids, np.int64),
                gt_areas=gt_areas,
                dt_boxes=np.asarray(dt_boxes, np.float64),
                dt_class_ids=np.asarray(dt_class_ids, np.int64),
                dt_scores=np.asarray(dt_scores, np.float64),
                gt_masks=gt_masks,
                dt_masks=dt_masks,
            )
        )
        self._classes.update(np.abs(np.asarray(gt_class_ids, np.int64)).tolist())
        self._classes.update(np.asarray(dt_class_ids, np.int64).tolist())
        self._classes.discard(0)
        self._cache = None

    # ------------------------------------------------------------------
    def _evaluate_all(self):
        """Evaluate every (image, class) once — IoU computed a single time
        and the matching repeated per area range (COCOeval.evaluate does the
        same: ious per (img, cat), evaluateImg per (img, cat, area))."""
        classes = sorted(self._classes)
        cls_index = {c: i for i, c in enumerate(classes)}
        # per class, per area: lists of per-image (scores, matched, ignored) + n_gt
        acc = {
            a: [dict(scores=[], matched=[], ignored=[], n_gt=0) for _ in classes]
            for a in AREA_KEYS
        }
        for im in self._images:
            gt_ids = im["gt_class_ids"]
            dt_ids = im["dt_class_ids"]
            present = set(np.abs(gt_ids).tolist()) | set(dt_ids.tolist())
            present.discard(0)
            for cls in present:
                ci = cls_index[cls]
                gt_sel = np.abs(gt_ids) == cls
                dt_sel = dt_ids == cls
                gt_boxes = im["gt_boxes"][gt_sel]
                gt_areas = im["gt_areas"][gt_sel]
                iscrowd = gt_ids[gt_sel] < 0
                dt_boxes = im["dt_boxes"][dt_sel]
                dt_scores = im["dt_scores"][dt_sel]
                order = np.argsort(-dt_scores, kind="stable")[: self.max_dets]
                dt_boxes = dt_boxes[order]
                dt_scores = dt_scores[order]
                gm = dm = None
                if self.use_masks:
                    gm = im["gt_masks"][..., gt_sel]
                    dm = im["dt_masks"][..., dt_sel][..., order]
                    # COCO.loadRes: segm dt area = mask area
                    dt_areas = dm.astype(bool).sum(axis=(0, 1)).astype(np.float64)
                else:
                    dt_areas = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (
                        dt_boxes[:, 3] - dt_boxes[:, 1]
                    )
                iou = _crowd_adjusted_iou(dt_boxes, gt_boxes, iscrowd, dm, gm)
                lo = np.array([AREA_RANGES[k][0] for k in AREA_KEYS])[:, None]
                hi = np.array([AREA_RANGES[k][1] for k in AREA_KEYS])[:, None]
                gt_ignore = iscrowd[None, :] | (gt_areas[None, :] < lo) | (
                    gt_areas[None, :] > hi
                )  # [A, G]
                dt_oor = (dt_areas[None, :] < lo) | (dt_areas[None, :] > hi)
                matched, ignored = _match_image(iou, dt_oor, gt_ignore, iscrowd)
                for ai, area in enumerate(AREA_KEYS):
                    rec = acc[area][ci]
                    rec["scores"].append(dt_scores)
                    rec["matched"].append(matched[ai])
                    rec["ignored"].append(ignored[ai])
                    rec["n_gt"] += int((~gt_ignore[ai]).sum())
        self._cache = (classes, acc)
        return self._cache

    def _accumulate(self, area: str = "all"):
        """Per-class precision-recall over all images -> AP[t, class]."""
        if self._cache is None:
            self._evaluate_all()
        classes, acc = self._cache
        t = len(IOU_THRESHOLDS)
        ap = np.full((t, len(classes)), np.nan)
        recall = np.full((t, len(classes)), np.nan)
        for ci in range(len(classes)):
            rec = acc[area][ci]
            if rec["n_gt"] == 0:
                continue
            n_gt_total = rec["n_gt"]
            if rec["scores"]:
                scores = np.concatenate(rec["scores"])
                matched = np.concatenate(rec["matched"], axis=1)
                ignored = np.concatenate(rec["ignored"], axis=1)
            else:
                scores = np.zeros(0)
                matched = np.zeros((t, 0), bool)
                ignored = np.zeros((t, 0), bool)
            order = np.argsort(-scores, kind="stable")
            matched = matched[:, order]
            ignored = ignored[:, order]
            if matched.shape[1] == 0:
                ap[:, ci] = 0.0
                recall[:, ci] = 0.0
                continue
            # pycocotools accumulate(): cumsum over ALL detections —
            # ignored ones contribute to neither tp nor fp, leaving
            # duplicate (rc, pr) points that the left-searchsorted 101-pt
            # interpolation resolves to the same precision values.
            tp = np.cumsum(matched & ~ignored, axis=1, dtype=np.float64)
            fp = np.cumsum(~matched & ~ignored, axis=1, dtype=np.float64)
            rc = tp / n_gt_total
            pr = tp / (tp + fp + np.spacing(1))
            # monotone non-increasing precision envelope
            pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            n = pr.shape[1]
            for ti in range(t):
                # 101-point interpolation
                idx = np.searchsorted(rc[ti], RECALL_POINTS, side="left")
                prec_at = np.where(idx < n, pr[ti][np.minimum(idx, n - 1)], 0.0)
                ap[ti, ci] = prec_at.mean()
                recall[ti, ci] = rc[ti, -1]
        return ap, recall

    def summarize(self, verbose: bool = True) -> Dict[str, float]:
        ap_all, recall_all = self._accumulate("all")
        stats = {
            "AP": float(np.nanmean(ap_all)),
            "AP50": float(np.nanmean(ap_all[0])),
            "AP75": float(np.nanmean(ap_all[5])),
            "AR100": float(np.nanmean(recall_all)),
        }
        for area in ("small", "medium", "large"):
            ap_a, _ = self._accumulate(area)
            stats[f"AP_{area}"] = float(np.nanmean(ap_a)) if not np.all(np.isnan(ap_a)) else float("nan")
        if verbose:
            kind = "segm" if self.use_masks else "bbox"
            for k, v in stats.items():
                print(f"  {kind} {k}: {v:.4f}")
        return stats


def evaluate_dataset(
    predictor,
    dataset,
    config,
    limit: Optional[int] = None,
    use_masks: bool = True,
    verbose: bool = True,
    stream_depth: Optional[int] = None,
) -> Dict[str, Dict[str, float]]:
    """Run the predictor over a dataset and compute bbox+segm COCO metrics
    (the reference's evaluate_coco flow, coco.py:472-521).

    The final ragged batch is padded to ``config.batch_size`` by repeating
    the last image, so the predictor never sees a new batch shape. With
    ``stream_depth`` the images go through ``predictor.detect_stream`` (that
    many batches in flight) in the same batches, so the metrics equal
    ``detect``'s."""
    from maskrcnn_tf2_tpu_torch.data.transforms import extract_bboxes

    ev_box = CocoEvalLite(use_masks=False)
    ev_segm = CocoEvalLite(use_masks=True) if use_masks else None
    n = min(limit or len(dataset), len(dataset))
    t0 = time.time()
    bs = config.batch_size
    padded = list(range(n)) + [n - 1] * (-n % bs)  # pad ragged tail — no new shape
    if stream_depth is None:
        results = (r for start in range(0, n, bs)
                   for r in predictor.detect([dataset.load_image(i) for i in padded[start:start + bs]]))
    else:
        results = predictor.detect_stream((dataset.load_image(i) for i in padded), batch_size=bs,
                                          depth=stream_depth)
    for i, r in zip(range(n), results):
        gt_masks, gt_ids = dataset.load_mask(i)
        gt_boxes = extract_bboxes(gt_masks).astype(np.float64)
        gt_areas = gt_masks.astype(bool).sum(axis=(0, 1)).astype(np.float64)
        ev_box.add_image(
            gt_boxes,
            gt_ids,
            r["rois"].astype(np.float64),
            r["class_ids"],
            r["scores"],
            gt_areas=gt_areas,
        )
        if ev_segm is not None:
            dt_masks = r["masks"].astype(np.uint8)
            ev_segm.add_image(
                gt_boxes,
                gt_ids,
                r["rois"].astype(np.float64),
                r["class_ids"],
                r["scores"],
                gt_masks=gt_masks.astype(np.uint8),
                dt_masks=dt_masks,
                gt_areas=gt_areas,
            )
    if verbose:
        print(f"evaluated {n} images in {time.time() - t0:.1f}s")
    out = {"bbox": ev_box.summarize(verbose)}
    if ev_segm is not None:
        out["segm"] = ev_segm.summarize(verbose)
    return out
