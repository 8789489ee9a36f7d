"""Augmentation on the device, inside the training step (counterpart of
``maskrcnn_tf2_tpu/ops/augment.py``).

* Horizontal flip: the image mirrored, normalized GT boxes mapped
  ``x1' = 1 - x2, x2' = 1 - x1``, mini masks mirrored along their width (they
  live in box-relative coordinates, so mirroring the crop flips the instance).
* Zoom-out scale jitter: the image shrunk by ``s`` in ``[1 - scale_jitter,
  1]`` toward the top-left corner, resampled bilinearly on the fixed H x W
  grid by two interpolation-matrix contractions, GT boxes scaled by ``s``;
  zoom-out only, so every box stays in the frame and its mini mask valid.
* Photometric jitter: per-image brightness and contrast on the raw 0..255
  image, clipped to 0..255.

The randomness comes in as uniform draws in [0, 1), one ``[B]`` tensor each
(``ops.targets.draw_uniforms``: ``aug_flip``, ``aug_scale``, ``aug_bright``,
``aug_contrast``), mapped as JAX maps its own: ``bernoulli(k, 0.5)`` is
``u < 0.5`` and ``uniform(k, lo, hi)`` is ``max(lo, u * (hi - lo) + lo)`` in
float32, so a test can hand in the draws JAX made and compare.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u.to(torch.float32) * (hi_t - lo_t) + lo_t)


def _flip_batch(images, gt_boxes, gt_masks, gt_valid, do_flip):
    images = torch.where(do_flip[:, None, None, None], torch.flip(images, dims=[2]), images)
    flip_box = do_flip[:, None] & gt_valid
    x1 = torch.where(flip_box, 1.0 - gt_boxes[..., 3], gt_boxes[..., 1])
    x2 = torch.where(flip_box, 1.0 - gt_boxes[..., 1], gt_boxes[..., 3])
    gt_boxes = torch.stack([gt_boxes[..., 0], x1, gt_boxes[..., 2], x2], dim=-1)
    gt_masks = torch.where(do_flip[:, None, None, None], torch.flip(gt_masks, dims=[-1]), gt_masks)
    return images, gt_boxes, gt_masks


def _zoom_out_batch(images, gt_boxes, gt_valid, scale):
    """Output pixel ``p`` samples input position ``p / scale`` with hat
    weights, zero past the image's end."""
    b, h, w, c = images.shape
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :] / scale[:, None]  # [B, H]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] / scale[:, None]
    ymat = torch.clamp(1.0 - torch.abs(ys[:, :, None] - torch.arange(h, dtype=torch.float32, device=dev)), min=0.0)
    xmat = torch.clamp(1.0 - torch.abs(xs[:, :, None] - torch.arange(w, dtype=torch.float32, device=dev)), min=0.0)
    out = torch.einsum("byh,bhwc->bywc", ymat, images)
    out = torch.einsum("bywc,bxw->byxc", out, xmat)
    gt_boxes = torch.where(gt_valid[..., None], gt_boxes * scale[:, None, None], gt_boxes)
    return out, gt_boxes


@torch.no_grad()
def device_augment(batch: Mapping[str, torch.Tensor], draws: Mapping[str, torch.Tensor], flip: bool = True,
                   scale_jitter: float = 0.0, photometric: float = 0.0) -> Dict[str, torch.Tensor]:
    """A new batch dict with ``images`` (float32, raw 0..255), ``gt_boxes``
    and ``gt_masks`` augmented. ``batch``: ``images [B, H, W, 3]`` (uint8 or
    float), ``gt_class_ids [B, G]``, ``gt_boxes [B, G, 4]`` normalized,
    ``gt_masks [B, G, mh, mw]``."""
    images = batch["images"].to(torch.float32)
    gt_boxes = batch["gt_boxes"]
    gt_masks = batch["gt_masks"]
    gt_valid = batch["gt_class_ids"] != 0
    if flip:
        images, gt_boxes, gt_masks = _flip_batch(images, gt_boxes, gt_masks, gt_valid, draws["aug_flip"] < 0.5)
    if scale_jitter > 0.0:
        scale = _uniform(draws["aug_scale"], 1.0 - scale_jitter, 1.0)
        images, gt_boxes = _zoom_out_batch(images, gt_boxes, gt_valid, scale)
    if photometric > 0.0:
        bright = _uniform(draws["aug_bright"], -photometric, photometric)[:, None, None, None]
        contrast = _uniform(draws["aug_contrast"], 1.0 - photometric, 1.0 + photometric)[:, None, None, None]
        mean = images.mean(dim=(1, 2, 3), keepdim=True)
        images = torch.clamp((images - mean) * contrast + mean + 255.0 * bright, 0.0, 255.0)
    out = dict(batch)
    out.update(images=images, gt_boxes=gt_boxes, gt_masks=gt_masks)
    return out
