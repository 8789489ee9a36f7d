"""High-level inference API: ``Predictor.detect`` and the pipelined
``Predictor.detect_stream`` (counterpart of ``maskrcnn_tf2_tpu/predictor.py``;
data-parallel serving is not ported yet).

Host preprocessing -> one batched forward on the device (uint8 images go up,
normalization happens there) -> the class-mask gather on the device -> host
unmold.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Mapping

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks


class Predictor:
    """Batched inference with host unmolding.

    ``state_dict`` is the port's (see ``weights.flax_to_state_dict``).
    ``device=None`` runs on the card and raises if there is none.
    """

    def __init__(self, config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], device: DeviceLike = None):
        self.config = config
        self.model = MaskRCNN(config, device=device)
        self.model.load_state_dict(state_dict)
        self.model.cast_for_serving_()
        self.device = self.model.device

    def _forward(self, molded: np.ndarray, metas: np.ndarray):
        """Detections ``[B, D, 6]`` and class masks ``[B, D, mh, mw]`` on the
        device."""
        out = self.model(torch.from_numpy(molded).to(self.device), torch.from_numpy(metas).to(self.device))
        return out["detections"], gather_class_masks(out)

    def _unmold(self, detections, masks, metas, shapes) -> List[Dict[str, np.ndarray]]:
        return [unmold_detections(detections[i], masks[i], shape, self.config.image_shape, metas[i][7:11])
                for i, shape in enumerate(shapes)]

    @torch.no_grad()
    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Run detection on a list of RGB uint8 images of any sizes."""
        molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(images)))
        metas = np.stack(metas)
        detections, masks = self._forward(np.stack(molded), metas)
        return self._unmold(detections.cpu().numpy(), masks.cpu().numpy(), metas, [img.shape for img in images])

    @torch.no_grad()
    def detect_stream(
        self, images: Iterable[np.ndarray], batch_size: int = 8, depth: int = 2
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Pipelined detection over an image stream: one result dict per input
        image, in order, equal to ``detect`` over the same chunks of
        ``batch_size``.

        Three stages: (1) ``process_input`` on one worker thread, at most
        ``depth + 1`` chunks ahead (the input is read no further ahead than
        that); (2) the forward and the class-mask gather issued from this
        thread, their outputs copied into new pinned host tensors with
        ``non_blocking=True`` and a CUDA event recorded after the copies, so
        that up to ``depth`` batches stay in flight; (3) the oldest batch
        drained: wait on its event, then unmold. The ragged tail is padded
        with zero images and the last meta, so the shapes never change. On a
        CPU device there is no event and the copies are plain.
        """
        cuda = self.device.type == "cuda"

        def prep(chunk):
            molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(chunk)))
            pad = batch_size - len(chunk)
            molded = list(molded) + [np.zeros_like(molded[0])] * pad
            return np.stack(molded), np.stack(list(metas) + [metas[-1]] * pad), [img.shape for img in chunk]

        def prepped():
            it = iter(images)
            ahead = collections.deque()
            with ThreadPoolExecutor(max_workers=1) as pool:
                while True:
                    chunk = list(itertools.islice(it, batch_size))
                    if chunk:
                        ahead.append(pool.submit(prep, chunk))
                    if not ahead:
                        return
                    if not chunk or len(ahead) > depth + 1:
                        yield ahead.popleft().result()

        def launch(molded, metas):
            detections, masks = self._forward(molded, metas)
            if not cuda:
                return detections.numpy(), masks.numpy(), None
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (detections, masks)]
            for h, t in zip(host, (detections, masks)):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host[0].numpy(), host[1].numpy(), done

        def drain(entry):
            detections, masks, done, metas, shapes = entry
            if done is not None:
                done.synchronize()
            return self._unmold(detections, masks, metas, shapes)

        inflight: List = []
        for molded, metas, shapes in prepped():
            inflight.append(launch(molded, metas) + (metas, shapes))
            if len(inflight) > depth:
                yield from drain(inflight.pop(0))
        for entry in inflight:
            yield from drain(entry)
