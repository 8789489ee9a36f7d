"""High-level inference API: ``Predictor.detect`` and the pipelined
``Predictor.detect_stream`` (counterpart of ``maskrcnn_tf2_tpu/predictor.py``).

Host preprocessing -> one batched forward on the device (uint8 images go up,
normalization happens there) -> the class-mask gather on the device -> host
unmold.

Data-parallel serving (``data_parallel=True``): one replica of the model on
each device of ``devices``, the batch padded to a multiple of the replicas
(zero images, the last meta) and split into equal blocks of rows, each
block's forward run on a long-lived worker thread of its own under its
device (the eager forward blocks on the host several times a batch, so one
thread could not keep several cards busy), the outputs put back in input order on the
first replica's device. ``devices`` stands in for the JAX package's mesh of
every visible device.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks
from maskrcnn_tf2_tpu_torch.utils import profiling


class Predictor:
    """Batched inference with host unmolding.

    ``state_dict`` is the port's (see ``weights.flax_to_state_dict``); an
    int8 configuration serves with the calibrated ``state_dict`` that
    ``export.quantize.quantize_for_inference`` returns.
    ``device=None`` runs on the card and raises if there is none.

    ``data_parallel=True`` serves on a replica per device of ``devices``
    (default: ``[device]`` when ``device`` is given, else every visible card);
    with one device it is the single-device predictor, as the JAX package's
    is with one device. A model placed for tensor-parallel training is not
    served: the state dict is the whole one (``train.checkpoint`` writes it).
    """

    def __init__(self, config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], device: DeviceLike = None,
                 data_parallel: bool = False, devices: Optional[Sequence[DeviceLike]] = None):
        self.config = config
        if not data_parallel:
            devices = [device]
        elif devices is None:
            devices = [device] if device is not None else [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.replicas = [self._replica(state_dict, d) for d in (devices or [None])]
        self.model = self.replicas[0]
        self.device = self.model.device
        # one long-lived thread a replica: a thread's first CUDA call sets up its cuBLAS and cuDNN handles
        self._pool = ThreadPoolExecutor(max_workers=len(self.replicas)) if len(self.replicas) > 1 else None

    def _replica(self, state_dict, device) -> MaskRCNN:
        model = MaskRCNN(self.config, device=device)
        model.load_state_dict(state_dict)
        return model.cast_for_serving_()

    @property
    def num_devices(self) -> int:
        return len(self.replicas)

    def _forward(self, molded: np.ndarray, metas: np.ndarray):
        """Detections ``[B, D, 6]`` and class masks ``[B, D, mh, mw]`` on the
        (first replica's) device."""
        with profiling.span("forward") as s:
            n = self.num_devices
            if n == 1:
                return self._replica_forward(self.model, molded, metas)
            b = molded.shape[0]
            pad = -b % n
            if pad:
                molded = np.concatenate([molded, np.zeros((pad,) + molded.shape[1:], molded.dtype)])
                metas = np.concatenate([metas, np.repeat(metas[-1:], pad, 0)])
            rows = (b + pad) // n

            def replica(i):  # on the replica's thread: its spans carry the batch's id
                with profiling.span("forward.replica", s.batch):
                    return self._replica_forward(self.replicas[i], molded[i * rows:(i + 1) * rows],
                                                 metas[i * rows:(i + 1) * rows])

            outs = list(self._pool.map(replica, range(n)))
            return tuple(torch.cat([o[k].to(self.device) for o in outs])[:b] for k in range(2))

    @staticmethod
    def _replica_forward(model: MaskRCNN, molded: np.ndarray, metas: np.ndarray):
        device = model.device
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with ctx, torch.no_grad():  # the grad mode is per thread
            with profiling.span("forward.h2d"):
                profiling.host_sync(device, 2)  # copies from pageable memory
                images, image_meta = torch.from_numpy(molded).to(device), torch.from_numpy(metas).to(device)
            out = model(images, image_meta)
            with profiling.span("forward.gather"):
                return out["detections"], gather_class_masks(out)

    def _unmold(self, detections, masks, metas, shapes) -> List[Dict[str, np.ndarray]]:
        return [unmold_detections(detections[i], masks[i], shape, self.config.image_shape, metas[i][7:11])
                for i, shape in enumerate(shapes)]

    @torch.no_grad()
    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Run detection on a list of RGB uint8 images of any sizes."""
        with profiling.span("detect", profiling.new_batch()):
            molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(images)))
            metas = np.stack(metas)
            detections, masks = self._forward(np.stack(molded), metas)
            with profiling.span("fetch"):
                profiling.host_sync(detections.device, 2)
                detections, masks = detections.cpu().numpy(), masks.cpu().numpy()
            return self._unmold(detections, masks, metas, [img.shape for img in images])

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

        Under a profiler each stage is a span of ``utils/profiling.py``
        carrying its batch's id: ``stream.prep`` (the worker), and on this
        thread, inside one ``stream.step`` a batch, ``stream.wait_ingress``
        (waiting for the worker), ``stream.launch``, then for the oldest
        batch ``stream.wait_device`` (the event wait) and ``stream.unmold``.
        """
        cuda = self.device.type == "cuda"

        def prep(chunk, batch):
            with profiling.span("stream.prep", batch):
                molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(chunk)))
                pad = batch_size - len(chunk)
                molded = list(molded) + [np.zeros_like(molded[0])] * pad
                return np.stack(molded), np.stack(list(metas) + [metas[-1]] * pad), [img.shape for img in chunk]

        def submitted():
            """``(batch id, future of its prep)`` in order, at most ``depth + 1`` ahead."""
            it = iter(images)
            ahead = collections.deque()
            with ThreadPoolExecutor(max_workers=1) as pool:
                while True:
                    chunk = list(itertools.islice(it, batch_size))
                    if chunk:
                        batch = profiling.new_batch()
                        ahead.append((batch, pool.submit(prep, chunk, batch)))
                    if not ahead:
                        return
                    if not chunk or len(ahead) > depth + 1:
                        yield ahead.popleft()

        def launch(molded, metas):
            with profiling.span("stream.launch"):
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
            batch, detections, masks, done, metas, shapes = entry
            if done is not None:
                with profiling.span("stream.wait_device", batch):
                    profiling.host_sync(self.device)
                    done.synchronize()
            with profiling.span("stream.unmold", batch):
                return self._unmold(detections, masks, metas, shapes)

        # each turn of this thread is a span, so that its waits between stages
        # (for the interpreter lock, say) fall inside one; no span is open
        # across the yields
        inflight: List = []
        for batch, future in submitted():
            with profiling.span("stream.step", batch):
                with profiling.span("stream.wait_ingress"):
                    molded, metas, shapes = future.result()
                inflight.append((batch,) + launch(molded, metas) + (metas, shapes))
                ready = drain(inflight.pop(0)) if len(inflight) > depth else []
            yield from ready
        for entry in inflight:
            with profiling.span("stream.step", entry[0]):
                ready = drain(entry)
            yield from ready
