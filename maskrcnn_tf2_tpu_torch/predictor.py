"""High-level inference API: ``Predictor.detect`` and the pipelined
``Predictor.detect_stream`` (counterpart of ``maskrcnn_tf2_tpu/predictor.py``).

One path serves both methods on every device: ``_mold`` (host
preprocessing) -> ``_launch``: one batched forward on the device (uint8
images go up, normalization happens there), the class-mask gather on the
device, the masks pasted into each original image by the op of
``kernels/paste_masks.py`` (on the card one kernel, K8, straight into pinned
host memory; on the CPU its plain version), the detections and the kept
counts copied to the host behind it -> ``_unmold``, which copies each image's
masks out, the images of a batch side by side on a pool of host threads.

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
import os
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, Iterable, Iterator, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.kernels import paste_masks
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks
from maskrcnn_tf2_tpu_torch.utils import profiling


class Pasted(NamedTuple):
    """One batch's masks as K8 (or its plain version) pasted them: image
    ``i``'s ``[H0, W0, kept[i]]`` bytes at ``out[offsets[i]:]``."""

    out: torch.Tensor
    offsets: np.ndarray
    kept: np.ndarray


class Launched(NamedTuple):
    """A batch ``_launch`` issued: detections ``[B, D, 6]`` and ``Pasted`` in
    host memory, final once ``done`` is reached (None on the CPU: on return)."""

    detections: np.ndarray
    pasted: Pasted
    done: Optional[torch.cuda.Event]


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
        # the copies out of K8's ring, one image a task: the executor starts a thread only when a task finds
        # none idle, so a batch of k images runs on min(k, usable CPUs) threads, kept for the predictor's life
        self._unmold_pool = ThreadPoolExecutor(max_workers=len(os.sched_getaffinity(0)),
                                               thread_name_prefix="unmold")

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

    def _mold(self, images: Sequence[np.ndarray], batch_size: Optional[int] = None):
        """``(molded, metas, original shapes)`` of ``images``; with
        ``batch_size``, padded to it with zero images and the last meta, so
        that the shapes never change (the padding's masks are not pasted)."""
        molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(images)))
        pad = (batch_size or len(images)) - len(images)
        molded = list(molded) + [np.zeros_like(molded[0])] * pad
        return np.stack(molded), np.stack(list(metas) + [metas[-1]] * pad), [img.shape for img in images]

    def _launch(self, molded: np.ndarray, metas: np.ndarray, shapes, staging: torch.Tensor) -> Launched:
        """Forward a molded batch, paste the masks of its first ``len(shapes)``
        images into ``staging`` (host memory, pinned on the card; replaced if
        short: the caching host allocator hands a freed buffer back, so one is
        pinned once in the process), and copy the detections and kept counts
        to the host behind it. On the card nothing waits for the device: the
        copies go through pinned memory and an event is recorded after them."""
        detections, masks = self._forward(molded, metas)
        b, device = len(shapes), detections.device
        card = device.type == "cuda"
        offsets, total, largest = paste_masks.block_layout([s[:2] for s in shapes], detections.shape[1])
        if staging.numel() < total:
            staging = torch.empty(total, dtype=torch.uint8, pin_memory=card)
        up = [torch.from_numpy(a) for a in (np.ascontiguousarray(metas[:b]), offsets)]
        if card:
            up = [t.pin_memory().to(device, non_blocking=True) for t in up]
        with profiling.span("paste"):
            kept = paste_masks.paste_masks(detections[:b], masks[:b], up[0], up[1], self.config.image_shape,
                                           staging[:total], largest)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=card) for t in (detections, kept)]
        for h, t in zip(host, (detections, kept)):
            h.copy_(t, non_blocking=card)
        done = torch.cuda.current_stream().record_event() if card else None
        return Launched(host[0].numpy(), Pasted(staging, offsets, host[1].numpy()), done)

    def _unmold(self, detections: np.ndarray, metas, shapes, pasted: Pasted) -> List[Dict[str, np.ndarray]]:
        """Host unmold of a launched batch once it is final: each image's masks
        copied out of its block of ``pasted``, a batch of several images side
        by side on the unmold pool (numpy lets go of the interpreter lock while
        it copies). Returns, or raises the first error in input order, only
        once every copy has ended: K8 may then write the blocks again."""
        profiling.count("unmold.device_masks", int(pasted.kept.sum()))
        flat = pasted.out.numpy()
        blocks = [flat[off:off + h * w * int(k)].reshape(h, w, int(k))
                  for (h, w, *_), off, k in zip(shapes, pasted.offsets, pasted.kept)]

        def one(i, batch=None):
            return unmold_detections(detections[i], None, shapes[i], self.config.image_shape, metas[i][7:11],
                                     pasted=blocks[i], batch=batch)

        if len(shapes) == 1:
            return [one(0)]
        with profiling.span("unmold.pool") as s:
            s.n = len(shapes)
            profiling.count("unmold.pooled_images", len(shapes))
            futures = [self._unmold_pool.submit(one, i, s.batch) for i in range(len(shapes))]
            wait(futures)
        return [f.result() for f in futures]

    @torch.no_grad()
    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Run detection on a list of RGB uint8 images of any sizes."""
        with profiling.span("detect", profiling.new_batch()):
            molded, metas, shapes = self._mold(images)
            launched = self._launch(molded, metas, shapes, torch.empty(0, dtype=torch.uint8))
            with profiling.span("fetch"):
                if launched.done is not None:
                    profiling.host_sync(self.device)
                    launched.done.synchronize()
            return self._unmold(launched.detections, metas, shapes, launched.pasted)

    @torch.no_grad()
    def detect_stream(
        self, images: Iterable[np.ndarray], batch_size: int = 8, depth: int = 2
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Pipelined detection over an image stream: one result dict per input
        image, in order, equal to ``detect`` over the same chunks of
        ``batch_size``.

        Three stages: (1) ``_mold`` on one worker thread, at most ``depth +
        1`` chunks ahead (the input is read no further ahead than that); (2)
        ``_launch`` issued from this thread, its masks pasted into the
        batch's slot of a ring of ``depth + 1`` host buffers (pinned on the
        card, reused for the whole stream), so that up to ``depth`` batches
        stay in flight; (3) the oldest batch drained: wait on its event, then
        unmold, which copies each image's masks out of the ring on the unmold
        pool's threads and returns when every copy has ended. The ragged tail
        is padded with zero images and the last meta, so the shapes never
        change (the paste skips the padding). On a CPU device there is no
        event: the batch is whole when ``_launch`` returns.

        Under a profiler each stage is a span of ``utils/profiling.py``
        carrying its batch's id: ``stream.prep`` (the worker), and on this
        thread, inside one ``stream.step`` a batch, ``stream.wait_ingress``
        (waiting for the worker), ``stream.launch``, then for the oldest
        batch ``stream.wait_device`` (the event wait) and ``stream.unmold``,
        inside it ``unmold.pool`` (``n`` the images handed to the pool, also
        counted as ``unmold.pooled_images``), and on the pool's threads each
        image's ``unmold`` and ``unmold.masks``.
        """

        def prep(chunk, batch):
            with profiling.span("stream.prep", batch):
                return self._mold(chunk, batch_size)

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

        # the paste's ring: batch j writes slot j % (depth + 1), which batch
        # j - depth - 1 left when it was drained, a turn before
        ring = [torch.empty(0, dtype=torch.uint8)] * (depth + 1)

        def drain(entry):
            batch, launched, metas, shapes = entry
            if launched.done is not None:
                with profiling.span("stream.wait_device", batch):
                    profiling.host_sync(self.device)
                    launched.done.synchronize()
            with profiling.span("stream.unmold", batch):
                return self._unmold(launched.detections, metas, shapes, launched.pasted)

        # each turn of this thread is a span, so that its waits between stages
        # (for the interpreter lock, say) fall inside one; no span is open
        # across the yields
        inflight: List = []
        try:
            for launched, (batch, future) in enumerate(submitted()):
                with profiling.span("stream.step", batch):
                    with profiling.span("stream.wait_ingress"):
                        molded, metas, shapes = future.result()
                    slot = launched % (depth + 1)
                    with profiling.span("stream.launch"):
                        entry = self._launch(molded, metas, shapes, ring[slot])
                    ring[slot] = entry.pasted.out
                    inflight.append((batch, entry, metas, shapes))
                    ready = drain(inflight.pop(0)) if len(inflight) > depth else []
                yield from ready
            while inflight:
                with profiling.span("stream.step", inflight[0][0]):
                    ready = drain(inflight.pop(0))
                yield from ready
        finally:
            # a consumer that stops early (or an error) leaves batches in
            # flight, and K8 writes their ring slots through the host mapping,
            # which the caching host allocator does not track: wait for them
            # before the ring can be handed to another owner
            for _, entry, _, _ in inflight:
                if entry.done is not None:
                    entry.done.synchronize()
