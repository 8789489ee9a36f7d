"""High-level inference API: ``Predictor.detect`` and the pipelined
``Predictor.detect_stream`` (counterpart of ``maskrcnn_tf2_tpu/predictor.py``).

Host preprocessing -> one batched forward on the device (uint8 images go up,
normalization happens there) -> the class-mask gather on the device -> on
the card, the masks pasted into each original image by one kernel
(``kernels/paste_masks.py``, K8) straight into pinned host memory -> host
unmold, which then only copies each image's masks out, the images of a
batch side by side on a pool of host threads. On a CPU device the host
unmolds as before, one mask at a time.

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
    """One batch's masks as K8 pasted them into pinned host memory: image
    ``i``'s ``[H0, W0, kept[i]]`` bytes at ``out[offsets[i]:]``. ``kept`` is
    the kernel's count on the card until the batch is fetched."""

    out: torch.Tensor
    offsets: np.ndarray
    kept: torch.Tensor


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

    def _paste(self, detections, masks, metas: np.ndarray, shapes, staging: torch.Tensor) -> Pasted:
        """Launch K8 on the forward's outputs of the first ``len(shapes)``
        images (the rest is the stream's padding) into ``staging``, pinned
        host memory, replaced by a larger buffer if it is short (PyTorch's
        caching host allocator hands a freed one back, so a buffer is pinned
        once in the process). The meta rows and the block offsets go up from
        pinned memory without a host wait."""
        b, device = len(shapes), detections.device
        pin = device.type == "cuda"
        offsets, total, largest = paste_masks.block_layout([s[:2] for s in shapes], detections.shape[1])
        if staging.numel() < total:
            staging = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
        up = [torch.from_numpy(a) for a in (np.ascontiguousarray(metas[:b]), offsets)]
        if pin:
            up = [t.pin_memory().to(device, non_blocking=True) for t in up]
        with profiling.span("paste"):
            kept = paste_masks.paste_masks(detections[:b], masks[:b], up[0], up[1], self.config.image_shape,
                                           staging[:total], largest)
        return Pasted(staging, offsets, kept)

    def _unmold(self, detections, masks, metas, shapes, pasted: Optional[Pasted] = None
                ) -> List[Dict[str, np.ndarray]]:
        """Host unmold of each image; with ``pasted`` (its ``kept`` on the
        host), each image's masks are copied out of K8's blocks, and the
        images of a batch of several on the unmold pool, side by side (numpy
        lets go of the interpreter lock while it copies). Returns, or raises
        the first error in input order, only once every copy has ended: K8
        may then write the blocks again."""
        if pasted is None:
            return [unmold_detections(detections[i], masks[i], shape, self.config.image_shape, metas[i][7:11])
                    for i, shape in enumerate(shapes)]
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
            molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(images)))
            metas = np.stack(metas)
            shapes = [img.shape for img in images]
            detections, masks = self._forward(np.stack(molded), metas)
            if detections.device.type != "cuda":
                with profiling.span("fetch"):
                    detections, masks = detections.numpy(), masks.numpy()
                return self._unmold(detections, masks, metas, shapes)
            pasted = self._paste(detections, masks, metas, shapes, torch.empty(0, dtype=torch.uint8))
            with profiling.span("fetch"):
                profiling.host_sync(detections.device, 2)
                detections, kept = detections.cpu().numpy(), pasted.kept.cpu().numpy()
            return self._unmold(detections, None, metas, shapes, pasted._replace(kept=kept))

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
        thread, then K8, which pastes the batch's masks into its slot of a
        ring of ``depth + 1`` pinned host buffers (reused for the whole
        stream), the detections and the kept counts copied into new pinned
        host tensors with ``non_blocking=True`` and a CUDA event recorded
        after the copies, so that up to ``depth`` batches stay in flight; (3)
        the oldest batch drained: wait on its event, then unmold, which
        copies each image's masks out of the ring on the unmold pool's
        threads and returns when every copy has ended. The ragged tail is padded
        with zero images and the last meta, so the shapes never change (K8
        skips the padding). On a CPU device there is no event, the copies are
        plain and the host pastes the masks.

        Under a profiler each stage is a span of ``utils/profiling.py``
        carrying its batch's id: ``stream.prep`` (the worker), and on this
        thread, inside one ``stream.step`` a batch, ``stream.wait_ingress``
        (waiting for the worker), ``stream.launch``, then for the oldest
        batch ``stream.wait_device`` (the event wait) and ``stream.unmold``,
        inside it ``unmold.pool`` (``n`` the images handed to the pool, also
        counted as ``unmold.pooled_images``), and on the pool's threads each
        image's ``unmold`` and ``unmold.masks``.
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

        # K8's pinned ring: batch j writes slot j % (depth + 1), which batch
        # j - depth - 1 left when it was drained, a turn before
        ring = [torch.empty(0, dtype=torch.uint8)] * (depth + 1)

        def launch(molded, metas, shapes, slot):
            with profiling.span("stream.launch"):
                detections, masks = self._forward(molded, metas)
                if not cuda:
                    return detections.numpy(), masks.numpy(), None, None
                pasted = self._paste(detections, masks, metas, shapes, ring[slot])
                ring[slot] = pasted.out
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (detections, pasted.kept)]
                for h, t in zip(host, (detections, pasted.kept)):
                    h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                return host[0].numpy(), None, done, pasted._replace(kept=host[1].numpy())

        def drain(entry):
            batch, detections, masks, done, pasted, metas, shapes = entry
            if done is not None:
                with profiling.span("stream.wait_device", batch):
                    profiling.host_sync(self.device)
                    done.synchronize()
            with profiling.span("stream.unmold", batch):
                return self._unmold(detections, masks, metas, shapes, pasted)

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
                    inflight.append((batch,) + launch(molded, metas, shapes, slot) + (metas, shapes))
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
            for entry in inflight:
                if entry[3] is not None:
                    entry[3].synchronize()
