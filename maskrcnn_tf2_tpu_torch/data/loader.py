"""Batching data loader with background prefetch and the copy to the card
(counterpart of ``maskrcnn_tf2_tpu/data/loader.py``).

The host decodes, resizes and pads in a small thread pool; one background
thread keeps ``size`` batches ahead of the training step, and
``prefetch_to_device`` copies them to the card from pinned memory on a side
CUDA stream while the step runs. Images and masks stay uint8 until they are
on the card (a 512x512 image is 0.75 MiB, not 3 MiB in float32); the model,
the augmentation and the targets cast them there.

Randomness: the shuffle draws from ``RandomState(seed)``, one shuffle per
epoch, as the JAX package's loader does, so both visit the images in the same
order; ``skip_epochs`` replays the shuffles of epochs a resumed run has
already trained. Each sample's own draws (the ``max_gt_instances``
subsample, the ``crop`` window, the host augmentation's generators) and each
batch's ``random_rois`` come from generators seeded by (seed, epoch,
position), so they do not depend on the order in which the worker threads
finish.

Multi-process input sharding (JAX ``data/loader.py:39-62, 124-165``):
``config.batch_size`` is the global batch. Every process shuffles the whole
order with the same seed and takes ``host_shard(order, index, count)``
(``order[index::count]``), and loads ``batch_size // count`` images a step.
A sample's position is its position in the whole order, so step for step
the union of the processes' samples is the single-process batch, bit for
bit (as long as no image is skipped). ``epoch(fixed_steps=...)`` cycles a
process's shard to fill a count that every process shares, so that no rank
waits at a collective that another never reaches.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.dataset import SegmentationDataset, load_image_gt
from maskrcnn_tf2_tpu_torch.data.random_rois import generate_random_rois
from maskrcnn_tf2_tpu_torch.device import DeviceLike, resolve_device
from maskrcnn_tf2_tpu_torch.parallel.distributed import host_shard

Batch = Dict[str, np.ndarray]


class DataLoader:
    """Fixed-shape numpy batches: ``images [B, H, W, 3]`` uint8, ``image_meta
    [B, M]``, ``gt_class_ids [B, G]``, ``gt_boxes [B, G, 4]`` normalized,
    ``gt_masks [B, G, mh, mw]`` uint8 and, with ``random_rois``, ``input_rois
    [B, R, 4]``. Images without instances are skipped and the ragged tail is
    dropped.

    ``process_index``/``process_count`` give each process its shard of a
    data-parallel run: ``batch_size`` is then this process's share of
    ``config.batch_size``.
    """

    def __init__(
        self,
        dataset: SegmentationDataset,
        config: MaskRCNNConfig,
        shuffle: bool = True,
        augment_fn=None,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if config.batch_size % process_count:
            raise ValueError(f"batch_size {config.batch_size} does not split over {process_count} processes")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of {process_count}")
        self.dataset = dataset
        self.config = config
        self.shuffle = shuffle
        self.augment_fn = augment_fn
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._epochs = 0  # epochs begun
        self.process_index = process_index
        self.process_count = process_count
        self.batch_size = config.batch_size // process_count
        self._cache_tag: Optional[str] = None

    @property
    def steps_per_epoch(self) -> int:
        """Global steps an epoch: the same on every process."""
        return len(self.dataset) // (self.batch_size * self.process_count)

    def skip_epochs(self, n: int) -> None:
        """Advance as ``n`` epochs would: the next ``epoch()`` draws what it
        would draw after them."""
        for _ in range(n):
            if self.shuffle:
                self._rng.shuffle(np.arange(len(self.dataset)))
            self._epochs += 1

    def _cache_path(self, idx: int) -> str:
        if self._cache_tag is None:
            # every knob load_image_gt reads, and the dataset's identity: each
            # image's registration record (id, path, or a synthetic set's
            # generator parameters), so that a changed configuration or a
            # regenerated dataset of the same length misses
            c = self.config
            ds_ident = [repr(info)[:2000] for info in getattr(self.dataset, "_image_info", [])] or [len(self.dataset)]
            key = repr((c.image_shape, c.image_min_dim, c.image_max_dim, c.image_min_scale, c.image_resize_mode,
                        c.max_gt_instances, c.use_mini_masks, c.mini_mask_shape, c.num_classes, len(self.dataset),
                        ds_ident))
            self._cache_tag = hashlib.md5(key.encode()).hexdigest()[:12]
        tag_dir = os.path.join(self.config.sample_cache_dir, self._cache_tag)
        os.makedirs(tag_dir, exist_ok=True)
        return os.path.join(tag_dir, f"{idx}.npz")

    def _sample(self, idx: int, rng: np.random.RandomState) -> Optional[Dict[str, np.ndarray]]:
        if not self.config.sample_cache_dir or self.augment_fn is not None:
            return load_image_gt(self.dataset, self.config, idx, self.augment_fn, rng)
        # decoded samples cached one npz per image: decoding a JPEG on one core
        # would otherwise starve the card. A host augment_fn needs the
        # full-resolution masks each time, so it bypasses the cache.
        path = self._cache_path(idx)
        if os.path.exists(path):
            with np.load(path) as z:
                return None if "empty" in z.files else {k: z[k] for k in z.files}
        sample = load_image_gt(self.dataset, self.config, idx, None, rng)
        tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:  # through a handle: np.savez(name) appends ".npz"
            if sample is None:
                np.savez(f, empty=np.zeros(1, np.uint8))
            else:
                np.savez(f, **sample)
        os.replace(tmp, path)
        return sample

    def epoch(self, num_workers: int = 4, fixed_steps: Optional[int] = None) -> Iterator[Batch]:
        """One epoch of batches, decoded by ``num_workers`` threads.

        ``fixed_steps``: yield exactly that many batches, cycling this
        process's images if a pass gives fewer."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        epoch = self._epochs
        self._epochs += 1
        index, count = self.process_index, self.process_count
        order = host_shard(order, index, count)
        if fixed_steps and len(order) == 0:
            raise RuntimeError(f"the shard {index}/{count} of a dataset of {len(self.dataset)} is empty but "
                               f"fixed_steps={fixed_steps} batches were requested")

        def index_stream():
            while True:
                yield from order
                if fixed_steps is None:
                    return  # one pass

        stream = enumerate(index_stream())
        window = max(2 * num_workers, self.batch_size)
        buf, yielded, since_yield = [], 0, 0
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            pending: deque = deque()

            def top_up():
                while len(pending) < window:
                    nxt = next(stream, None)
                    if nxt is None:
                        break
                    pos, idx = nxt  # pos: the position in this shard's stream
                    rng = np.random.RandomState([self.seed, epoch, index + pos * count, 0])
                    pending.append(pool.submit(self._sample, int(idx), rng))

            top_up()
            while pending and (fixed_steps is None or yielded < fixed_steps):
                sample = pending.popleft().result()
                top_up()
                since_yield += 1
                if fixed_steps is not None and since_yield > 2 * max(len(order), 1) + self.batch_size:
                    raise RuntimeError(f"too few usable samples to fill a batch of {self.batch_size} "
                                       "(cycled twice without completing one)")
                if sample is None:
                    continue
                buf.append(sample)
                if len(buf) == self.batch_size:
                    # random_rois draw per (step, process): not part of the union's equality
                    rois_seed = [self.seed, epoch, yielded, 1] + ([index] if count > 1 else [])
                    yield self._collate(buf, np.random.RandomState(rois_seed))
                    buf = []
                    yielded += 1
                    since_yield = 0

    def _collate(self, samples, rng: np.random.RandomState) -> Batch:
        batch = {k: np.stack([s[k] for s in samples])
                 for k in ("image", "image_meta", "gt_class_ids", "gt_boxes", "gt_masks")}
        batch["images"] = batch.pop("image")
        if self.config.random_rois:
            batch["input_rois"] = np.stack([
                generate_random_rois(self.config.image_shape, self.config.random_rois, s["gt_boxes"], rng)
                for s in samples
            ])
        return batch


def prefetch(iterator, size: int = 2):
    """Run ``iterator`` in a background thread, at most ``size`` items ahead.
    An exception in the iterator is raised to the consumer; closing the
    consumer (or leaving its loop) stops the thread after its current item."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put((True, item)):
                    return
            put((False, None))
        except Exception as e:  # handed to the consumer, which raises it
            put((False, e))
        finally:
            if hasattr(iterator, "close"):
                iterator.close()

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            more, item = q.get()
            if not more:
                if item is not None:
                    raise item
                return
            yield item
    finally:
        stop.set()


def prefetch_to_device(iterator, size: int = 2, device: DeviceLike = None):
    """``prefetch`` plus the copy of each numpy batch to ``device``. On the
    card: pinned host tensors, ``non_blocking`` copies on a side stream, and
    the consumer's stream waits on the copy's event before the batch is
    handed out. On the CPU: tensors over the numpy arrays."""
    device = resolve_device(device)
    if device.type != "cuda":
        return prefetch(({k: torch.from_numpy(v) for k, v in b.items()} for b in iterator), size)
    stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def consume():
        for out, done in prefetch(map(put, iterator), size):
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for t in out.values():
                t.record_stream(current)  # allocated on the side stream, used on this one
            yield out

    return consume()
