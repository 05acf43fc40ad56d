"""Host-streaming batch pipeline for datasets larger than the card's memory
(counterpart of ``pmpu_tpu/data/pipeline.py``; ``--stream``).

The default training path keeps the view stacks on the card and gathers
every batch there. ``--stream`` instead gathers each batch on the host from
the host-resident ``VolumeStore`` with numpy (``gather_host_batch``, the
JAX package's numpy gather, not a kernel's plain version), in a producer
thread, into pinned buffers; the copy to the card runs asynchronously on a
side CUDA stream, and the compute stream waits for it on an event, so the
card does not wait for the host while the next batches are prepared.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.inference.engine import HostPool


def gather_host_batch(images: np.ndarray, labels: np.ndarray, triples, image_dtype=torch.float32,
                      mask_dtype=torch.int32, out=None):
    """(N,S,S,S) images and labels (numpy, memmaps too), (B,3) rows (scan,
    view, slice) → ((B,S,S,1) image planes each divided by its max, left as
    they are where the max is 0; (B,S,S,1) label planes) as CPU tensors of
    the wire dtypes (JAX :21). Each row is normalized in f32 with numpy and
    written straight into ``out`` (or new tensors): bf16 rounds to nearest
    even, as ``ml_dtypes`` does; uint8 masks are for labels in [0, 256)."""
    triples = np.asarray(triples)
    b, s = triples.shape[0], images.shape[-1]
    img_out, msk_out = out if out is not None else (
        torch.empty((b, s, s, 1), dtype=image_dtype), torch.empty((b, s, s, 1), dtype=mask_dtype))
    for r, (scan, view, sl) in enumerate(triples):
        vol, lab = images[scan], labels[scan]
        if view == 0:
            im, mk = vol[sl, :, :], lab[sl, :, :]
        elif view == 1:
            im, mk = vol[:, sl, :], lab[:, sl, :]
        else:
            im, mk = vol[:, :, sl], lab[:, :, sl]
        m = im.max()
        img_out[r, :, :, 0] = torch.from_numpy(np.ascontiguousarray(im / m if m != 0 else im))
        msk_out[r, :, :, 0] = torch.from_numpy(np.ascontiguousarray(mk))
    return img_out, msk_out


class PrefetchPipeline:
    """Prefetching host → device batch stream (JAX :46).

    ``iterate(batches_of_triples)`` yields (images, masks) on ``device``
    while a producer thread gathers the next ``depth`` batches. On the card
    each batch is gathered into pinned buffers and copied on a side stream;
    a buffer is written again only after its copy's event has completed,
    and each device tensor is ``record_stream``-ed on the compute stream
    that reads it. A producer error is raised in the consumer; closing the
    generator early stops the producer."""

    def __init__(self, store, depth: int = 2, image_dtype=torch.float32,
                 mask_dtype=torch.int32, device=None):
        self.images = store.images
        self.labels = store.labels
        self.depth = depth
        self.image_dtype = image_dtype
        self.mask_dtype = mask_dtype
        self.device = resolve_device(device)
        # taken and given back on the producer thread only; on the CPU the
        # yielded tensors are the host buffers, so none is given back
        self.pool = HostPool(pinned=self.device.type == "cuda")

    def _upload(self, batch, side):
        """Producer thread: start the copies of ``batch`` on ``side``."""
        with torch.cuda.stream(side):
            out = tuple(t.to(self.device, non_blocking=True) for t in batch)
            done = torch.cuda.Event()
            done.record(side)
        for t in batch:
            self.pool.give(t, done)
        return out + (done,)

    def iterate(self, triple_batches):
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        s = self.images.shape[-1]
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        end, closing = object(), threading.Event()

        def put(item):
            while not closing.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            # an error must reach the consumer: a bare end marker would
            # silently cut the epoch short
            try:
                for triples in triple_batches:
                    if closing.is_set():
                        return
                    shape = (len(triples), s, s, 1)
                    bufs = (self.pool.take(shape, self.image_dtype),
                            self.pool.take(shape, self.mask_dtype))
                    batch = gather_host_batch(self.images, self.labels, triples, out=bufs)
                    if cuda:
                        with torch.cuda.device(self.device):
                            batch = self._upload(batch, side)
                    put(batch)
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                put(e)
            else:
                put(end)

        thread = threading.Thread(target=producer, name="prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                if cuda:
                    imgs, msks, done = item
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(done)
                    imgs.record_stream(compute)
                    msks.record_stream(compute)
                    item = (imgs, msks)
                yield item
        finally:
            closing.set()
            thread.join()
