"""Prefetching batch iterator: host transforms overlap the device's steps.

Counterpart of ``open3d_ml_tpu/dataloaders/batch_loader.py``: cloud ids
come from the split sampler's cloud order (else in order), a worker thread
runs each sample's preprocess and transform and collates the batches, and
up to ``prefetch`` batches wait in a queue ahead of the consumer. The
transforms run one after another in that thread, in the order a
synchronous loop would run them, so a seeded run draws the same patches
either way. Moving a batch to the device is the consumer's work.
"""

import queue
import threading


class BatchLoader:
    """Iterable over collated batches.

    Args:
        dataloader: a ``PointCloudDataloader``.
        batch_size: samples per batch.
        batcher: an object with ``collate_fn(list of samples)``.
        num_workers: 0 runs the transforms in the consumer's thread; more
            runs them in one worker thread ahead of it.
        prefetch: batches staged ahead.
        sampler: the cloud sampler whose ``get_cloud_sampler()`` gives the
            order; sequential order without one.
        drop_last: drop a last batch smaller than ``batch_size``.
    """

    def __init__(self, dataloader, batch_size, batcher, num_workers=2,
                 prefetch=2, sampler=None, drop_last=False):
        self.dataloader = dataloader
        self.batch_size = batch_size
        self.batcher = batcher
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.sampler = sampler
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataloader)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_iter(self):
        n = len(self.dataloader)
        if self.sampler is None:
            yield from range(n)
            return
        for count, idx in enumerate(self.sampler.get_cloud_sampler()):
            if count >= n:
                break
            yield idx

    def _batches(self):
        batch = []
        for idx in self._index_iter():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield self.batcher.collate_fn(
                    [self.dataloader[i] for i in batch])
                batch = []
        if batch and not self.drop_last:
            yield self.batcher.collate_fn([self.dataloader[i] for i in batch])

    def __iter__(self):
        if self.num_workers <= 0:
            yield from self._batches()
            return
        q = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()
        error = []

        def put(item):
            # gives up when the consumer has stopped reading
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
            except Exception as exc:  # raised again in the consumer
                error.append(exc)
            put(done)

        worker = threading.Thread(target=producer, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            worker.join()
        if error:
            raise error[0]
