"""Prefetching host batch pipeline.

Counterpart of ``jmt_tpu/data/loader.py`` ``PrefetchLoader``: a producer
thread materializes and collates batches (and joins the wavLM features)
up to ``prefetch`` ahead of the consumer, in the order of one numpy
shuffle per epoch; the last batch may be short (the Runner pads it). An
exception in the producer re-raises in the consumer. ``wait_seconds`` accumulates the time the consumer spent
blocked on the queue: the loader wait that a train epoch reports.

``host_shard=(rank, world)`` splits the sample order over ranks: every
rank shuffles alike (the same ``rng`` seed), takes the stride
``order[rank::world]`` (disjoint and exhaustive over the ranks), and
yields the longest rank's batch count, a short rank ending in filler
batches (one sample, ``n_valid = 0``: all weight-0 padding), so that the
ranks run their collectives in lockstep.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from jmt_tpu_torch.data.datasets import Batch, collate

_SENTINEL = object()


class PrefetchLoader:
    """Iterate collated batches with up to ``prefetch`` prepared ahead."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 rng: Optional[np.random.Generator] = None,
                 wavlm_store=None, prefetch: int = 2, host_shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng
        self.wavlm_store = wavlm_store
        self.prefetch = max(1, prefetch)
        self.host_shard = host_shard
        self.wait_seconds = 0.0

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            (self.rng or np.random.default_rng()).shuffle(order)
        if self.host_shard is not None:
            idx, count = self.host_shard
            order = order[idx::count]
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.host_shard is not None:
            n = -(-n // self.host_shard[1])  # the longest rank's samples
        return -(-n // self.batch_size)

    def _index_batches(self):
        order = self._order()
        emitted = 0
        for i in range(0, len(order), self.batch_size):
            yield order[i:i + self.batch_size]
            emitted += 1
        for _ in range(emitted, len(self)):  # lockstep filler
            yield order[:0]

    def __iter__(self) -> Iterator[Batch]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx in self._index_batches():
                    if len(idx) == 0:  # lockstep filler: all padding
                        batch = collate([self.dataset[0]])
                        batch.n_valid = 0
                    else:
                        batch = collate([self.dataset[int(j)]
                                         for j in idx])
                    if self.wavlm_store is not None:
                        batch.wavlm = self.wavlm_store.lookup_batch(
                            batch.wav_paths)
                    if not put(batch):
                        return
                put(_SENTINEL)
            except Exception as e:  # handed to the consumer, which raises
                put(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="jmt-loader")
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = out_q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is _SENTINEL:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)
