"""Host-side prefetching loader.

The reference uses torch DataLoader worker processes
(reference mmdet/datasets/loader/build_loader.py:18); here decode-ahead
worker threads feed a bounded queue so that the card never waits on image
decoding.

Ordering with backpressure: worker ``t`` decodes indices ``t, t+T, t+2T...``
into its own bounded queue; the consumer round-robins, so items arrive in
dataset order and at most ``T * prefetch`` items are decoded ahead.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


def prefetch_ordered(fn, items, prefetch: int = 2,
                     num_threads: int = 2) -> Iterator:
    """Run ``fn(item)`` on worker threads, yielding results strictly in
    ``items`` order with at most ``num_threads * prefetch`` look-ahead.

    Worker ``t`` builds items ``t, t+T, t+2T...`` into its own bounded
    queue; the consumer round-robins, so ordering is deterministic and
    backpressure bounds memory.  Used for raw frame decode
    (:class:`PrefetchLoader`) and whole-train-batch assembly
    (cli/train.py — the reference analog is DataLoader workers,
    reference mmdet/datasets/loader/build_loader.py:18)."""
    items = list(items)
    nt = max(1, num_threads)
    queues = [queue.Queue(maxsize=max(1, prefetch)) for _ in range(nt)]

    def worker(t):
        for i in range(t, len(items), nt):
            try:
                out = fn(items[i])
            except Exception as e:  # propagate to consumer
                queues[t].put(("err", e))
                return
            queues[t].put(("ok", out))

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(nt)]
    for t in threads:
        t.start()
    for i in range(len(items)):
        status, item = queues[i % nt].get()
        if status == "err":
            raise item
        yield item


class PrefetchLoader:
    def __init__(self, dataset, prefetch: int = 2, num_threads: int = 2):
        self.dataset = dataset
        self.prefetch = max(1, prefetch)
        self.num_threads = max(1, num_threads)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        yield from prefetch_ordered(
            lambda i: self.dataset[i], range(len(self.dataset)),
            prefetch=self.prefetch, num_threads=self.num_threads)
