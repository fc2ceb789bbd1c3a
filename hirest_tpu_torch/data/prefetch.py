"""Background prefetch for the host input pipeline.

An own copy of hirest_tpu/data/prefetch.py. The reference overlaps data
loading with compute via DataLoader worker processes
(hirest_dataset.py:610-630). Here the host work (frame decode + resize)
runs in a daemon thread feeding a bounded queue, overlapping with the
device step.

Spans (utils/profiling.py): `prefetch.start`, the thread's creation and
start; `prefetch.wait`, the consumer blocked on its next item; and on the
producer thread `prefetch.produce`, each item built by the source, a
child of the `prefetch.start` span of its iterator (in `spans()` only:
torch.profiler does not record that thread).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from hirest_tpu_torch.utils.profiling import adopt, current, span

_SENTINEL = object()


class PrefetchIterator:
    """Wrap any batch iterable; yields the same items, produced ahead of
    time on a background thread. Exceptions re-raise at the consumption
    point; the thread dies with the iterator."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._error = None
        with span("prefetch.start"):
            self._thread = threading.Thread(
                target=self._fill, args=(iterable, current()), daemon=True)
            self._thread.start()

    def _fill(self, iterable, parent):
        try:
            with adopt(parent):
                items = iter(iterable)
                while True:
                    with span("prefetch.produce"):
                        item = next(items, _SENTINEL)
                    if item is _SENTINEL:
                        break
                    self._queue.put(item)
        except BaseException as e:  # propagate to the consumer
            self._error = e
        finally:
            self._queue.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with span("prefetch.wait"):
            item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    return PrefetchIterator(iterable, depth)
