"""Host-side input plumbing: the bounded background prefetcher.

The tfrecord dataset, JPEG decode and the native IO layer of the JAX
package arrive with the CLI slice; the detect loop takes any iterable of
batch dictionaries meanwhile.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Bounded background prefetch: overlaps host decode with device steps.

    Exceptions raised in the producer (corrupt records, decode failures)
    are re-raised in the consumer — a failing pipeline must never look
    like a clean end-of-stream."""

    def __init__(self, iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._iterable = iterable
        self._done = object()
        self._error = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._iterable:
                self._q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._error is not None:
                    raise self._error
                return
            yield item
