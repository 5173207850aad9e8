"""Host-side streaming for the out-of-core engines (port of
mimo_tpu/io/stream.py).

`Prefetcher` runs the caller's batch producer on a background thread into
a bounded queue, so disk reads and page faults overlap the card's work on
the previous batch. The queue is bounded so a fast producer cannot fill
host memory with decoded batches. Unlike the reference's, `get()` after
the end raises StopIteration again instead of waiting forever for a
sentinel that was already taken.
"""

import queue
import threading

__all__ = ['Prefetcher']

_SENTINEL = object()


class Prefetcher:
    """Iterate `producer(i) for i in range(n)` on a background thread.

    Items come in order. An exception in the producer is re-raised in the
    consumer at the next `get()`, never swallowed. Always `close()` (or
    use as a context manager) to join the thread; abandoning mid-stream
    is safe (the bounded queue blocks the producer, close() drains and
    joins)."""

    def __init__(self, producer, n, depth=2):
        self._q = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._done = False
        self._stop = threading.Event()

        def put(item):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def run():
            try:
                for i in range(n):
                    if self._stop.is_set():
                        return
                    put(producer(i))
            except BaseException as e:   # noqa: BLE001 (re-raised in get)
                self._err = e
            finally:
                put(_SENTINEL)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def get(self):
        """The next item; raises StopIteration at the end (every time it
        is asked past the end) or the producer's error."""
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def close(self):
        self._stop.set()
        try:                       # let a blocked producer see the stop
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5.0)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
