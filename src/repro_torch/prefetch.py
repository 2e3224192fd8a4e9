"""Bounded producer-thread prefetch: the shared double-buffer primitive.

A copy of ``repro.prefetch``. In the port the streaming fit's spool
(``data/streaming.py: PackedChunkSpool``) stages disk pieces through it:
the producer thread reads a piece into pinned host memory and starts its
copy to the card on a side stream.

Two hot paths in this codebase overlap host-side staging with device
compute, and both reduce to the same shape: a producer thread walks a
source iterator, runs a staging function on each item (numpy packing,
disk reads, H2D transfer — all of which release the GIL in their hot
parts), and feeds a bounded queue; the consumer drains the queue and
dispatches device work. ``Prefetcher`` is that shape, extracted from the
serving pipeline (``serving/pipeline.py``) so the streaming fit's H2D
spool reader (``data/streaming.py``) runs the identical, identically
tested machinery instead of a second copy:

* item ORDER is preserved (single producer, FIFO queue) — consumers that
  accumulate floating-point sums see the same summation order as the
  synchronous loop, which is what makes "pipelined == sync bitwise"
  provable;
* ``depth`` bounds the number of staged items in flight (2 = classic
  double buffer), so prefetching never grows the resident working set
  beyond ``depth`` staged items;
* exceptions raised by the source or the stage function surface in the
  consumer at the point of the failed item;
* closing early (consumer error, ``break``) unblocks and joins the
  producer — no leaked threads, no deadlocked ``put``.
"""
from __future__ import annotations

import queue
import threading

_DONE = object()


class Prefetcher:
    """Iterate ``src`` through a bounded queue fed by a daemon thread.

    ``stage`` (optional) is applied to every item ON the producer thread;
    use it for the work that should hide behind the consumer's compute.
    Use as a context manager (or call ``close()``) so the thread is
    always joined::

        with Prefetcher(chunks, depth=2, stage=pack) as items:
            for item in items:
                ...
    """

    def __init__(self, src, depth: int = 2, stage=None, name: str = "prefetch"):
        self._src = src
        self._stage = stage
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts when the consumer has gone away."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._src:
                out = self._stage(item) if self._stage is not None else item
                if not self._put(out):
                    return
            self._put(_DONE)
        except BaseException as exc:  # surface staging errors to the consumer
            self._put(exc)

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                # Nothing queued: only keep waiting while the producer can
                # still deliver. After ``close()`` (stop set) or after an
                # exception/sentinel already drained the queue (thread
                # dead), a bare ``get()`` would block forever. The final
                # non-blocking drain closes the race where the producer
                # enqueued its last item between our timeout and its exit.
                if self._stop.is_set() or not self._thread.is_alive():
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        return
                else:
                    continue
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
