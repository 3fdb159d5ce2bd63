"""Background prefetch for the training input pipeline.

A copy of edgestyle_tpu/data/prefetch.py. The reference overlaps
host-side data work (JPEG decode + augmentation in CollateFn) with device
compute through DataLoader worker processes
(`--dataloader_num_workers`, the reference's
train_text2image_pretrained_openpose.py:426,973).  The port's loaders
are plain numpy generators (data/dataset.py::data_loader); this module
adds the same overlap with threads instead of processes: a daemon thread
keeps a bounded queue of ready batches so the accelerator never waits on
the host, and `parallel_map` fans the per-example image loads over a
thread pool.  Threads suffice because the hot host work —
PIL JPEG decode and numpy array math — releases the GIL; processes would
only add pickling cost for the 10-image examples.

Determinism is preserved: the producer thread runs the *same* generator
in the same order, and `parallel_map` keeps input order, so a prefetched
loader yields byte-identical batches to the synchronous one (tested).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_DONE = object()  # end-of-stream sentinel (also carries errors, see below)


class PrefetchIterator:
    """Wrap any iterator so its items are produced on a background daemon
    thread into a bounded queue (default depth 2 — one batch being
    consumed, one ready, one in flight)."""

    def __init__(self, it: Iterable[T], depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(iter(it),), daemon=True,
            name="edgestyle-prefetch",
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """put() that stays responsive to close(); returns False if
        closed before the item could be enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # propagate to the consumer
            self._err = e
        self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        # timed get + _stop recheck: an untimed get() would hang forever if
        # close() runs from ANOTHER thread while we block on an empty queue
        # (close drains the queue and the producer then returns without
        # enqueuing _DONE)
        while True:
            if self._stop.is_set():
                # close() may have drained the _DONE sentinel before we saw
                # it — surface a stored producer error instead of silently
                # ending the stream
                if self._err is not None:
                    raise self._err
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if item is _DONE:
            self._stop.set()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer thread (idempotent). Safe to call mid-stream —
        the training loop calls this on exit since its source is infinite."""
        self._stop.set()
        # unblock a producer stuck on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def parallel_map(fn: Callable[[T], U], items: Sequence[T],
                 workers: int = 0) -> List[U]:
    """Order-preserving map over a thread pool; workers<=1 degrades to the
    plain list comprehension (no pool, no thread overhead)."""
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def prefetch(it: Iterable[T], depth: int = 2) -> PrefetchIterator:
    """Convenience: wrap `it` in a PrefetchIterator (depth<=0 → identity)."""
    if depth <= 0:
        return it  # type: ignore[return-value]
    return PrefetchIterator(it, depth=depth)
