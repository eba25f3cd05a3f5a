"""Host-side loading (copy of neurips2023_soc_tpu/utils/prefetch.py):
`parallel_map` decodes upcoming samples on worker threads, the counterpart of
the reference's DataLoader(num_workers) (reference trainer.py:82-88), and
`prefetch` keeps the next batches decoded and collated on a background thread
while the card runs the current step. Threads suffice: the heavy work (cv2 and
PIL decode, h5 IO, numpy collation) releases the GIL and items stay
in-process, with no pickling."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def parallel_map(fn: Callable[[T], U], items: Sequence[T], num_workers: int = 4) -> Iterator[U]:
    """fn over `items` on `num_workers` threads with at most 2 * num_workers
    calls submitted ahead of the consumer. Results
    come in input order, so the output does not depend on the worker count; a
    worker's exception re-raises at the consuming site. num_workers <= 1 maps
    inline on the caller's thread."""
    if num_workers <= 1:
        for it in items:
            yield fn(it)
        return
    max_in_flight = 2 * num_workers
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending: "queue.SimpleQueue" = queue.SimpleQueue()
        it = iter(items)
        n_in_flight = 0
        done = False
        while True:
            while not done and n_in_flight < max_in_flight:
                try:
                    pending.put(ex.submit(fn, next(it)))
                    n_in_flight += 1
                except StopIteration:
                    done = True
            if n_in_flight == 0:
                return
            yield pending.get().result()
            n_in_flight -= 1


def prefetch(iterable: Iterable[T], buffer_size: int = 2) -> Iterator[T]:
    """Iterate `iterable` on a background thread, keeping up to `buffer_size`
    items ready ahead of the consumer (below 1: no thread, the iterable as it
    is). Order is preserved; an exception raised by the producer re-raises at
    the consuming site. The worker is a daemon thread: abandoning the iterator
    early leaves it blocked on the bounded queue, which is harmless and
    reclaimed at exit."""
    if buffer_size < 1:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)

    def worker():
        try:
            for item in iterable:
                q.put(("item", item))
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
            q.put(("error", e))
            return
        q.put(("end", None))

    threading.Thread(target=worker, daemon=True, name="prefetch").start()
    while True:
        kind, payload = q.get()
        if kind == "end":
            return
        if kind == "error":
            raise payload
        yield payload
