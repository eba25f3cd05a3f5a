"""Host-side prefetch (copy of neurips2023_soc_tpu/utils/prefetch.py's
`prefetch`): a background thread keeps the next batches decoded and collated
while the card runs the current step. Threads suffice: the heavy work
(numpy collation, decode, IO) releases the GIL and items stay in-process."""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


BUFFER_SIZE = 2


def prefetch(iterable: Iterable[T]) -> Iterator[T]:
    """Iterate `iterable` on a background thread, keeping up to BUFFER_SIZE
    items ready ahead of the consumer. Order is preserved; an exception
    raised by the producer re-raises at the consuming site. The worker is a
    daemon thread: abandoning the iterator early leaves it blocked on the
    bounded queue, which is harmless and reclaimed at exit."""
    q: "queue.Queue" = queue.Queue(maxsize=BUFFER_SIZE)

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
