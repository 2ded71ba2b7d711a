"""Background-thread batch prefetching.

Kernel launches return before the device finishes, so device work already
overlaps the launching host code; the stream producer (gzip decode and
packing) still runs between launches.  Wrapping the stream in a small
bounded-queue thread overlaps producing batch N+1 with the device working
on batch N.  A copy of ``strainer2_tpu.utils.prefetch`` (pinned by
tests/test_torch_host.py) that adds, for the port's trace
(``utils/observability.py``): the worker thread's name, ``s2-prefetch``,
and a ``prefetch.wait`` stage around each time the consumer waits on the
queue.  The packer records its own ``pack.batch`` stages on the worker.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from strainer2_tpu_torch.utils.observability import stage

T = TypeVar("T")

__all__ = ["prefetch"]

_SENTINEL = object()


def prefetch(stream: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``stream`` on a background thread, ``depth`` items ahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    error: list[BaseException] = []

    def worker():
        try:
            for item in stream:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, name="s2-prefetch", daemon=True)
    t.start()
    while True:
        with stage("prefetch.wait"):
            item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item
