"""Host-side tile prefetching.

The reference overlaps I/O with compute by returning TensorStore read
futures (`qi2labDataStore._load_from_zarr_array:2239-2269`) and running
one OS process per GPU. Here a small thread pool keeps the next tiles'
zarr reads (zlib decodes release the GIL) in flight while the device
processes the current tile — the host/device double-buffering half of the
pipeline (SURVEY.md §2.9 "Pipeline parallelism" row).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence, TypeVar

T = TypeVar("T")


class TilePrefetcher:
    """Iterate ``(index, load_fn(index))`` with ``depth`` loads in flight."""

    def __init__(
        self,
        load_fn: Callable[[int], T],
        indices: Sequence[int],
        depth: int = 2,
        max_workers: int = 4,
    ):
        self._load_fn = load_fn
        self._indices = list(indices)
        self._depth = max(1, depth)
        self._pool = ThreadPoolExecutor(max_workers=max_workers)

    def __iter__(self) -> Iterator[tuple[int, T]]:
        futures = {}
        try:
            for i in self._indices[: self._depth]:
                futures[i] = self._pool.submit(self._load_fn, i)
            for pos, i in enumerate(self._indices):
                nxt = pos + self._depth
                if nxt < len(self._indices):
                    j = self._indices[nxt]
                    futures[j] = self._pool.submit(self._load_fn, j)
                yield i, futures.pop(i).result()
        finally:
            for f in futures.values():
                f.cancel()
            self._pool.shutdown(wait=False)


class BoundedWriter:
    """Write-behind queue: saves run on one background thread while the
    caller keeps computing, with at most ``depth`` writes (and their
    array references) pending — the write half of the host/device
    pipeline (the reference hides writes inside per-GPU worker processes;
    zlib and file writes release the GIL, so one thread suffices).

    Use as a context manager; exit drains the queue, re-raises the first
    write error (unless another error is already propagating) and shuts
    the thread down. Writes targeting disjoint datastore arrays are safe
    to overlap with reads elsewhere (same structural guarantee the decode
    extraction thread relies on).
    """

    def __init__(self, depth: int = 2):
        import threading
        from collections import deque

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="writer")
        self._pending = deque()
        self._depth = max(1, depth)
        # submit/drain may be called from multiple registration fan-out
        # threads when the writer is a shared deferred-persistence queue
        self._lock = threading.Lock()

    def submit(self, fn: Callable, /, *args, **kwargs) -> None:
        while True:
            with self._lock:
                if len(self._pending) < self._depth:
                    self._pending.append(self._pool.submit(fn, *args, **kwargs))
                    return
                head = self._pending.popleft()
            head.result()  # blocks; re-raises failures

    def drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                head = self._pending.popleft()
            head.result()

    def __enter__(self) -> "BoundedWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.drain()
            else:  # don't mask the original error; still reap the queue
                while True:
                    with self._lock:
                        if not self._pending:
                            break
                        head = self._pending.popleft()
                    try:
                        head.result()
                    except Exception:
                        pass
        finally:
            self._pool.shutdown(wait=True)
