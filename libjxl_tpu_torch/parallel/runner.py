"""Pluggable parallel runner (JxlParallelRunner analogue).

The reference exposes a function-pointer runner contract
(lib/include/jxl/parallel_runner.h: init once per parallel region, then
`run(opaque, value)` for every item, any thread) with two stock
implementations (thread_parallel_runner.h, resizable_parallel_runner.h).
This module is the same seam for the TPU framework: decode/encode hot
loops call `get_runner().run(fn, n)` instead of instantiating their own
pools, so embedders can install a custom scheduler (or force serial
execution for debugging/determinism checks).

API:
    set_runner(runner | None)      install (None restores the default)
    get_runner() -> Runner
    ThreadRunner(num_workers)      stock pool-backed runner
    SerialRunner()                 in-order, single-thread runner

A Runner only needs `run(fn, n)` — call ``fn(i)`` for every i in
range(n), returning after all completed. Exceptions propagate to the
caller (first one wins, like ThreadPool::Run's Status aggregation).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor


class SerialRunner:
    """Run items in order on the calling thread (NULL runner)."""

    num_workers = 1

    def run(self, fn, n: int) -> None:
        for i in range(n):
            fn(i)


class ThreadRunner:
    """Stock thread-pool runner (thread_parallel_runner.h analogue).
    The pool is created lazily and reused across parallel regions."""

    def __init__(self, num_workers: int | None = None):
        self.num_workers = num_workers or min(32, (os.cpu_count() or 1))
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    def _ensure(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="jxl-runner")
            return self._pool

    def run(self, fn, n: int) -> None:
        if n <= 1 or self.num_workers == 1:
            for i in range(n):
                fn(i)
            return
        pool = self._ensure()
        # list() drains the iterator so worker exceptions re-raise here.
        list(pool.map(fn, range(n)))

    def close(self) -> None:
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


_default = ThreadRunner()
_current: list = [_default]


def get_runner():
    return _current[0]


def set_runner(runner) -> None:
    """Install a custom runner; None restores the stock thread pool."""
    _current[0] = runner if runner is not None else _default
