"""Hand-written CUDA kernels: build (``kernels.build``) and launch counts.

Every kernel wrapper calls ``count(<kernel name>)`` right after it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels. ``launches`` holds the counts of the whole
process, ``reset_launches`` sets every count to 0, and ``thread_launches``
also counts, apart, the launches of the thread that opens it: the ranks of
the thread transport (parallel/collectives.py) are threads of one process,
and each one's counts are its own.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Iterator

launches: collections.Counter = collections.Counter()
_lock = threading.Lock()
_local = threading.local()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` launches of ``name`` (exact when several threads launch)."""
    with _lock:
        launches[name] += n
    own = getattr(_local, "counts", None)
    if own is not None:
        own[name] += n


@contextlib.contextmanager
def thread_launches() -> Iterator[collections.Counter]:
    """Within the block, the launches of this thread alone, also counted
    in ``launches``."""
    outer = getattr(_local, "counts", None)
    _local.counts = collections.Counter()
    try:
        yield _local.counts
    finally:
        _local.counts = outer


def reset_launches() -> None:
    with _lock:
        launches.clear()
