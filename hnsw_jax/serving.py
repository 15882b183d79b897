"""Serving runtime: request micro-batching over the jitted search pipeline
(SURVEY.md §2b C13 — the production face of "threading/batch runtime").

faiss serves queries by handing each one to an OpenMP thread; the device
analogue is ONE batched program launch, so a serving layer's job is the
inverse of a thread pool's: COLLECT small requests into device-shaped
batches. This module provides that shape discipline:

  * requests of any size are padded to a power-of-two BUCKET, so the jitted
    search executable is reused (one compile per bucket, never per size);
  * many small requests can be coalesced into one launch (``submit`` +
    ``flush``), amortizing the per-launch host/device sync across callers;
  * ``ef_search``/``max_hops`` stay runtime scalars (ops/beam.py ef_live) —
    changing them between requests never recompiles.

No threads are spawned here: JAX dispatch is already async (the host queues
work and returns), so a single-threaded event loop calling ``search``/
``flush`` saturates the chip; thread-safety of *concurrent* submitters is
the caller's concern (wrap in a lock or a queue — deliberately not imposed
here).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def size_bucket(n: int, min_bucket: int = 64,
                max_bucket: int = 8192) -> int:
    """Next power of two >= n, clamped to [min_bucket, max_bucket]. One
    compiled executable per bucket serves every request size inside it."""
    b = 1 << max(int(n - 1).bit_length(), 0)
    return int(min(max(b, min_bucket), max_bucket))


class _Pending(NamedTuple):
    start: int   # row offset inside the coalesced batch
    n: int       # rows belonging to this request


class Searcher:
    """Micro-batching search front-end over any index with
    ``search(x, k, ef_search=...)`` (HnswIndex, ShardedHnswIndex,
    PreTransformIndex, ...).

    Direct mode — one request, padded to its bucket::

        s = Searcher(index, k=10, ef_search=64)
        D, I = s.search(queries)          # any length; no recompiles

    Coalescing mode — many callers, one launch::

        h1 = s.submit(q_small_a)          # queues, returns a handle
        h2 = s.submit(q_small_b)
        s.flush()                         # ONE padded device launch
        D1, I1 = s.result(h1)
        D2, I2 = s.result(h2)
    """

    def __init__(self, index, k: int = 10, *, ef_search: int | None = None,
                 max_hops: int = 0, min_bucket: int = 64,
                 max_bucket: int = 8192):
        self.index = index
        self.k = int(k)
        self.ef_search = ef_search
        self.max_hops = int(max_hops)
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self._device_out = True   # falls to False on first TypeError
        self._queue: list[np.ndarray] = []
        self._pending: dict[int, _Pending] = {}
        self._results: dict[int, tuple] = {}
        self._next_handle = 0
        self._queued_rows = 0
        # serving telemetry
        self.launches = 0
        self.queries_served = 0
        self.rows_padded = 0

    # ------------------------------------------------------------- direct
    def _kw(self, ef_search=None):
        kw = {}
        ef = ef_search if ef_search is not None else self.ef_search
        if ef is not None:
            kw["ef_search"] = int(ef)
        if self.max_hops:
            kw["max_hops"] = self.max_hops
        return kw

    def search(self, x: np.ndarray, *, k: int | None = None,
               ef_search: int | None = None):
        """Single-request path: pad to the size bucket, search, strip.

        Multi-chunk requests are PIPELINED when the index supports
        ``device_out``: every chunk is dispatched before any result is
        materialized, so the per-dispatch host sync of chunk *i* overlaps
        the device compute of chunk *i+1*. Indexes whose ``search`` rejects
        ``device_out`` (e.g. ShardedHnswIndex, which owns its own
        device->host boundary at the fan-out merge) fall back to the
        materialize-per-chunk path."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim == 1:
            x = x[None]
        n = len(x)
        k = self.k if k is None else int(k)
        out_d = np.zeros((n, k), np.float32)
        out_i = np.zeros((n, k), np.int64)
        pending = []     # (start, n_rows, device_d, device_i)
        for s in range(0, n, self.max_bucket):      # huge requests: chunk
            chunk = x[s:s + self.max_bucket]
            b = size_bucket(len(chunk), self.min_bucket, self.max_bucket)
            pad = b - len(chunk)
            xb = np.concatenate([chunk, np.broadcast_to(
                chunk[-1:], (pad, x.shape[1]))]) if pad else chunk
            if self._device_out:
                try:
                    d, i = self.index.search(xb, k, device_out=True,
                                             **self._kw(ef_search))
                except TypeError:    # index doesn't take device_out
                    self._device_out = False
            if not self._device_out:
                d, i = self.index.search(xb, k, **self._kw(ef_search))
            pending.append((s, len(chunk), d, i))
            self.launches += 1
            self.rows_padded += pad
        for s, nr, d, i in pending:  # materialize AFTER all dispatches
            out_d[s:s + nr] = np.asarray(d)[:nr]
            out_i[s:s + nr] = np.asarray(i)[:nr]
        self.queries_served += n
        return out_d, out_i

    # -------------------------------------------------------- coalescing
    def submit(self, x: np.ndarray) -> int:
        """Queue a request; returns a handle for ``result()``. Auto-flushes
        when the queue reaches the max bucket (a full launch is ready)."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim == 1:
            x = x[None]
        h = self._next_handle
        self._next_handle += 1
        self._pending[h] = _Pending(self._queued_rows, len(x))
        self._queue.append(x)
        self._queued_rows += len(x)
        if self._queued_rows >= self.max_bucket:
            self.flush()
        return h

    def flush(self) -> None:
        """Search everything queued in one (or few) padded launches."""
        if not self._queue:
            return
        x = np.concatenate(self._queue, axis=0)
        pend, self._pending = self._pending, {}
        self._queue, self._queued_rows = [], 0
        d, i = self.search(x)
        for h, p in pend.items():
            self._results[h] = (d[p.start:p.start + p.n],
                                i[p.start:p.start + p.n])

    def result(self, handle: int):
        """(D, I) for a submitted request; flushes if still queued."""
        if handle in self._pending:
            self.flush()
        return self._results.pop(handle)

    @property
    def stats(self) -> dict:
        return {"launches": self.launches,
                "queries_served": self.queries_served,
                "rows_padded": self.rows_padded}
