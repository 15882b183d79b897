"""ann-benchmarks adapter — plugs hnsw_jax into the standard ANN evaluation
harness (the protocol BASELINE.json:9 names for the GloVe config; upstream
https://github.com/erikbern/ann-benchmarks, ``ann_benchmarks.algorithms.
base.module.BaseANN`` interface).

ann-benchmarks is not installable in this environment (zero egress), so the
adapter targets its *interface contract* rather than importing it:

  * ``__init__(metric, method_param)``  metric: "euclidean" | "angular"
  * ``fit(X)``                          build the index on the train set
  * ``set_query_arguments(ef)``         per-sweep-point runtime knob
  * ``query(q, n)`` / ``batch_query(X, n)`` + ``get_batch_results()``
  * ``get_memory_usage()``              kB, for the memory column
  * ``done()``

Drop this file into ``ann_benchmarks/algorithms/hnsw_jax/module.py`` of an
ann-benchmarks checkout (plus a config.yml declaring the module) to run the
standard recall/QPS plots against faiss/hnswlib on the same machine.

Angular parity note: ann-benchmarks expects angular distance on normalized
vectors; we follow the faiss recipe — L2-normalize (NormalizationTransform)
in front of an IP-metric index.

A self-test runs under pytest (tests/test_datasets.py imports nothing from
here; see tests/test_ann_benchmarks_adapter.py).
"""

from __future__ import annotations

import numpy as np


class HnswTpu:
    """BaseANN-contract adapter over hnsw_jax.HnswIndex.

    ``method_param``: {"M": 32, "efConstruction": 200, optional
    "packed_bits": 0|4|8, "dtype": "float32"|"sq8", "batch": 8192}.
    """

    def __init__(self, metric: str, method_param: dict):
        if metric not in ("euclidean", "angular"):
            raise ValueError(f"unsupported ann-benchmarks metric {metric!r}")
        self.metric = metric
        self.m = int(method_param.get("M", 32))
        self.ef_construction = int(method_param.get("efConstruction", 200))
        self.packed_bits = int(method_param.get("packed_bits", 0))
        self.dtype = str(method_param.get("dtype", "float32"))
        self.batch = int(method_param.get("batch", 8192))
        self.ef_search = 64
        self.index = None
        self.res = None
        self.name = (f"hnsw_jax(M={self.m}, efC={self.ef_construction}"
                     + (f", packed{self.packed_bits}" if self.packed_bits
                        else "") + ")")

    # -- build ---------------------------------------------------------------
    def fit(self, X: np.ndarray) -> None:
        import hnsw_jax

        X = np.ascontiguousarray(np.asarray(X, np.float32))
        n, d = X.shape
        inner_metric = "l2" if self.metric == "euclidean" else "ip"
        cap = 1 << max(int(n - 1).bit_length(), 10)
        idx = hnsw_jax.HnswIndex(d, self.m, inner_metric, capacity=cap,
                                 ef_construction=self.ef_construction,
                                 dtype=self.dtype)
        if self.metric == "angular":
            idx = hnsw_jax.PreTransformIndex(
                hnsw_jax.NormalizationTransform(d), idx)
        if not idx.is_trained:
            idx.train(X)
        idx.add(X)
        if self.packed_bits:
            (idx.index if self.metric == "angular" else idx) \
                .enable_packed(bits=self.packed_bits)
        self.index = idx

    # -- query-time knobs ------------------------------------------------------
    def set_query_arguments(self, ef: int) -> None:
        self.ef_search = int(ef)

    # -- queries ---------------------------------------------------------------
    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        _, ids = self.index.search(np.asarray(q, np.float32)[None],
                                   n, ef_search=self.ef_search)
        ids = np.asarray(ids)[0]
        return ids[ids >= 0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        X = np.asarray(X, np.float32)
        outs = []
        for s in range(0, len(X), self.batch):
            _, ids = self.index.search(X[s:s + self.batch], n,
                                       ef_search=self.ef_search)
            outs.append(np.asarray(ids))
        self.res = np.concatenate(outs, axis=0)

    def get_batch_results(self) -> np.ndarray:
        return self.res

    # -- bookkeeping -------------------------------------------------------------
    def get_memory_usage(self) -> float:
        """Resident index bytes (graph + vectors + packed tables), in kB —
        the ann-benchmarks memory column."""
        idx = self.index
        if idx is None:
            return 0.0
        inner = getattr(idx, "index", idx)   # unwrap PreTransformIndex
        total = 0
        for a in inner.graph:
            total += np.asarray(a).nbytes if getattr(a, "ndim", 0) else 4
        total += inner._vectors.size * inner._vectors.dtype.itemsize
        p = inner._packed
        if p is not None:
            total += p.nbr_codes.size * p.nbr_codes.dtype.itemsize
        return total / 1024.0

    def done(self) -> None:
        self.index = None

    def __str__(self) -> str:
        return f"{self.name}[ef={self.ef_search}]"
