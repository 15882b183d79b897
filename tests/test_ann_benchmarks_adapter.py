"""The ann-benchmarks BaseANN-contract adapter (benchmarks/
ann_benchmarks_adapter.py) drives the full protocol: fit -> sweep
set_query_arguments -> batch_query/query -> memory/done."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))

from ann_benchmarks_adapter import HnswTpu  # noqa: E402

from conftest import exact_knn  # noqa: E402
from hnsw_jax.utils.recall import recall_at_k  # noqa: E402


def test_euclidean_protocol():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 16)).astype(np.float32)
    Q = rng.standard_normal((64, 16)).astype(np.float32)
    algo = HnswTpu("euclidean", {"M": 8, "efConstruction": 60})
    algo.fit(X)
    algo.set_query_arguments(96)
    algo.batch_query(Q, 10)
    ids = algo.get_batch_results()
    assert ids.shape == (64, 10)
    _, gt = exact_knn(X, Q, 10, "l2")
    assert recall_at_k(ids, gt, 10) >= 0.9
    # single-query path agrees with the batch path
    one = algo.query(Q[0], 10)
    assert set(one) == set(ids[0][ids[0] >= 0])
    assert algo.get_memory_usage() > 0
    assert "hnsw_jax" in str(algo)
    algo.done()
    assert algo.index is None


def test_angular_protocol():
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((1500, 16)) *
         rng.uniform(0.1, 5.0, (1500, 1))).astype(np.float32)
    Q = rng.standard_normal((32, 16)).astype(np.float32)
    algo = HnswTpu("angular", {"M": 8, "efConstruction": 60})
    algo.fit(X)
    algo.set_query_arguments(96)
    algo.batch_query(Q, 10)
    ids = algo.get_batch_results()
    cos = (Q / np.linalg.norm(Q, axis=1, keepdims=True)) @ \
        (X / np.linalg.norm(X, axis=1, keepdims=True)).T
    gt = np.argsort(-cos, axis=1)[:, :10]
    assert recall_at_k(ids, gt, 10) >= 0.9
    with pytest.raises(ValueError):
        HnswTpu("hamming", {})
