"""Test configuration: run on the JAX CPU backend with 8 virtual devices so
the full suite (including the sharded-mesh path, SURVEY.md §4 item 5) runs
anywhere, with or without an accelerator. Must run before jax is imported
anywhere."""

import os

# Pin the CPU backend three ways (JAX_PLATFORMS, JAX_PLATFORM_NAME and the
# jax_platforms config below), so no installed accelerator plugin can take
# the tests over.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
# XLA:CPU's AOT loader E-logs a benign feature-string mismatch for every
# persistent-cache hit (the compile side records pseudo-features like
# +prefer-no-scatter that the host-feature probe can't name) — hundreds of
# lines per warm run. Real failures still surface as Python exceptions.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent XLA compile cache: the suite is compile-dominated on a small
# CI host, so warm reruns spend far less time compiling.
jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("HNSW_TEST_CACHE", "/tmp/jaxcache-tests"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hnsw_jax import HnswConfig, NumpyHnsw  # noqa: E402
from hnsw_jax.utils.datasets import synthetic_workload  # noqa: E402


@pytest.fixture(scope="session")
def small_workload():
    """2k x 32-d clustered L2 workload with exact ground truth."""
    wl = synthetic_workload(2000, 32, n_queries=100, metric="l2", seed=7)
    return wl


@pytest.fixture(scope="session")
def small_ip_workload():
    return synthetic_workload(1500, 24, n_queries=80, metric="ip", seed=11)


@pytest.fixture(scope="session")
def host_index(small_workload):
    """NumPy-reference-built HNSW over the small workload (the known-good
    graph used to test the device query engine in isolation)."""
    cfg = HnswConfig(dim=32, m=8, metric="l2", capacity=2048,
                     ef_construction=80, ef_search=64, seed=3)
    idx = NumpyHnsw(cfg)
    idx.add(small_workload.base)
    return idx


@pytest.fixture(scope="session")
def host_ip_index(small_ip_workload):
    cfg = HnswConfig(dim=24, m=8, metric="ip", capacity=2048,
                     ef_construction=80, ef_search=64, seed=5)
    idx = NumpyHnsw(cfg)
    idx.add(small_ip_workload.base)
    return idx


def exact_knn(base: np.ndarray, queries: np.ndarray, k: int, metric: str):
    """NumPy-only exact k-NN oracle (independent of all JAX code paths)."""
    if metric == "ip":
        d = -(queries @ base.T)
    else:
        d = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1) \
            if base.shape[0] * queries.shape[0] < 4_000_000 else (
            (queries ** 2).sum(1)[:, None] + (base ** 2).sum(1)[None, :]
            - 2 * queries @ base.T)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx
