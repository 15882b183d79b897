"""The one platform decision (search.search_engine), the compile-cache
rule the scripts share, and chip_smoke.py's refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from hnsw_jax.search import Engine, search_engine
from hnsw_jax.utils.compile_cache import (DIRNAME, ENV, compile_cache_dir,
                                          use_compile_cache)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_engine_cpu_is_xla():
    assert search_engine("cpu") == Engine(hop="xla", packed_layout="bytes")


def test_engine_gpu_is_xla():
    assert search_engine("gpu") == Engine(hop="xla", packed_layout="bytes")


def test_engine_default_platform_is_the_backend():
    assert search_engine() == search_engine(jax.default_backend())


def test_engine_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="no search engine"):
        search_engine("some-other-accelerator")


def test_no_library_code_runs_pallas_in_interpret_mode():
    """Only tests pass interpret=True: the package never hard-codes it."""
    for p in (ROOT / "hnsw_jax").rglob("*.py"):
        assert "interpret=True" not in p.read_text(), p


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "from-env"))
    assert compile_cache_dir(str(ROOT)) == str(tmp_path / "from-env")
    before = jax.config.jax_compilation_cache_dir
    try:
        # with the variable set, nothing is set in code
        assert use_compile_cache(str(ROOT)) == str(tmp_path / "from-env")
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    want = os.path.join(str(ROOT), DIRNAME)
    assert compile_cache_dir(str(ROOT)) == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert use_compile_cache(str(ROOT)) == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    # the fixed directory is ignored by git
    assert f"{DIRNAME}/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_dryrun_multichip_raises_with_too_few_devices():
    """No silent respawn on a virtual CPU mesh: too few devices is an
    error."""
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        dryrun_multichip(64)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")


@pytest.mark.gpu
def test_search_on_gpu_matches_exact(gpu):
    """The engine as compiled for the card: a small index finds its own
    points and reaches the exact oracle's neighbors."""
    import numpy as np
    import hnsw_jax
    from hnsw_jax.utils.datasets import synthetic_workload
    from hnsw_jax.utils.recall import recall_at_k
    wl = synthetic_workload(4000, 32, n_queries=200, seed=3)
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096, ef_construction=60)
    idx.add(wl.base)
    _, i = idx.search(wl.base[:16], 1, ef_search=32)
    assert (np.asarray(i)[:, 0] == np.arange(16)).all()
    flat = hnsw_jax.FlatIndex(32, "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    _, i = idx.search(wl.queries, 10, ef_search=64)
    assert recall_at_k(np.asarray(i), gt, 10) >= 0.95
