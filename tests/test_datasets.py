import struct

import numpy as np

from hnsw_jax.utils.datasets import (Workload, load_eval_workload, read_fbin,
                                     read_fvecs, read_ivecs,
                                     synthetic_workload)


def _write_fvecs(path, arr):
    with open(path, "wb") as f:
        for row in arr:
            f.write(struct.pack("<i", len(row)))
            f.write(np.asarray(row, np.float32).tobytes())


def _write_ivecs(path, arr):
    with open(path, "wb") as f:
        for row in arr:
            f.write(struct.pack("<i", len(row)))
            f.write(np.asarray(row, np.int32).tobytes())


def test_fvecs_roundtrip(tmp_path):
    arr = np.random.default_rng(0).normal(size=(17, 9)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    _write_fvecs(p, arr)
    np.testing.assert_array_equal(read_fvecs(p), arr)
    np.testing.assert_array_equal(read_fvecs(p, count=5), arr[:5])


def test_ivecs_roundtrip(tmp_path):
    arr = np.random.default_rng(1).integers(0, 1000, size=(7, 10)).astype(
        np.int32)
    p = str(tmp_path / "gt.ivecs")
    _write_ivecs(p, arr)
    np.testing.assert_array_equal(read_ivecs(p), arr)


def test_fbin_roundtrip(tmp_path):
    arr = np.random.default_rng(2).normal(size=(11, 6)).astype(np.float32)
    p = str(tmp_path / "base.fbin")
    with open(p, "wb") as f:
        f.write(struct.pack("<ii", *arr.shape))
        f.write(arr.tobytes())
    np.testing.assert_array_equal(read_fbin(p), arr)
    np.testing.assert_array_equal(read_fbin(p, count=4), arr[:4])


def test_eval_config_loads_real_files_when_present(tmp_path, monkeypatch):
    from hnsw_jax.utils import datasets as ds
    base = np.random.default_rng(3).normal(size=(50, 128)).astype(np.float32)
    q = np.random.default_rng(4).normal(size=(5, 128)).astype(np.float32)
    gt = np.tile(np.arange(10, dtype=np.int32), (5, 1))
    d = tmp_path / "siftsmall"
    d.mkdir()
    _write_fvecs(str(d / "siftsmall_base.fvecs"), base)
    _write_fvecs(str(d / "siftsmall_query.fvecs"), q)
    _write_ivecs(str(d / "siftsmall_groundtruth.ivecs"), gt)

    # shape guard: a file with the wrong row count (vs the published dataset
    # size) must be refused, not silently benched
    import pytest
    with pytest.raises(ValueError, match="expected 10000 rows"):
        load_eval_workload("sift10k", data_dir=str(tmp_path))

    # with the config's expected shape matching the file, it loads
    monkeypatch.setitem(ds._EVAL_CONFIGS["sift10k"], "n", 50)
    wl = load_eval_workload("sift10k", data_dir=str(tmp_path))
    assert wl.name == "sift10k"
    np.testing.assert_array_equal(wl.base, base)
    assert wl.ground_truth is not None


def test_eval_config_falls_back_to_synthetic(tmp_path):
    wl = load_eval_workload("sift10k", data_dir=str(tmp_path / "nope"),
                            n_queries=20)
    assert wl.base.shape == (10_000, 128)
    assert wl.queries.shape == (20, 128)
    assert "synthetic" in wl.name


def test_synthetic_ip_is_normalized():
    wl = synthetic_workload(500, 16, metric="ip", seed=9)
    norms = np.linalg.norm(wl.base, axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
