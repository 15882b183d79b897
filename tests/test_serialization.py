import numpy as np

from hnsw_jax import HnswIndex


def test_save_load_bit_identical_search(tmp_path, host_index, small_workload):
    wl = small_workload
    idx = HnswIndex(config=host_index.cfg, build="host")
    idx._host = host_index
    idx._sync_from_host()

    d1, i1 = idx.search(wl.queries[:50], k=10)
    p = str(tmp_path / "index.npz")
    idx.save(p)
    idx2 = HnswIndex.load(p)
    assert idx2.ntotal == idx.ntotal
    assert idx2.config == idx.config
    d2, i2 = idx2.search(wl.queries[:50], k=10)
    # faiss write_index/read_index parity: round-trip must be bit-identical
    assert (i1 == i2).all()
    np.testing.assert_array_equal(d1, d2)


def test_to_bytes_from_bytes_roundtrip(host_index, small_workload):
    wl = small_workload
    idx = HnswIndex(config=host_index.cfg, build="host")
    idx._host = host_index
    idx._sync_from_host()
    idx.remove_ids(np.arange(5))  # tombstones must ride along in the blob

    blob = idx.to_bytes()
    assert isinstance(blob, bytes) and len(blob) > 1000
    idx2 = HnswIndex.from_bytes(blob)
    assert idx2.ntotal == idx.ntotal and idx2.n_deleted == 5
    d1, i1 = idx.search(wl.queries[:50], k=10)
    d2, i2 = idx2.search(wl.queries[:50], k=10)
    assert (i1 == i2).all()
    np.testing.assert_array_equal(d1, d2)
