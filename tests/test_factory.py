import pytest

from hnsw_jax import FlatIndex, HnswIndex
from hnsw_jax.factory import index_factory


def test_hnsw_specs():
    idx = index_factory(64, "HNSW16", capacity=1024)
    assert isinstance(idx, HnswIndex)
    assert idx.config.m == 16 and idx.config.m0 == 32
    idx = index_factory(32, "HNSW32,Flat", capacity=512)
    assert idx.config.m == 32
    idx = index_factory(32, "HNSW", metric="ip", capacity=512)
    assert idx.config.metric == "ip" and idx.config.m == 32


def test_flat_spec():
    idx = index_factory(16, "Flat")
    assert isinstance(idx, FlatIndex)


def test_codec_specs():
    idx = index_factory(16, "HNSW32,SQ8", capacity=512)
    assert idx.config.is_sq
    idx = index_factory(16, "HNSW32,PQ8", capacity=512)
    assert idx.config.is_pq and idx.config.pq_m == 8


@pytest.mark.parametrize("spec", ["IVF100,Flat", "", "Flat,Flat",
                                  "HNSW32,PQ5"])
def test_unsupported(spec):
    with pytest.raises(ValueError):
        index_factory(16, spec)
