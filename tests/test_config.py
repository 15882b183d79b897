import math

import pytest

from hnsw_jax import HnswConfig


def test_defaults_match_faiss_semantics():
    cfg = HnswConfig(dim=128, m=32)
    assert cfg.m0 == 64  # faiss M_max0 = 2M
    assert math.isclose(cfg.level_mult, 1.0 / math.log(32))
    assert cfg.ef_construction == 200
    assert cfg.ef_search == 64


def test_json_roundtrip():
    cfg = HnswConfig(dim=96, m=16, metric="ip", capacity=12345,
                     ef_search=99, dtype="bfloat16")
    cfg2 = HnswConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_validation():
    with pytest.raises(ValueError):
        HnswConfig(dim=8, metric="cosine")
    with pytest.raises(ValueError):
        HnswConfig(dim=0)
    with pytest.raises(ValueError):
        HnswConfig(dim=8, dtype="float16")


def test_upper_capacity_auto():
    cfg = HnswConfig(dim=8, m=32, capacity=1_000_000)
    assert cfg.upper_capacity == 4 * 1_000_000 // 32
    tiny = HnswConfig(dim=8, m=32, capacity=100)
    assert tiny.upper_capacity == 100  # clamped to capacity
