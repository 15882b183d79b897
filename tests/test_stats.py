import numpy as np

from hnsw_jax.utils.stats import HnswStats


class _FakeStats:
    def __init__(self, hops, ndis):
        self.hops = hops
        self.ndis = np.asarray(ndis)


def test_accumulate_and_summary():
    st = HnswStats()
    st.accumulate(100, _FakeStats(40, np.full(100, 500)), wall=0.05)
    st.accumulate(100, _FakeStats(60, np.full(100, 700)), wall=0.07)
    s = st.summary()
    assert s["nqueries"] == 200
    assert s["hops_per_batch"] == 50
    assert s["ndis_per_query"] == 600
    assert abs(s["qps"] - 200 / 0.12) < 1
    st.reset()
    assert st.nqueries == 0
