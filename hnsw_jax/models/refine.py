"""RefineFlatIndex — faiss ``IndexRefineFlat`` capability parity (SURVEY.md
§1b index-wrappers layer; upstream ``faiss/IndexRefine.{h,cpp}``, not in
snapshot — the spec is faiss per /root/reference/README.md:2).

The standard faiss companion to quantized indexes: the wrapped index (e.g.
HNSW over PQ/SQ codes) proposes ``k * k_factor`` candidates per query from
its compressed representation; a raw-f32 flat store reranks them with exact
distances and the top-k survive. Buys back the quantization recall loss for
one extra gather + one small contraction per query.

Device realization: the rerank is one jitted program — gather the [Q, kk]
candidate rows, one ``qd,qkd->qk`` einsum (HIGHEST precision, exact f32),
``lax.top_k``. No host math between the inner search and the final top-k.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import IP, L2


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _rerank(store: jax.Array, queries: jax.Array, ids: jax.Array,
            *, k: int, metric: str):
    """Exact rerank: store [N, d] f32, queries [Q, d], ids [Q, kk] (−1 =
    hole) -> (dists [Q, k], ids [Q, k]) in the package's conventions
    (L2: squared distance ascending; IP: dot descending)."""
    safe = jnp.maximum(ids, 0)
    xb = store[safe]                                        # [Q, kk, d]
    prec = jax.lax.Precision.HIGHEST
    dots = jnp.einsum("qd,qkd->qk", queries, xb,
                      preferred_element_type=jnp.float32, precision=prec)
    if metric == IP:
        score = jnp.where(ids < 0, -jnp.inf, dots)
        top, pos = jax.lax.top_k(score, k)
        return top, jnp.where(jnp.isfinite(top),
                              jnp.take_along_axis(ids, pos, 1), -1)
    sq = jnp.einsum("qkd,qkd->qk", xb, xb,
                    preferred_element_type=jnp.float32, precision=prec)
    qsq = jnp.einsum("qd,qd->q", queries, queries,
                     preferred_element_type=jnp.float32, precision=prec)
    dist = jnp.where(ids < 0, jnp.inf, qsq[:, None] + sq - 2.0 * dots)
    top, pos = jax.lax.top_k(-dist, k)
    return -top, jnp.where(jnp.isfinite(top),
                           jnp.take_along_axis(ids, pos, 1), -1)


class RefineFlatIndex:
    """faiss ``IndexRefineFlat``: exact-rerank wrapper over any index.

    ``k_factor`` (mutable, faiss parity) controls how many candidates the
    wrapped index proposes per returned result."""

    def __init__(self, index, k_factor: float = 4.0):
        self.index = index
        self.k_factor = float(k_factor)
        self._chunks: list[np.ndarray] = []
        self._store = None

    # -- forwarding --------------------------------------------------------
    @property
    def d(self) -> int:
        return self.index.d

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def is_trained(self) -> bool:
        return getattr(self.index, "is_trained", True)

    @property
    def metric(self) -> str:
        return getattr(self.index, "metric", None) or \
            getattr(self.index.config, "metric", L2)

    def __getattr__(self, name):
        if name in ("index",):
            raise AttributeError(name)
        return getattr(self.index, name)

    def train(self, x: np.ndarray) -> None:
        if hasattr(self.index, "train"):
            self.index.train(x)

    # -- add/search ----------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        self.index.add(x)        # validates shape / trained state first
        self._chunks.append(x)
        self._store = None

    def _materialize(self) -> jax.Array:
        if self._store is None:
            host = (np.concatenate(self._chunks, 0) if self._chunks
                    else np.zeros((0, self.d), np.float32))
            self._store = jnp.asarray(host)
        return self._store

    def search(self, x: np.ndarray, k: int, **kw):
        kk = max(int(round(k * self.k_factor)), k)
        kk = min(kk, max(self.ntotal, 1))
        _, ids = self.index.search(x, kk, **kw)
        ids = np.asarray(ids, np.int32)
        if ids.shape[1] < k:     # tiny index: pad holes so top_k(k) is legal
            ids = np.pad(ids, ((0, 0), (0, k - ids.shape[1])),
                         constant_values=-1)
        store = self._materialize()
        if store.shape[0] == 0:
            n = len(x)
            return (np.full((n, k), np.inf, np.float32),
                    np.full((n, k), -1, np.int64))
        d, i = _rerank(store, jnp.asarray(np.asarray(x, np.float32)),
                       jnp.asarray(ids), k=k, metric=self.metric)
        return np.asarray(d), np.asarray(i, np.int64)

    def reconstruct(self, i: int) -> np.ndarray:
        return np.asarray(self._materialize()[i], np.float32)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        self.index.save(path)
        host = (np.concatenate(self._chunks, 0) if self._chunks
                else np.zeros((0, self.d), np.float32))
        np.savez(path + ".rflat.npz", store=host,
                 k_factor=np.float64(self.k_factor))

    @classmethod
    def load(cls, path: str, index_cls=None):
        if index_cls is None:
            from .hnsw import HnswIndex
            index_cls = HnswIndex
        with np.load(path + ".rflat.npz") as z:
            store = z["store"]
            kf = float(z["k_factor"])
        out = cls(index_cls.load(path), k_factor=kf)
        if len(store):
            out._chunks = [store]
        return out
