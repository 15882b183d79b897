"""PreTransformIndex — faiss ``IndexPreTransform`` capability parity
(SURVEY.md §1b index-wrappers layer; upstream ``faiss/IndexPreTransform.h``,
not in snapshot — the spec is faiss per /root/reference/README.md:2).

Chains one or more ``VectorTransform``s (ops/transforms.py) in front of any
index: ``train`` trains each untrained transform on the (progressively
transformed) data, then the wrapped index; ``add``/``search`` push vectors
through the chain first. The transforms are matrix products, so the whole
pre-processing stays on device at batch boundaries.
"""

from __future__ import annotations

import numpy as np

from ..ops.transforms import VectorTransform


class PreTransformIndex:
    """faiss ``IndexPreTransform``: ``PreTransformIndex(transform, index)``
    or ``PreTransformIndex([t1, t2], index)`` (applied in order)."""

    def __init__(self, transforms, index):
        if isinstance(transforms, VectorTransform):
            transforms = [transforms]
        self.transforms: list[VectorTransform] = list(transforms)
        self.index = index
        if not self.transforms:
            raise ValueError("PreTransformIndex needs >= 1 transform")
        d = self.transforms[0].d_in
        for t in self.transforms:
            if t.d_in != d:
                raise ValueError(f"transform chain dim mismatch: expected "
                                 f"d_in={d}, got {t.d_in}")
            d = t.d_out
        if d != index.d:
            raise ValueError(f"chain output dim {d} != index dim {index.d}")

    # -- forwarding ------------------------------------------------------
    @property
    def d(self) -> int:
        return self.transforms[0].d_in

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def is_trained(self) -> bool:
        return (all(t.is_trained for t in self.transforms)
                and getattr(self.index, "is_trained", True))

    @property
    def ef_search(self):
        return getattr(self.index, "ef_search", None)

    @ef_search.setter
    def ef_search(self, v):
        self.index.ef_search = v

    def __getattr__(self, name):
        # remaining read-only surface (remove_ids, ntotal-adjacent helpers);
        # guard the two own attributes so a half-built instance can't recurse
        if name in ("index", "transforms"):
            raise AttributeError(name)
        return getattr(self.index, name)

    # -- chain -----------------------------------------------------------
    def apply_chain(self, x: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            x = t.apply(x)
        return x

    def reverse_chain(self, y: np.ndarray) -> np.ndarray:
        for t in reversed(self.transforms):
            y = t.reverse_transform(y)
        return y

    def train(self, x: np.ndarray) -> None:
        """Train each untrained transform on the progressively transformed
        data, then the wrapped index (faiss IndexPreTransform::train)."""
        x = np.asarray(x, np.float32)
        for t in self.transforms:
            if not t.is_trained:
                t.train(x)
            x = t.apply(x)
        if hasattr(self.index, "train"):
            self.index.train(x)

    def add(self, x: np.ndarray) -> None:
        self.index.add(self.apply_chain(np.asarray(x, np.float32)))

    def search(self, x: np.ndarray, k: int, **kw):
        return self.index.search(
            self.apply_chain(np.asarray(x, np.float32)), k, **kw)

    def range_search(self, x: np.ndarray, radius: float, **kw):
        """NOTE: like faiss, the radius lives in the TRANSFORMED space
        (exact under orthonormal chains for L2; rescaled under whitening)."""
        return self.index.range_search(
            self.apply_chain(np.asarray(x, np.float32)), radius, **kw)

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reverse_chain(
            np.asarray(self.index.reconstruct(key))[None])[0]

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        self.index.save(path)
        blobs: dict[str, np.ndarray] = {"n": np.int64(len(self.transforms))}
        for i, t in enumerate(self.transforms):
            for k, v in t.state().items():
                blobs[f"t{i}.{k}"] = v
        np.savez(path + ".vt.npz", **blobs)

    @classmethod
    def load(cls, path: str, index_cls=None):
        if index_cls is None:
            from .hnsw import HnswIndex
            index_cls = HnswIndex
        with np.load(path + ".vt.npz") as z:
            n = int(z["n"])
            ts = []
            for i in range(n):
                pre = f"t{i}."
                st = {k[len(pre):]: z[k] for k in z.files
                      if k.startswith(pre)}
                ts.append(VectorTransform.from_state(st))
        return cls(ts, index_cls.load(path))
