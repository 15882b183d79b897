"""Vector transforms — faiss ``VectorTransform`` family capability parity
(SURVEY.md §1b index-wrappers layer; upstream ``faiss/VectorTransform.{h,cpp}``
— not in snapshot; the reference is the 2-line README naming faiss as the
spec, /root/reference/README.md:2).

faiss preprocesses vectors before they reach an index: L2 normalization
(cosine over an IP index), random rotations, PCA (optionally whitening /
rotated), and OPQ — the learned rotation that minimizes product-quantization
error (Ge et al., "Optimized Product Quantization", CVPR 2013).
``PreTransformIndex`` (faiss ``IndexPreTransform``) chains transforms in
front of any index here.

Device realization: every linear transform is one ``[n, d_in] @ [d_in,
d_out]`` matmul — the densest op there is — applied as a jitted
program at ``add``/``search``/``train`` boundaries, so the transformed
vectors stream to the wrapped index with no host math. Training factors
(covariance, the OPQ Procrustes cross-term X^T X̂) are accumulated on device
with ``preferred_element_type=f32``; only the tiny d×d eigendecomposition /
SVD runs on host (numpy), exactly once.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, donate_argnums=())
def _apply_linear(x: jax.Array, a_t: jax.Array, b: jax.Array) -> jax.Array:
    """y = x @ Aᵀ + b as one matrix product (HIGHEST precision: transforms feed
    distance computations whose convention is exact f32)."""
    return jnp.einsum("nd,do->no", x, a_t,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST) + b


class VectorTransform:
    """Base: maps f32 [n, d_in] -> f32 [n, d_out]. faiss parity surface:
    ``is_trained``, ``train(x)``, ``apply(x)``, ``reverse_transform(y)``
    (best-effort inverse, exact for orthonormal maps)."""

    def __init__(self, d_in: int, d_out: int):
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.is_trained = False

    def train(self, x: np.ndarray) -> None:  # pragma: no cover - interface
        self.is_trained = True

    def apply(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reverse_transform(self, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _check(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}], got {x.shape}")
        if not self.is_trained:
            raise RuntimeError(f"{type(self).__name__} must be trained "
                               "before apply() (faiss VectorTransform "
                               "parity)")
        return x

    # persistence: each transform serializes to a dict of arrays + kind tag
    def state(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_state(st: dict) -> "VectorTransform":
        kind = str(st["kind"])
        cls = {"l2norm": NormalizationTransform,
               "linear": LinearTransform,
               "rr": RandomRotation,
               "pca": PCAMatrix,
               "opq": OPQMatrix}[kind]
        return cls._from_state(st)


class NormalizationTransform(VectorTransform):
    """faiss ``NormalizationTransform`` (factory ``L2norm``): row-normalize.
    In front of an IP index this turns inner product into cosine similarity
    — the standard faiss recipe for cosine/angular metrics."""

    def __init__(self, d: int, norm: float = 2.0):
        super().__init__(d, d)
        self.norm = float(norm)
        self.is_trained = True  # train-free

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = self._check(x)
        n = np.linalg.norm(x, ord=self.norm, axis=1, keepdims=True)
        return x / np.maximum(n, 1e-20)

    def reverse_transform(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, np.float32)  # scale is lost; direction kept

    def state(self) -> dict:
        return {"kind": "l2norm", "d": np.int64(self.d_in),
                "norm": np.float64(self.norm)}

    @classmethod
    def _from_state(cls, st: dict):
        return cls(int(st["d"]), float(st["norm"]))


class LinearTransform(VectorTransform):
    """y = A x + b with A [d_out, d_in] (faiss ``LinearTransform``). The
    apply path is one jitted matmul; ``reverse_transform`` uses Aᵀ,
    exact when A is orthonormal (all built-in trainers produce orthonormal
    rows)."""

    def __init__(self, d_in: int, d_out: int,
                 a: np.ndarray | None = None, b: np.ndarray | None = None):
        super().__init__(d_in, d_out)
        self.a = None if a is None else np.asarray(a, np.float32)
        self.b = (np.zeros(d_out, np.float32) if b is None
                  else np.asarray(b, np.float32))
        if self.a is not None:
            if self.a.shape != (d_out, d_in):
                raise ValueError(f"A shape {self.a.shape} != "
                                 f"{(d_out, d_in)}")
            self.is_trained = True

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = self._check(x)
        return np.asarray(_apply_linear(jnp.asarray(x),
                                        jnp.asarray(self.a.T),
                                        jnp.asarray(self.b)))

    def reverse_transform(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, np.float32)
        return np.asarray(_apply_linear(jnp.asarray(y - self.b),
                                        jnp.asarray(self.a),
                                        jnp.zeros(self.d_in, jnp.float32)))

    def state(self) -> dict:
        return {"kind": "linear", "a": self.a, "b": self.b}

    @classmethod
    def _from_state(cls, st: dict):
        a = np.asarray(st["a"])
        return cls(a.shape[1], a.shape[0], a=a, b=np.asarray(st["b"]))


def _random_rotation(d_in: int, d_out: int, seed: int) -> np.ndarray:
    """Orthonormal [d_out, d_in] (rows) via QR of a seeded Gaussian —
    sign-fixed so the draw is deterministic across BLAS builds."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((d_in, max(d_in, d_out))).astype(np.float64)
    q, r = np.linalg.qr(g)
    q = q * np.sign(np.diagonal(r))[None, :]
    return np.ascontiguousarray(q[:, :d_out].T.astype(np.float32))


class RandomRotation(LinearTransform):
    """faiss ``RandomRotationMatrix`` (factory ``RR{d}``): a seeded
    orthonormal rotation/projection, train-free."""

    def __init__(self, d_in: int, d_out: int | None = None, seed: int = 42):
        d_out = d_in if d_out is None else int(d_out)
        self.seed = int(seed)
        super().__init__(d_in, d_out, a=_random_rotation(d_in, d_out, seed))

    def state(self) -> dict:
        return {"kind": "rr", "a": self.a, "b": self.b,
                "seed": np.int64(self.seed)}

    @classmethod
    def _from_state(cls, st: dict):
        a = np.asarray(st["a"])
        t = cls(a.shape[1], a.shape[0], seed=int(st["seed"]))
        t.a, t.b = a, np.asarray(st["b"])
        return t


@functools.partial(jax.jit, static_argnames=("chunk",))
def _mean_cov(x: jax.Array, *, chunk: int):
    """Streaming (sum, Xᵀ X) over n-chunks as matmuls; caller centers."""
    n, d = x.shape

    def step(carry, xt):
        s, g = carry
        return (s + jnp.sum(xt, axis=0),
                g + jnp.einsum("nd,ne->de", xt, xt,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)), None

    init = (jnp.zeros(d, jnp.float32), jnp.zeros((d, d), jnp.float32))
    (s, g), _ = jax.lax.scan(step, init, x.reshape(-1, chunk, d))
    return s, g


class PCAMatrix(LinearTransform):
    """faiss ``PCAMatrix`` (factory ``PCA{d}`` / ``PCAW{d}`` whitened /
    ``PCAR{d}`` + random rotation): center, project onto the top ``d_out``
    eigenvectors of the covariance, optionally scale by λ^eigen_power
    (whitening = -0.5) and re-rotate. Covariance is accumulated on device
    (one [d, d] einsum over n-chunks); the d×d ``eigh`` runs on host."""

    def __init__(self, d_in: int, d_out: int, *, eigen_power: float = 0.0,
                 random_rotation: bool = False, seed: int = 42):
        if d_out > d_in:
            raise ValueError(f"PCA d_out {d_out} > d_in {d_in}")
        VectorTransform.__init__(self, d_in, d_out)
        self.a, self.b = None, np.zeros(d_out, np.float32)
        self.eigen_power = float(eigen_power)
        self.random_rotation = bool(random_rotation)
        self.seed = int(seed)
        self.eigenvalues: np.ndarray | None = None

    def train(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}], got {x.shape}")
        n = len(x)
        if n < self.d_out:
            raise ValueError(f"PCA training needs >= d_out={self.d_out} "
                             f"points, got {n}")
        chunk = min(n, 65536)
        pad = (-n) % chunk
        xp = np.concatenate([x, np.zeros((pad, self.d_in), np.float32)]) \
            if pad else x
        s, g = _mean_cov(jnp.asarray(xp), chunk=chunk)
        mean = np.asarray(s, np.float64) / n
        cov = np.asarray(g, np.float64) / n - np.outer(mean, mean)
        w, v = np.linalg.eigh(cov)                    # ascending
        w, v = w[::-1][: self.d_out], v[:, ::-1][:, : self.d_out]
        a = v.T                                       # [d_out, d_in] rows
        if self.eigen_power != 0.0:
            a = a * np.maximum(w, 1e-10)[:, None] ** self.eigen_power
        if self.random_rotation:
            a = _random_rotation(self.d_out, self.d_out, self.seed) @ a
        self.eigenvalues = w.astype(np.float32)
        self.a = np.ascontiguousarray(a.astype(np.float32))
        self.b = -(self.a @ mean.astype(np.float32))
        self.is_trained = True

    def state(self) -> dict:
        return {"kind": "pca", "a": self.a, "b": self.b,
                "eigen_power": np.float64(self.eigen_power),
                "random_rotation": np.bool_(self.random_rotation),
                "seed": np.int64(self.seed),
                "eigenvalues": (self.eigenvalues if self.eigenvalues
                                is not None else np.zeros(0, np.float32))}

    @classmethod
    def _from_state(cls, st: dict):
        a = np.asarray(st["a"])
        t = cls(a.shape[1], a.shape[0],
                eigen_power=float(st["eigen_power"]),
                random_rotation=bool(st["random_rotation"]),
                seed=int(st["seed"]))
        t.a, t.b = a, np.asarray(st["b"])
        ev = np.asarray(st["eigenvalues"])
        t.eigenvalues = ev if ev.size else None
        t.is_trained = True
        return t


@functools.partial(jax.jit, static_argnames=("chunk",))
def _cross_term(x: jax.Array, xh: jax.Array, *, chunk: int):
    """Xᵀ X̂ for the OPQ Procrustes step, streamed as matmuls."""
    n, d_in = x.shape
    d_out = xh.shape[1]

    def step(g, args):
        xt, xht = args
        return g + jnp.einsum("nd,ne->de", xt, xht,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST), None

    g, _ = jax.lax.scan(step, jnp.zeros((d_in, d_out), jnp.float32),
                        (x.reshape(-1, chunk, d_in),
                         xh.reshape(-1, chunk, d_out)))
    return g


class OPQMatrix(LinearTransform):
    """faiss ``OPQMatrix`` (factory ``OPQ{m}`` / ``OPQ{m}_{d}``): the
    learned orthonormal rotation minimizing PQ reconstruction error,
    trained by the non-parametric alternation of Ge et al. (CVPR 2013) —
    the same scheme faiss uses:

        repeat: (1) few Lloyd iterations of the m-subspace PQ on X R;
                (2) X̂ = decode(encode(X R)); solve the orthogonal
                    Procrustes problem min_R ‖X R − X̂‖_F via the SVD of
                    Xᵀ X̂ (host, d×d); R ← U Vᵀ.

    On the device the expensive parts — PQ assignment/update and the Xᵀ X̂
    cross-term — are the existing batched k-means program (ops/pq.py) and
    one streamed einsum. With ``d_out < d_in`` the rotation is initialized
    from PCA (faiss does the same for dimension-reducing OPQ)."""

    def __init__(self, d_in: int, m: int, d_out: int | None = None, *,
                 ksub: int = 256, niter: int = 16, pq_iters: int = 4,
                 max_points: int = 32768, seed: int = 42):
        d_out = d_in if d_out is None else int(d_out)
        if d_out % m:
            raise ValueError(f"OPQ m={m} must divide d_out={d_out}")
        VectorTransform.__init__(self, d_in, d_out)
        self.a, self.b = None, np.zeros(d_out, np.float32)
        self.m = int(m)
        self.ksub = int(ksub)
        self.niter = int(niter)
        self.pq_iters = int(pq_iters)
        self.max_points = int(max_points)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        from .pq import decode_pq, encode_pq, train_pq

        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}], got {x.shape}")
        rng = np.random.default_rng(self.seed)
        if len(x) > self.max_points:
            x = x[rng.choice(len(x), self.max_points, replace=False)]
        n = len(x)
        ksub = min(self.ksub, max(n // 2, 2))
        if self.d_out < self.d_in:
            pca = PCAMatrix(self.d_in, self.d_out, seed=self.seed)
            pca.train(x)
            a = pca.a.astype(np.float64)
            # drop the whitening-free PCA bias: OPQ is a pure rotation in
            # faiss; centering would shift IP-metric semantics
        else:
            a = _random_rotation(self.d_in, self.d_out,
                                 self.seed).astype(np.float64)
        x_dev = jnp.asarray(x)
        cb = None
        chunk = min(n, 32768)
        pad = (-n) % chunk
        for _ in range(self.niter):
            xr = np.asarray(_apply_linear(
                x_dev, jnp.asarray(a.T.astype(np.float32)),
                jnp.zeros(self.d_out, jnp.float32)))
            cb = train_pq(xr, self.m, ksub=ksub, iters=self.pq_iters,
                          seed=self.seed, init_cb=cb,
                          max_points=self.max_points)
            cb_dev = jnp.asarray(cb)
            codes = encode_pq(jnp.asarray(xr), cb_dev)
            xh = decode_pq(codes, cb_dev)                   # [n, d_out]
            if pad:
                xp = jnp.pad(x_dev, ((0, pad), (0, 0)))
                xhp = jnp.pad(xh, ((0, pad), (0, 0)))
            else:
                xp, xhp = x_dev, xh
            g = np.asarray(_cross_term(xp, xhp, chunk=chunk), np.float64)
            u, _, vt = np.linalg.svd(g, full_matrices=False)
            a = (u @ vt).T                                  # [d_out, d_in]
        self.a = np.ascontiguousarray(a.astype(np.float32))
        self.is_trained = True

    def state(self) -> dict:
        return {"kind": "opq", "a": self.a, "b": self.b,
                "m": np.int64(self.m), "ksub": np.int64(self.ksub),
                "niter": np.int64(self.niter),
                "pq_iters": np.int64(self.pq_iters),
                "max_points": np.int64(self.max_points),
                "seed": np.int64(self.seed)}

    @classmethod
    def _from_state(cls, st: dict):
        a = np.asarray(st["a"])
        t = cls(a.shape[1], int(st["m"]), a.shape[0],
                ksub=int(st["ksub"]), niter=int(st["niter"]),
                pq_iters=int(st["pq_iters"]),
                max_points=int(st["max_points"]), seed=int(st["seed"]))
        t.a, t.b = a, np.asarray(st["b"])
        t.is_trained = True
        return t
