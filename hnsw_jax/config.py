"""Index configuration.

Capability parity target: the constructor surface of faiss ``IndexHNSWFlat`` —
``(d, M, metric)`` plus the mutable ``hnsw.efConstruction`` / ``hnsw.efSearch``
knobs (reference claims faiss-HNSW lineage, /root/reference/README.md:2; the
concrete contract is SURVEY.md §2b C10).

Accelerator-specific additions: ``capacity`` (device arrays are preallocated — no
realloc on device, SURVEY.md §7 hard-part 5), ``max_level_cap`` (static shape
for the per-level neighbor tables) and dtype control for vector storage.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

L2 = "l2"
IP = "ip"
_METRICS = (L2, IP)

# Sentinel for "empty neighbor slot" / "unassigned node" throughout the graph
# arrays. Chosen negative so validity tests are a single `>= 0` compare.
NO_NEIGHBOR = -1


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Static hyperparameters of an HNSW index.

    Mirrors faiss IndexHNSWFlat semantics:
      * ``m``: number of links per node on levels >= 1 (faiss ``M``).
      * ``m0``: links per node on level 0; faiss uses ``M * 2``.
      * ``ef_construction`` / ``ef_search``: beam widths for build / query.
      * ``level_mult``: lambda of the exponential level distribution,
        faiss default ``1 / ln(M)``.
    Device statics:
      * ``capacity``: max number of vectors; all device arrays preallocated
        to it.
      * ``max_level_cap``: static number of upper levels (>=1) representable.
        P(level >= L) = M^-L, so 8 levels covers capacity up to ~M^8.
      * ``upper_capacity``: rows in the upper-level neighbor table. Only
        ~capacity/M nodes have level >= 1; default gives 4x headroom.
    """

    dim: int
    m: int = 32
    metric: str = L2
    capacity: int = 1_000_000
    m0: int = -1  # -1 -> 2*m (faiss default)
    ef_construction: int = 200
    ef_search: int = 64
    level_mult: float = -1.0  # -1 -> 1/ln(m)
    max_level_cap: int = 6
    upper_capacity: int = -1  # -1 -> auto
    dtype: str = "float32"  # vector storage: float32 | bfloat16 | sq8 | pq
    pq_m: int = 0  # sub-quantizers for dtype="pq" (must divide dim)
    pq_bits: int = 8  # bits per sub-code: 8 (faiss PQ default, ksub=256)
    #                   or 4 (faiss PQx4 fast-scan parity, ksub=16)
    seed: int = 42

    def __post_init__(self):
        if self.metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, got {self.metric!r}")
        if self.dim <= 0 or self.m <= 1 or self.capacity <= 0:
            raise ValueError("dim, m, capacity must be positive (m > 1)")
        if self.dtype not in ("float32", "bfloat16", "sq8", "pq"):
            raise ValueError(f"unsupported storage dtype {self.dtype!r}")
        if self.dtype == "pq":
            if self.pq_m <= 0 or self.dim % self.pq_m:
                raise ValueError(
                    f"dtype='pq' needs pq_m > 0 dividing dim "
                    f"(got pq_m={self.pq_m}, dim={self.dim})")
        elif self.pq_m:
            raise ValueError("pq_m is only meaningful with dtype='pq'")
        if self.pq_bits not in (4, 8):
            raise ValueError(f"pq_bits must be 4 or 8, got {self.pq_bits}")
        if self.capacity >= 1 << 24:
            # ids ride through one-hot f32 matmuls in the prune/compaction
            # kernels (ops/prune.py) — exact only below 2^24. Larger corpora
            # use the sharded index (parallel/sharded.py), whose per-shard
            # capacity is what this bounds.
            raise ValueError("capacity must be < 2^24 per (shard) index; "
                             "use ShardedHnswIndex for larger corpora")
        if self.m0 == -1:
            object.__setattr__(self, "m0", 2 * self.m)
        if self.level_mult < 0:
            object.__setattr__(self, "level_mult", 1.0 / math.log(self.m))
        if self.upper_capacity == -1:
            # E[#nodes with level>=1] = capacity * P(level>=1) = capacity/m.
            # 4x headroom, floor of 1024, keeps the table tiny vs level 0.
            auto = max(1024, 4 * self.capacity // self.m)
            object.__setattr__(self, "upper_capacity", min(auto, self.capacity))

    @property
    def is_sq(self) -> bool:
        """Scalar-quantized vector storage (faiss ``IndexHNSWSQ`` /
        ``ScalarQuantizer.QT_8bit`` parity): vectors live as uint8 codes +
        per-dim affine (offset, scale); every distance is computed against
        the dequantized x̂ = offset + scale·u. Requires ``train()``."""
        return self.dtype == "sq8"

    @property
    def is_pq(self) -> bool:
        """Product-quantized vector storage (faiss ``IndexHNSWPQ`` /
        ``ProductQuantizer`` parity, 8 bits/sub-code): vectors live as
        uint8 codes [*, pq_m] + per-subspace codebooks; every distance is
        the ADC value — exact against the reconstruction x̂. Requires
        ``train()``."""
        return self.dtype == "pq"

    @property
    def pq_ksub(self) -> int:
        """Centroids per PQ subspace (256 for 8-bit, 16 for 4-bit)."""
        return 1 << self.pq_bits

    @property
    def storage_dtype(self) -> str:
        """The actual device-array dtype backing vector storage."""
        return "uint8" if (self.is_sq or self.is_pq) else self.dtype

    @property
    def storage_width(self) -> int:
        """Columns of the vector-storage array: pq_m codes for PQ, else d."""
        return self.pq_m if self.is_pq else self.dim

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "HnswConfig":
        d: dict[str, Any] = json.loads(s)
        return cls(**d)

    def replace(self, **kw) -> "HnswConfig":
        return dataclasses.replace(self, **kw)
