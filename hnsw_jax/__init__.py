"""hnsw_jax — an HNSW index-and-query engine for accelerators (JAX/XLA).

Built from scratch with the capabilities of ``code-orangemonster/HNSW-``
(/root/reference/README.md:2: "based on faiss and optimized for HNSW"); see
SURVEY.md for the capability contract and BASELINE.md for targets.
"""

from .config import IP, L2, HnswConfig
from .factory import index_factory
from .graph import GraphArrays, check_invariants, load_graph, save_graph
from .models.brute import FlatIndex
from .models.hnsw import HnswIndex
from .models.idmap import IdMapIndex
from .models.pretransform import PreTransformIndex
from .models.refine import RefineFlatIndex
from .ops.distances import brute_force_topk
from .ops.transforms import (NormalizationTransform, OPQMatrix, PCAMatrix,
                             RandomRotation, VectorTransform)
from .ops.packed import PackedNeighbors, pack_neighbors
from .parallel.sharded import ShardedHnswIndex, make_mesh
from .reference_impl import NumpyHnsw
from .search import hnsw_search
from .serving import Searcher

__version__ = "0.1.0"

__all__ = [
    "IP", "L2", "HnswConfig", "GraphArrays", "HnswIndex", "FlatIndex",
    "IdMapIndex", "PreTransformIndex", "RefineFlatIndex",
    "VectorTransform", "NormalizationTransform", "RandomRotation",
    "PCAMatrix", "OPQMatrix",
    "NumpyHnsw", "ShardedHnswIndex", "make_mesh", "Searcher",
    "brute_force_topk", "hnsw_search", "check_invariants",
    "PackedNeighbors", "pack_neighbors",
    "index_factory", "save_graph", "load_graph", "__version__",
]
