"""fabstir-vectordb-tpu: a vector database whose device work runs in JAX.

Top-level convenience exports; subpackages hold the full surfaces:
  index/      engines (flat, IVF, HNSW, hybrid, fused, tiered) + VectorStore
  ops/        distance matmuls, top-k, k-means, quantization
  core/       types, metadata filters, schema, chunks, caches, object stores
  storage/    chunked persistence, chunk loader, S5 drivers, encryption
  api/        VectorDBSession SDK, REST server, REST client
  parallel/   multi-chip sharded search/training over a jax Mesh
  maintenance/ schedulers, health, backups, search integration
  embedded/   host-only brute-force index + vector/video helpers (C++/WASM)
"""
from .api.session import VectorDBConfig, VectorDBError, VectorDBSession
from .index import (
    FlatIndex,
    HNSWConfig,
    HNSWIndex,
    HybridConfig,
    HybridIndex,
    IVFConfig,
    IVFIndex,
    SearchConfig,
    VectorStore,
)

__version__ = "0.5.0"

__all__ = [
    "VectorDBSession",
    "VectorDBConfig",
    "VectorDBError",
    "HybridIndex",
    "HybridConfig",
    "SearchConfig",
    "FlatIndex",
    "IVFIndex",
    "IVFConfig",
    "HNSWIndex",
    "HNSWConfig",
    "VectorStore",
    "__version__",
]
