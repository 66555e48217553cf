"""Embedded (in-process, host-only) index surface.

This framework's equivalent of the reference's standalone WASM
bindings crate (reference: bindings/wasm/src/lib.rs:12-15) — a small
brute-force index plus vector math and video-domain helpers that run
anywhere without a device: browser-analog deployments, edge processes,
and tests. Backed by the native C++ runtime (fvdb_native) when available,
with pure-numpy fallbacks.

Exports mirror the reference crate surface:
  InMemoryIndex, SearchFilter        (bindings/wasm/src/index.rs)
  Vector, VectorBatch, cosine_similarity, euclidean_distance,
  cosine_similarity_simd             (bindings/wasm/src/vector.rs)
  VideoSimilarityIndex, VideoRecommender, VideoClustering
                                     (bindings/wasm/src/video.rs)
"""
from ..native import InMemoryIndex, SearchFilter
from .vector import (
    Vector,
    VectorBatch,
    cosine_similarity,
    cosine_similarity_simd,
    euclidean_distance,
)
from .video import (
    SimilarVideo,
    VideoCluster,
    VideoClustering,
    VideoRecommendation,
    VideoRecommender,
    VideoSimilarityIndex,
)

__all__ = [
    "InMemoryIndex",
    "SearchFilter",
    "Vector",
    "VectorBatch",
    "cosine_similarity",
    "cosine_similarity_simd",
    "euclidean_distance",
    "SimilarVideo",
    "VideoCluster",
    "VideoClustering",
    "VideoRecommendation",
    "VideoRecommender",
    "VideoSimilarityIndex",
]
