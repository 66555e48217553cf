"""PCA projection for reduced-rank serving (compressed exact scan).

Rationale (TPU-KNN, arXiv:2206.14286; AQR-HNSW, arXiv:2602.21600;
pHNSW, arXiv:2602.19242): on hardware that streams matmuls at memory
bandwidth, a low-rank exact scan + exact rerank beats pointer-chasing graph
traversal — the first pass is one [B, r] x [r, N] matmul over a 4x-compressed
mirror, and the rerank touches only oversample*k rows. L2 distances are
translation-invariant, so mean-centering before projection loses nothing;
the top-r eigenbasis is the best r-dim linear map in expected squared
distance distortion.

No reference equivalent (the reference serves HashMap-resident f32 only);
this extends single-chip capacity ~4x beyond the bf16 mirror.
"""
from __future__ import annotations

import numpy as np


def fit_pca(sample: np.ndarray, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Fit a PCA projection on ``sample`` [S, D].

    Returns (mu [D] f32, p [D, rank] f32) — project with ``(x - mu) @ p``.
    Rank is clamped to min(D, S).
    """
    sample = np.asarray(sample, np.float32)
    s, d = sample.shape
    rank = max(1, min(rank, d, s))
    mu = sample.mean(axis=0)
    xc = sample - mu
    cov = (xc.T @ xc).astype(np.float64)  # [D, D]; f64 eigh for stability
    _, evecs = np.linalg.eigh(cov)
    p = evecs[:, ::-1][:, :rank]  # eigh returns ascending; take top-rank
    return mu.astype(np.float32), np.ascontiguousarray(p, np.float32)


def project(x: np.ndarray, mu: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Project rows: [N, D] -> [N, rank] (host BLAS; chunked to bound RSS)."""
    x = np.asarray(x, np.float32)
    out = np.empty((x.shape[0], p.shape[1]), np.float32)
    chunk = 1_048_576
    for lo in range(0, x.shape[0], chunk):
        out[lo: lo + chunk] = (x[lo: lo + chunk] - mu) @ p
    return out
