"""Edge-array utilities: padding and blocking for static-shape kernels."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_edges(edges: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an (E,2) edge array to a multiple of `block`.

    Pad rows point at node 0 and are masked out; every kernel multiplies by
    the mask before accumulating, so pad rows contribute exactly zero.
    Returns (padded_edges (Ep,2) int32, mask (Ep,) float32).
    """
    e = np.asarray(edges, np.int32)
    n_edges = e.shape[0]
    padded_len = max(block, ((n_edges + block - 1) // block) * block)
    out = np.zeros((padded_len, 2), np.int32)
    out[:n_edges] = e
    mask = np.zeros(padded_len, np.float32)
    mask[:n_edges] = 1.0
    return out, mask


def choose_edge_block(n_edges: int, k: int,
                      block_budget_bytes: int = 1024 * 1024 * 1024) -> int:
    """Pick the edge-block size for the sweep scan.

    One flat gather-softmax-scatter over all edges leaves the compiler
    free to overlap work that a lax.scan over blocks serializes, so run
    FLAT whenever the per-block phi intermediate (block * K * 4 bytes)
    fits the budget, and fall back to the largest power-of-two block that
    does for huge edge sets.

    The 1 GiB default is not tuned for the GPU; it leaves ample room next
    to the three (n, K) state arrays on an 80 GB card.
    """
    limit = max(8192, block_budget_bytes // max(k * 4, 4))
    if n_edges <= limit:
        block = 1 << max(int(np.ceil(np.log2(max(n_edges, 1)))), 6)
        return min(block, limit)
    return 1 << int(np.floor(np.log2(limit)))
