"""Node-locality edge partitioning for the row-sharded sweep
(`-mesh-locality`).

The reference's pthread reduce adds back only the gamma_hat rows each
thread actually touched (reference: src/mmsbinfer.cc:1802-1808); SURVEY
§2 prescribes the sharded analog: "the 'only touched nodes' reduce becomes a
sparse gather/scatter collective". The plain row-sharded sweep
(parallel/mesh.py:make_rowsharded_*) instead moves the FULL (n,K) state
per sweep — an all_gather of Elogpi and a psum_scatter of gamma_hat —
regardless of edge locality, which the repo's collective budget names as
the >16-chip scaling wall.

This module builds the host-side layout that makes the touched-rows form
possible with static shapes:

  1. `Network.reorder_locality` (graph.py) permutes seq ids into d
     contiguous BFS blocks, so most edges fall inside one block.
  2. Each edge is assigned to a shard OWNING one of its endpoints
     (`locality_edge_layout`), pairwise-balanced so shard loads stay
     even; every edge then needs at most ONE remote row.
  3. Per shard, the set of rows it must EXPORT (rows other shards' edges
     touch) is padded to a common Xmax; the device program gathers only
     these boundary rows — an all_gather of (d*Xmax, 2K) packed rows
     replaces the (n, 2K) gather, and a psum_scatter of (d*Xmax, K)
     boundary contributions replaces the (n, K) one. With boundary
     fraction f the per-sweep collective bytes drop by ~1/f.

Edge endpoints are remapped host-side to indices into the concatenated
[local rows (n/d) | boundary table (d*Xmax)] array, so the device edge
pass (svi/sweep_math.py:fused_phi_s3_pass) is unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def locality_edge_layout(edges: np.ndarray, n: int, n_shards: int,
                         block: int) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, dict]:
    """Partition (E,2) canonical edges onto n_shards row blocks.

    Requires n % n_shards == 0 (caller guarantees; see cli.py).

    Returns (edges_local (d*Eper, 2) int32 — endpoints remapped into the
    per-shard [owned | boundary-table] index space, laid out so a
    P('edges') split hands each shard its contiguous chunk;
    mask (d*Eper,) f32; exp_idx (d*Xmax,) int32 — per-shard LOCAL row
    indices to export, zero-padded; info dict with rows_per/xmax/
    internal_frac/loads)."""
    d = n_shards
    rows_per = n // d
    E = len(edges)
    p64 = edges[:, 0].astype(np.int64)
    q64 = edges[:, 1].astype(np.int64)
    own_p = p64 // rows_per
    own_q = q64 // rows_per

    # --- shard assignment: internal edges are fixed; boundary edges are
    # split between their two owners to equalize loads (largest pair
    # groups first, each split closing the current load gap)
    owner = own_p.copy()
    internal = own_p == own_q
    loads = np.bincount(own_p[internal], minlength=d).astype(np.int64)
    b = np.nonzero(~internal)[0]
    if len(b):
        gkey = own_p[b] * d + own_q[b]
        order = np.argsort(gkey, kind="stable")
        bs = b[order]
        uk, gstart, gcount = np.unique(gkey[order], return_index=True,
                                       return_counts=True)
        for gi in np.argsort(-gcount, kind="stable"):
            s, t = int(uk[gi]) // d, int(uk[gi]) % d
            c = int(gcount[gi])
            x = int(np.clip((loads[t] - loads[s] + c) // 2, 0, c))
            ids = bs[gstart[gi]: gstart[gi] + c]
            owner[ids[:x]] = s
            owner[ids[x:]] = t
            loads[s] += x
            loads[t] += c - x

    # --- export sets: rows accessed by a shard that does not own them
    pts = np.stack([p64, q64], axis=1)            # (E, 2)
    own_pt = np.stack([own_p, own_q], axis=1)
    remote = own_pt != owner[:, None]
    uniq_remote = np.unique(pts[remote])
    r_owner = (uniq_remote // rows_per).astype(np.int64)
    counts = np.bincount(r_owner, minlength=d)
    xmax = max(int(counts.max()) if len(counts) else 0, 1)
    xmax = ((xmax + 7) // 8) * 8                  # (8,128)-tiling friendly
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(uniq_remote)) - starts[r_owner]
    slot = r_owner * xmax + rank                  # table slot per row
    exp_idx = np.zeros(d * xmax, np.int32)
    exp_idx[slot] = (uniq_remote - r_owner * rows_per).astype(np.int32)

    # --- endpoint remap into [owned (rows_per) | table (d*xmax)] space
    local = pts - own_pt * rows_per               # owned-row index
    if len(uniq_remote):
        # owned endpoints may search past the end; the clipped result is
        # only consumed where `remote` is True (always an exact hit)
        pos = np.clip(np.searchsorted(uniq_remote, pts), 0,
                      len(uniq_remote) - 1)
        new_pts = np.where(remote, rows_per + slot[pos], local)
    else:
        new_pts = local

    # --- per-shard padded edge arrays (contiguous shard chunks)
    per = int(np.bincount(owner, minlength=d).max()) if E else 0
    per = max(block, ((per + block - 1) // block) * block)
    out = np.zeros((d * per, 2), np.int32)
    mask = np.zeros(d * per, np.float32)
    for s in range(d):
        ids = np.nonzero(owner == s)[0]
        out[s * per: s * per + len(ids)] = new_pts[ids]
        mask[s * per: s * per + len(ids)] = 1.0

    info = {"rows_per": rows_per, "xmax": xmax, "per_shard": per,
            "internal_frac": float(internal.mean()) if E else 1.0,
            "boundary_rows": int(len(uniq_remote)),
            "loads": loads.tolist()}
    return out, mask, exp_idx, info
