"""Link-community extraction.

The reference assigns each training link to its argmax-phi community when
the max exceeds link_thresh, counts per-node assignments (fmap), and emits
each community as the nodes with count > lt_min_deg
(reference: src/linksampling.cc:668-681 and write_communities).
Here: one jitted pass returns per-edge (argmax, max); the tiny counting
step runs host-side in numpy.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.ops.expectations import dirichlet_expectation


@functools.partial(jax.jit, static_argnames=("num_blocks",))
def _edge_assignments_blocked(gamma, lam, edges, num_blocks: int):
    elogpi = dirichlet_expectation(gamma)
    elogb0 = dirichlet_expectation(lam)[:, 0]

    def body(carry, blk):
        logits = elogpi[blk[:, 0]] + elogpi[blk[:, 1]] + elogb0
        phi = jax.nn.softmax(logits, axis=-1)
        return carry, (jnp.argmax(phi, axis=-1).astype(jnp.int32),
                       jnp.max(phi, axis=-1))

    _, (am, mx) = jax.lax.scan(body, 0,
                               edges.reshape(num_blocks, -1, 2))
    return am.reshape(-1), mx.reshape(-1)


def edge_assignments(gamma, lam, edges, mask):
    """Per-edge argmax_k phi and max phi for the closed-form phi
    (phi_k proportional to exp(Elogpi_p + Elogpi_q + Elogbeta_k0)).

    Blocked scan: the (E, K) phi intermediate never materializes — at the
    n=1M/k=500 stretch a flat pass would need ~tens of GB of device memory. Blocks
    hold ~64M floats; edges are padded up to a whole number of blocks
    (mask filtering happens in extract_communities, so the padding rows
    are harmless)."""
    e = edges.shape[0]
    k = int(gamma.shape[1])
    block = max(1, min(e, (1 << 26) // max(k, 1)))
    num_blocks = -(-e // block)
    pad = num_blocks * block - e
    if pad:
        edges = jnp.concatenate(
            [jnp.asarray(edges),
             jnp.zeros((pad, 2), jnp.asarray(edges).dtype)])
    am, mx = _edge_assignments_blocked(gamma, lam, edges, num_blocks)
    return am[:e], mx[:e]


def extract_communities(argmax: np.ndarray, maxval: np.ndarray,
                        edges: np.ndarray, mask: np.ndarray, n: int, k: int,
                        link_thresh: float, lt_min_deg: int
                        ) -> Dict[int, List[int]]:
    """Host-side counting: node joins community c when its fmap count
    exceeds lt_min_deg."""
    sel = (maxval > link_thresh) & (mask > 0)
    arg = argmax[sel]
    p = edges[sel, 0]
    q = edges[sel, 1]
    fmap = np.zeros((n, k), np.int32)
    np.add.at(fmap, (p, arg), 1)
    np.add.at(fmap, (q, arg), 1)
    comms: Dict[int, List[int]] = {}
    nodes, cs = np.nonzero(fmap > lt_min_deg)
    for node, c in zip(nodes, cs):
        comms.setdefault(int(c), []).append(int(node))
    return comms
