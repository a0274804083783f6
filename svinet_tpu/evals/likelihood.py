"""Held-out edge likelihood — the convergence metric.

Mixture likelihood of a pair under the a-MMSB posterior point estimates
(reference: LinkSampling::edge_likelihood, src/linksampling.hh:258-292):

  y=1:  s = sum_k  pi_p[k] pi_q[k] beta_k
  y=0:  s = sum_k  pi_p[k] pi_q[k] (1-beta_k) + (1 - sum_k pi_p[k] pi_q[k])(1-eps)

with s clamped at 1e-30 before the log. The summary row written per report
(reference: LinkSampling::validation_likelihood, src/linksampling.cc:966-1001)
splits the average log-likelihood by links/nonlinks and combines them at
network sparsity: nshol = zeros_prob*avg0 + ones_prob*avg1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class HeldoutResult(NamedTuple):
    avg: float      # mean log-likelihood over all heldout pairs
    count: int
    avg0: float     # mean over nonlinks
    count0: int
    avg1: float     # mean over links
    count1: int

    def nshol(self, zeros_prob: float, ones_prob: float) -> float:
        return zeros_prob * self.avg0 + ones_prob * self.avg1


@functools.partial(jax.jit, static_argnames=())
def _heldout_sums(gamma, lam, pairs, y, w, epsilon):
    pi = gamma / gamma.sum(axis=1, keepdims=True)
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    pp = pi[pairs[:, 0]]
    qq = pi[pairs[:, 1]]
    prod = pp * qq
    inner = prod.sum(axis=-1)
    s_one = (prod * beta).sum(axis=-1)
    s_zero = (prod * (1.0 - beta)).sum(axis=-1) + (1.0 - inner) * (1.0 - epsilon)
    s = jnp.where(y == 1, s_one, s_zero)
    ll = jnp.log(jnp.maximum(s, 1e-30)) * w
    ones = (y == 1)
    return jnp.array([
        ll.sum(), w.sum(),
        jnp.where(ones, 0.0, ll).sum(), jnp.where(ones, 0.0, w).sum(),
        jnp.where(ones, ll, 0.0).sum(), jnp.where(ones, w, 0.0).sum(),
    ])


def heldout_stats(gamma, lam, pairs, y, epsilon: float,
                  block: int = 1 << 17) -> HeldoutResult:
    """Blocked over the pair set: the (B,K) gather intermediates stay
    bounded regardless of the heldout-set size (the n=1M stretch holds
    out ~300k pairs at K=500). The ragged tail block is padded to the
    full block size (weight 0) so every block shares ONE compiled
    program instead of one per heldout-set size."""
    m = pairs.shape[0]
    if m == 0:
        return HeldoutResult(0.0, 0, 0.0, 0, 0.0, 0)
    acc = None
    for lo in range(0, m, block):
        pb, yb = pairs[lo: lo + block], y[lo: lo + block]
        wb = jnp.ones(pb.shape[0], jnp.float32)
        if m > block and pb.shape[0] != block:
            pad = block - pb.shape[0]
            pb = jnp.concatenate([pb, jnp.zeros((pad, 2), pb.dtype)])
            yb = jnp.concatenate([yb, jnp.zeros(pad, yb.dtype)])
            wb = jnp.concatenate([wb, jnp.zeros(pad, jnp.float32)])
        part = _heldout_sums(gamma, lam, pb, yb, wb, epsilon)
        acc = part if acc is None else acc + part
    s, k, s0, k0, s1, k1 = (float(v) for v in acc)
    return HeldoutResult(
        avg=s / max(k, 1), count=int(k),
        avg0=s0 / max(k0, 1), count0=int(k0),
        avg1=s1 / max(k1, 1), count1=int(k1))


def heldout_sums_blocked(gamma, lam, pairs, y, w, epsilon,
                         num_blocks: int) -> jax.Array:
    """Jit-inlineable blocked heldout sums: same six components as
    _heldout_sums, computed as a lax.scan over padded pair blocks so it
    can run as the TAIL of the fused multi-sweep program — a report
    boundary then costs ONE device round trip instead of one per eval."""
    pi = gamma / gamma.sum(axis=1, keepdims=True)
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    return heldout_sums_from_pi(pi, beta, pairs, y, w, epsilon,
                                num_blocks)


def heldout_sums_from_pi(pi, beta, pairs, y, w, epsilon,
                         num_blocks: int) -> jax.Array:
    """heldout_sums_blocked over an already-normalized pi table whose
    rows `pairs` index. The row-sharded sweep tails feed a COMPACT table
    of just the heldout-touched pi rows (all_gathered boundary table,
    parallel/mesh.py) instead of the full (n,K) pi."""
    pb = pairs.reshape(num_blocks, -1, 2)
    yb = y.reshape(num_blocks, -1)
    wb = w.reshape(num_blocks, -1)

    def blk(acc, xs):
        pp, yy, ww = xs
        prod = pi[pp[:, 0]] * pi[pp[:, 1]]
        inner = prod.sum(axis=-1)
        s_one = (prod * beta).sum(axis=-1)
        s_zero = ((prod * (1.0 - beta)).sum(axis=-1)
                  + (1.0 - inner) * (1.0 - epsilon))
        s = jnp.where(yy == 1, s_one, s_zero)
        ll = jnp.log(jnp.maximum(s, 1e-30)) * ww
        ones = (yy == 1)
        part = jnp.array([
            ll.sum(), ww.sum(),
            jnp.where(ones, 0.0, ll).sum(),
            jnp.where(ones, 0.0, ww).sum(),
            jnp.where(ones, ll, 0.0).sum(),
            jnp.where(ones, ww, 0.0).sum(),
        ])
        return acc + part, None

    acc, _ = jax.lax.scan(blk, jnp.zeros(6, jnp.float32), (pb, yb, wb))
    return acc


def multi_heldout_sums(gamma, lam, tail_pairs, tail_y, tail_w, epsilon,
                       blocks) -> jax.Array:
    """Heldout sums for SEVERAL pair sets on one state, jit-inlineable as
    the tail of the minibatch engines' multi-step programs (round-4
    review item 5: one dispatch per report). tail_pairs/tail_y/tail_w
    are tuples of padded arrays; blocks the matching static scan counts.
    Returns (S, 6) stacked sums."""
    pi = gamma / gamma.sum(axis=1, keepdims=True)
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    return jnp.stack([
        heldout_sums_from_pi(pi, beta, p, y, w, epsilon, nb)
        for p, y, w, nb in zip(tail_pairs, tail_y, tail_w, blocks)])


def result_from_sums(sums) -> HeldoutResult:
    s, k, s0, k0, s1, k1 = (float(v) for v in sums)
    return HeldoutResult(
        avg=s / max(k, 1), count=int(k),
        avg0=s0 / max(k0, 1), count0=int(k0),
        avg1=s1 / max(k1, 1), count1=int(k1))


@jax.jit
def link_probs(gamma, lam, pairs):
    """P(y=1) under point estimates, for AUC / precision curves
    (reference: LinkSampling::link_prob, src/linksampling.hh:239-257)."""
    pi = gamma / gamma.sum(axis=1, keepdims=True)
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    return (pi[pairs[:, 0]] * pi[pairs[:, 1]] * beta).sum(axis=-1)
