"""Sparse top-W gamma representation — the FastQueue equivalent.

The reference's FastQueue (reference: src/fastqueue.hh:22-305, used as
``SparseCounts = map<uint32_t, FastQueue>`` at src/fastqueue.hh:307)
keeps, per node, only the top-k gamma entries plus cached psi sums for
the uniform remainder, so the huge-K regime never materializes an (n,K)
state. Redesign with static shapes:

  ids  (n,W) int32  — each node's top-W community ids
  vals (n,W) f32    — their gamma values
  rest (n,)  f32    — the summed gamma mass of the other K-W communities,
                      treated as uniform (rest/(K-W) per community), the
                      same approximation FastQueue's remainder cache makes
                      (Elogpi/Epi of non-top entries,
                      src/fastqueue.hh:210-260).

The per-pair local step runs over the UNION of both endpoints' top lists
(2W slots) instead of all K communities — the same economics that made
FastQueue worthwhile on 2013 CPUs, here with static (B, 2W) tensors so
XLA can tile them. Duplicate slots are masked to -inf inside the softmax
so a community in both top lists is counted once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from svinet_tpu.ops.expectations import dirichlet_expectation


def topw_from_dense(gamma, w: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Compress dense (n,K) gamma to (ids, vals, rest)."""
    vals, ids = jax.lax.top_k(gamma, w)
    # f32 cancellation can leave the difference slightly negative on rows
    # whose tail mass is tiny; a negative tail flips digamma(tail) sign
    # and destabilizes the sparse fixed point, so clamp at 0
    rest = jnp.maximum(gamma.sum(axis=-1) - vals.sum(axis=-1), 0.0)
    return ids.astype(jnp.int32), vals, rest


def densify(ids, vals, rest, k: int) -> jax.Array:
    """Expand back to (n,K): top entries exact, tail mass spread uniformly
    over the K-W non-top communities."""
    n, w = ids.shape
    tail = rest / max(k - w, 1)
    out = jnp.broadcast_to(tail[:, None], (n, k))
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, w))
    return out.at[rows, ids].set(vals)


def _value_at_slots(ids, vals, tail_val, slots):
    """Per-row gamma value at each slot id: the top value when the slot is
    in the row's top list, else the uniform tail value.

    ids/vals: (B,W); tail_val: (B,); slots: (B,S). Returns (B,S)."""
    match = slots[:, :, None] == ids[:, None, :]            # (B,S,W)
    top = (match * vals[:, None, :]).sum(-1)
    in_top = match.any(-1)
    return jnp.where(in_top, top, tail_val[:, None])


def _dup_mask(slots):
    """(B,S) bool: True at the FIRST occurrence of each slot id."""
    b, s = slots.shape
    eq = slots[:, :, None] == slots[:, None, :]             # (B,S,S)
    earlier = jnp.tril(jnp.ones((s, s), bool), k=-1)
    return ~(eq & earlier).any(-1)


def sparse_phi_fixed_point(ids_p, vals_p, rest_p, ids_q, vals_q, rest_q,
                           elogbeta, y, log_eps, k: int,
                           max_iters: int = 50, thresh: float = 1e-5):
    """Coupled phi fixed point over the 2W union slots of each pair.

    Same math as ops/phicomp.py (reference: PhiComp::update_phis,
    src/mmsbinfer.hh:105-199) but restricted to the union of the two
    endpoints' top lists; the K-2W tail communities carry ~zero phi mass
    for any pair with links (their Elogpi is the uniform remainder).

    Returns (slots (B,2W) int32, first (B,2W) bool dedup mask,
             phi1, phi2 (B,2W))."""
    w = ids_p.shape[1]
    slots = jnp.concatenate([ids_p, ids_q], axis=1)          # (B,2W)
    first = _dup_mask(slots)
    neg = jnp.asarray(-1e30, vals_p.dtype)

    tot_p = vals_p.sum(-1) + rest_p
    tot_q = vals_q.sum(-1) + rest_q
    # floor the uniform tail value: digamma(0) = -inf would poison the
    # softmax with NaNs when a row's tail mass is exactly 0
    tail_p = jnp.maximum(rest_p / max(k - w, 1), 1e-10)
    tail_q = jnp.maximum(rest_q / max(k - w, 1), 1e-10)
    gp = _value_at_slots(ids_p, vals_p, tail_p, slots)
    gq = _value_at_slots(ids_q, vals_q, tail_q, slots)
    elogpi_p = (jax.scipy.special.digamma(gp)
                - jax.scipy.special.digamma(tot_p)[:, None])
    elogpi_q = (jax.scipy.special.digamma(gq)
                - jax.scipy.special.digamma(tot_q)[:, None])

    yf = (y == 1)[:, None]
    eb = elogbeta[jnp.clip(slots, 0, elogbeta.shape[0] - 1)]  # (B,2W,2)
    elogf = jnp.where(yf, eb[:, :, 0], eb[:, :, 1])
    dead = jnp.where(first, 0.0, neg)                        # dup slots out

    b = slots.shape[0]
    phi0 = jax.nn.softmax(jnp.zeros((b, 2 * w), vals_p.dtype) + dead,
                          axis=-1)

    def round_(state):
        i, phi1, phi2, _ = state
        u1 = jnp.where(yf, (1.0 - phi2) * log_eps, 0.0)
        n1 = jax.nn.softmax(elogpi_p + elogf * phi2 + u1 + dead, axis=-1)
        u2 = jnp.where(yf, (1.0 - phi1) * log_eps, 0.0)
        n2 = jax.nn.softmax(elogpi_q + elogf * phi1 + u2 + dead, axis=-1)
        change = jnp.maximum(jnp.abs(n1 - phi1).mean(-1),
                             jnp.abs(n2 - phi2).mean(-1)).max()
        return i + 1, n1, n2, change

    def cond(state):
        i, _, _, change = state
        return (i < max_iters) & (change >= thresh)

    _, phi1, phi2, _ = jax.lax.while_loop(
        cond, round_, (0, phi0, phi0, jnp.asarray(jnp.inf, vals_p.dtype)))
    return slots, first, phi1, phi2


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3),
                   static_argnames=("k", "max_iters"))
def sparse_fastamm_step(ids, vals, rest, lam, pairs, y, w_mask, lp, lq,
                        touched, rho, alpha, eta, scale, rhot, do_lambda,
                        log_eps, k: int, max_iters: int,
                        thresh: float = 1e-5):
    """One FastAMM iteration on the sparse state.

    pairs (B,2), y (B,), w_mask (B,) pad mask; lp/lq (B,) LOCAL indices of
    each endpoint within `touched` (T,), rho (T,). The gamma_hat scratch
    is (T,K) — dense in K but only over the touched nodes, so the n*K
    state never exists (T ~ minibatch size). Gamma update, re-top-W and
    scatter-back all happen on device (reference update + trim:
    src/fastqueue.hh:60-130, gamma step src/fastamm.cc:592-602)."""
    n, w = ids.shape
    t = touched.shape[0]
    p, q = pairs[:, 0], pairs[:, 1]
    elogbeta = dirichlet_expectation(lam)
    slots, first, phi1, phi2 = sparse_phi_fixed_point(
        ids[p], vals[p], rest[p], ids[q], vals[q], rest[q],
        elogbeta, y, log_eps, k, max_iters, thresh)
    wc = w_mask[:, None] * first     # (B,2W): pad pairs + dup slots -> 0
    f1 = phi1 * wc
    f2 = phi2 * wc

    # gamma_hat over touched rows only: (T,K) scatter at the slot ids
    gacc = jnp.zeros((t, k), vals.dtype)
    gacc = gacc.at[lp[:, None], slots].add(f1)
    gacc = gacc.at[lq[:, None], slots].add(f2)

    pp = phi1 * phi2 * wc
    yf = (y == 1)[:, None]
    lacc = jnp.zeros((k, 2), vals.dtype)
    lacc = lacc.at[slots, 0].add(jnp.where(yf, pp, 0.0))
    lacc = lacc.at[slots, 1].add(jnp.where(yf, 0.0, pp))

    # natural-gradient step on the touched rows, in dense K space
    old = densify(ids[jnp.clip(touched, 0, n - 1)],
                  vals[jnp.clip(touched, 0, n - 1)],
                  rest[jnp.clip(touched, 0, n - 1)], k)
    new = (1.0 - rho[:, None]) * old + rho[:, None] * (alpha + scale * gacc)
    nv, ni = jax.lax.top_k(new, w)
    nr = jnp.maximum(new.sum(-1) - nv.sum(-1), 0.0)  # f32 cancellation

    # scatter back (touched == n is the dump row for padding)
    safe = jnp.where(touched < n, touched, n)
    ids = jnp.concatenate([ids, jnp.zeros((1, w), ids.dtype)]
                          )[: n + 1].at[safe].set(ni.astype(jnp.int32))[:n]
    vals = jnp.concatenate([vals, jnp.zeros((1, w), vals.dtype)]
                           )[: n + 1].at[safe].set(nv)[:n]
    rest = jnp.concatenate([rest, jnp.zeros((1,), rest.dtype)]
                           )[: n + 1].at[safe].set(nr)[:n]

    lambdat = eta + scale * lacc
    lam = jnp.where(do_lambda > 0, (1.0 - rhot) * lam + rhot * lambdat, lam)
    return ids, vals, rest, lam


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3),
                   static_argnames=("k", "max_iters"))
def sparse_fastamm_multi_step(ids, vals, rest, lam, b_pairs, b_y, b_w,
                              b_lp, b_lq, b_touched, b_rho, alpha, eta,
                              b_scale, b_rhot, do_lambda, log_eps, k: int,
                              max_iters: int, thresh: float = 1e-5):
    """A report interval of sparse FastAMM iterations fused into one
    device program (batch axis 0 on every b_* array)."""
    def one(state, xs):
        i, v, r, l = state
        pairs, y, w, lp, lq, touched, rho, scale, rhot = xs
        return sparse_fastamm_step.__wrapped__(
            i, v, r, l, pairs, y, w, lp, lq, touched, rho, alpha, eta,
            scale, rhot, do_lambda, log_eps, k, max_iters, thresh), None

    (ids, vals, rest, lam), _ = jax.lax.scan(
        one, (ids, vals, rest, lam),
        (b_pairs, b_y, b_w, b_lp, b_lq, b_touched, b_rho, b_scale,
         b_rhot))
    return ids, vals, rest, lam


@functools.partial(jax.jit, static_argnames=("k",))
def sparse_pair_scores(ids, vals, rest, lam, pairs, k: int):
    """Per-pair link probability sum_k pi_p pi_q beta_k and the inner
    product sum_k pi_p pi_q, under the top-W + uniform-tail approximation
    (the same one FastQueue::Epi makes for non-top entries,
    src/fastqueue.hh:210-260). Exact over the union slots; the K-|union|
    tail communities contribute tail_p*tail_q*(sum beta - beta[union])."""
    w = ids.shape[1]
    p, q = pairs[:, 0], pairs[:, 1]
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    tot_p = vals[p].sum(-1) + rest[p]
    tot_q = vals[q].sum(-1) + rest[q]
    tail_p = rest[p] / max(k - w, 1) / tot_p
    tail_q = rest[q] / max(k - w, 1) / tot_q

    slots = jnp.concatenate([ids[p], ids[q]], axis=1)        # (B,2W)
    first = _dup_mask(slots)
    pip = _value_at_slots(ids[p], vals[p],
                          rest[p] / max(k - w, 1), slots) / tot_p[:, None]
    piq = _value_at_slots(ids[q], vals[q],
                          rest[q] / max(k - w, 1), slots) / tot_q[:, None]
    bs = beta[jnp.clip(slots, 0, k - 1)]
    fm = first.astype(vals.dtype)

    s_one = (pip * piq * bs * fm).sum(-1)
    inner = (pip * piq * fm).sum(-1)
    n_union = fm.sum(-1)
    beta_union = (bs * fm).sum(-1)
    tail_cross = tail_p * tail_q
    s_one = s_one + tail_cross * (beta.sum() - beta_union)
    inner = inner + tail_cross * (k - n_union)
    return s_one, inner


@functools.partial(jax.jit, static_argnames=("k",))
def sparse_edge_assignments(ids, vals, rest, lam, edges, k: int):
    """Closed-form phi argmax over the union slots per edge, for the
    link-community extraction (svi/communities.py semantics on the
    sparse state). Returns (community id (E,), normalized max (E,))."""
    w = ids.shape[1]
    p, q = edges[:, 0], edges[:, 1]
    elogbeta = dirichlet_expectation(lam)
    slots = jnp.concatenate([ids[p], ids[q]], axis=1)
    first = _dup_mask(slots)
    tot_p = vals[p].sum(-1) + rest[p]
    tot_q = vals[q].sum(-1) + rest[q]
    gp = _value_at_slots(ids[p], vals[p], rest[p] / max(k - w, 1), slots)
    gq = _value_at_slots(ids[q], vals[q], rest[q] / max(k - w, 1), slots)
    logits = (jax.scipy.special.digamma(gp)
              - jax.scipy.special.digamma(tot_p)[:, None]
              + jax.scipy.special.digamma(gq)
              - jax.scipy.special.digamma(tot_q)[:, None]
              + elogbeta[jnp.clip(slots, 0, k - 1), 0])
    logits = jnp.where(first, logits, -1e30)
    phi = jax.nn.softmax(logits, axis=-1)
    amax = phi.argmax(-1)
    mx = jnp.take_along_axis(phi, amax[:, None], 1)[:, 0]
    cid = jnp.take_along_axis(slots, amax[:, None], 1)[:, 0]
    return cid.astype(jnp.int32), mx
