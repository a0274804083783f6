"""Composable pieces of the link-sampling sweep, shared by the single-chip
jit path (svi/linksampling.py) and the multi-chip shard_map path
(parallel/mesh.py). Pure functions; no host state.

The split mirrors the reference's phases: the per-link phi pass
(src/linksampling.cc:605-725), the global nonlink/mean-indicator update
(src/linksampling.cc:526-545), and the s3 cross-moment pass
(src/linksampling.cc:731-749). On a device mesh the two edge passes run on
the local edge shard and their outputs (gacc (n,K), sumk (K,), s3 (K,)) are
the ONLY cross-device traffic, psum-reduced across the mesh — the sharded
equivalent of the reference's serial thread reduce
(src/mmsbinfer.cc:1770-1827).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class LSConsts(NamedTuple):
    """Per-run constants living on device."""
    alpha: jax.Array       # scalar
    eta: jax.Array         # (2,)
    ones: jax.Array        # scalar: number of links in the network
    n_nodes: jax.Array     # scalar: n (float)


def converged_of(gamma, alpha, prev=None) -> jax.Array:
    """Per-node convergence flag: a node with EXACTLY one community where
    gamma - alpha >= 1 is frozen to it (reference: check_and_set_converged,
    src/linksampling.cc:456-475). Returns int32 (n,): 0 = not converged,
    else community index + 1. The reference's _converged is STICKY —
    assigned when active_comms == 1 and never cleared (only updated by a
    later count==1 state) — so pass the previous flags as `prev` to keep
    already-frozen nodes frozen when a second column later crosses the
    threshold."""
    active = gamma - alpha >= 1.0
    count = active.sum(axis=-1)
    kidx = jnp.argmax(active, axis=-1).astype(jnp.int32)
    fresh = jnp.where(count == 1, kidx + 1, 0)
    return fresh if prev is None else jnp.where(count == 1, fresh, prev)


def phi_pass(elogpi, elb0, edges, mask, num_blocks: int, conv=None
             ) -> Tuple[jax.Array, jax.Array]:
    """Blocked sweep over (a shard of) the training links.

    conv: optional (n,) int32 converged flags; pairs with exactly one
    frozen endpoint contribute a hard one-hot with weight 1 to both
    endpoints instead of the soft phi (reference fast path,
    src/linksampling.cc:618-631).

    Returns (gacc (n,K): sum of phi scattered to both endpoints,
             sumk (K,): 2*sum of phi)."""
    n, k = elogpi.shape
    e_blocks = edges.reshape(num_blocks, -1, 2)
    m_blocks = mask.reshape(num_blocks, -1)

    def block(carry, blk):
        gacc, sumk = carry
        e, m = blk
        p, q = e[:, 0], e[:, 1]
        # rows may be stored bf16 (-bf16: halves the gather bytes); the
        # compute path is f32 —
        # cast AFTER the gather, accumulate in f32
        logits = (elogpi[p].astype(jnp.float32)
                  + elogpi[q].astype(jnp.float32) + elb0)
        phi = jax.nn.softmax(logits, axis=-1)
        if conv is not None:
            cp, cq = conv[p], conv[q]
            one_sided = (cp > 0) ^ (cq > 0)
            k_hard = jnp.maximum(cp, cq) - 1
            hard = jax.nn.one_hot(k_hard, k, dtype=phi.dtype)
            phi = jnp.where(one_sided[:, None], hard, phi)
        phi = phi * m[:, None]
        gacc = gacc.at[p].add(phi)
        gacc = gacc.at[q].add(phi)
        sumk = sumk + 2.0 * phi.sum(axis=0)
        return (gacc, sumk), None

    (gacc, sumk), _ = jax.lax.scan(
        block,
        (jnp.zeros((n, k), jnp.float32), jnp.zeros((k,), jnp.float32)),
        (e_blocks, m_blocks))
    return gacc, sumk


def mean_indicator_update(gacc, sumk, deg, consts: LSConsts, annealing
                          ) -> Tuple[jax.Array, jax.Array, jax.Array,
                                     jax.Array, jax.Array]:
    """Nonlink expectation correction (compute_mean_indicators).

    Returns (gnext, mphi, s1, s2, lam0)."""
    gnext = consts.alpha + gacc
    lam0 = consts.eta[0] + sumk
    # The reference counts each undirected link under BOTH endpoints when
    # filling _training_links (the adjacency loop visits every edge twice,
    # src/linksampling.cc:500-514), so its per-node count is 2*deg. The
    # mean indicator is gamma_hat/(2 deg) and the nonlink expectation uses
    # (n - 2 deg - 1). This halved correction is load-bearing for the
    # bundled golden runs (E[beta]~0.89, LFR nshol -0.111); with plain deg
    # the fit lands at E[beta]~0.71, nshol -0.122.
    degc = 2.0 * deg[:, None]
    has_links = degc > 0
    mphi = jnp.where(has_links, gacc / jnp.maximum(degc, 1.0), 0.0)
    s1 = mphi.sum(axis=0)
    s2 = (mphi * mphi).sum(axis=0)
    gnext = jnp.where(has_links,
                      gnext + (consts.n_nodes - degc - 1.0) * mphi, gnext)
    scale = consts.ones / jnp.maximum(sumk, 1e-30)
    gnext = jnp.where(has_links & (annealing > 0), gnext * scale, gnext)
    return gnext, mphi, s1, s2, lam0


def s3_pass(mphi, edges, mask, num_blocks: int, conv=None) -> jax.Array:
    """Cross-moment sum over (a shard of) the links: s3_k = sum mphi_p mphi_q.

    With conv, a pair with exactly one frozen endpoint contributes only the
    other endpoint's indicator at the frozen community
    (reference: src/linksampling.cc:735-746). DELIBERATE CORRECTION: the
    reference adds `mphid[q][pc]` into `_s3[pc-1]` — reading column pc
    where the frozen community is pc-1, an off-by-one that indexes out
    of bounds when pc == K. This port reads the frozen column itself
    (mphi[q][pc-1], the `hard * other` product below), which is the
    cross-moment the dense else-branch reduces to when mphi[p] is the
    one-hot of a frozen node. Freeze-mode s3 therefore diverges slightly
    from a GSL-shim reference build; -freeze is off by default."""
    k = mphi.shape[1]
    e_blocks = edges.reshape(num_blocks, -1, 2)
    m_blocks = mask.reshape(num_blocks, -1)

    def block(s3, blk):
        e, m = blk
        p, q = e[:, 0], e[:, 1]
        contrib = (mphi[p].astype(jnp.float32)
                   * mphi[q].astype(jnp.float32))
        if conv is not None:
            cp, cq = conv[p], conv[q]
            one_sided = (cp > 0) ^ (cq > 0)
            k_hard = jnp.maximum(cp, cq) - 1
            hard = jax.nn.one_hot(k_hard, k, dtype=contrib.dtype)
            other = jnp.where((cp > 0)[:, None], mphi[q], mphi[p])
            contrib = jnp.where(one_sided[:, None], hard * other, contrib)
        s3 = s3 + (contrib * m[:, None]).sum(axis=0)
        return s3, None

    s3, _ = jax.lax.scan(block, jnp.zeros((k,), jnp.float32),
                         (e_blocks, m_blocks))
    return s3


def finish_lambda(s1, s2, s3, lam0, consts: LSConsts) -> jax.Array:
    """lambda1 = eta1 + s1^2 - s2 - s3 (src/linksampling.cc:748)."""
    lam1 = consts.eta[1] + s1 * s1 - s2 - s3
    return jnp.stack([lam0, lam1], axis=1)


def fused_phi_s3_pass(packed, elb0, edges, mask, num_blocks: int
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """phi_pass and s3_pass in ONE edge sweep over a packed (n, 2K)
    array [Elogpi | mphi_prev] (-fuse-s3).

    The separate s3_pass gathers two more rows per edge; gathering rows
    twice as wide here costs only the marginal bytes when the sweep is
    bound by the number of row operations rather than by bytes (what
    that share is on the GPU is not measured yet).
    The price is a one-sweep LAG on the cross-moment: s3 at sweep t
    uses mphi from sweep t-1 (the current sweep's mean indicators need
    this sweep's completed gacc, reference order
    src/linksampling.cc:731-749). s1^2 and s2 stay current (they are
    (n,K) reductions, no edge gathers). At the fixed point
    mphi_t = mphi_{t-1}, so the converged semantics are identical; the
    transient differs only in lambda1's correction term. Parity is
    pinned by tests/test_parity.py::test_lfr_fused_s3.

    Returns (gacc (n,K), sumk (K,), s3 (K,)).
    """
    n, k2 = packed.shape
    k = k2 // 2
    e_blocks = edges.reshape(num_blocks, -1, 2)
    m_blocks = mask.reshape(num_blocks, -1)

    def block(carry, blk):
        gacc, sumk, s3 = carry
        e, m = blk
        p, q = e[:, 0], e[:, 1]
        # packed rows may be bf16 (-bf16); cast after the gather,
        # accumulate in f32
        rp = packed[p].astype(jnp.float32)
        rq = packed[q].astype(jnp.float32)
        logits = rp[:, :k] + rq[:, :k] + elb0
        phi = jax.nn.softmax(logits, axis=-1) * m[:, None]
        gacc = gacc.at[p].add(phi)
        gacc = gacc.at[q].add(phi)
        sumk = sumk + 2.0 * phi.sum(axis=0)
        s3 = s3 + (rp[:, k:] * rq[:, k:] * m[:, None]).sum(axis=0)
        return (gacc, sumk, s3), None

    (gacc, sumk, s3), _ = jax.lax.scan(
        block,
        (jnp.zeros((n, k), jnp.float32), jnp.zeros((k,), jnp.float32),
         jnp.zeros((k,), jnp.float32)),
        (e_blocks, m_blocks))
    return gacc, sumk, s3


def sparse_union_sweep_body(gamma, lam, mphi, edges, mask, deg,
                            consts: LSConsts, annealing, num_blocks: int,
                            W: int):
    """Per-node top-W UNION sweep (-sparse-w): the static-shape form of the
    regime where the reference's active-community pruning actually wins
    — per-pair phi computed only over the union of the endpoints'
    active lists (reference: src/linksampling.cc:634-664). Gamma stays
    dense (n,K); the edge pass cost drops from O(K) to O(W):

      1. per node, the top-W columns of gamma approximate the active
         list (the reference's criterion gamma - alpha >= 1 is
         data-dependent-width; top-W is its static-shape analog);
      2. per edge, phi is a softmax over the 2W-slot union (duplicate
         ids masked via a per-row sort) with EXACT logits — the values
         Elogpi[q, k] for k in p's list come from flat gathers into the
         dense array, exactly as the reference reads its dense Elogpi
         under sparse iteration;
      3. sufficient stats scatter-add at (node, column) flat indices;
         the lagged s3 cross-moment rides the same pass over the same
         union (the -fuse-s3 one-sweep-lag semantics, parity-pinned by
         tests/test_parity.py::test_lfr_fused_s3).

    With W >= K the union covers every column and the sweep is exactly
    the dense fused sweep (pinned by test_sparse_w_full_width_matches
    _dense). Like the reference's pruning, engage AFTER annealing only
    (the engine gates it): during annealing all columns are near-equal
    and a top-W cut is arbitrary.

    Returns (gnext, lam_new, mphi_new)."""
    import jax.numpy as jnp
    from svinet_tpu.ops.expectations import dirichlet_expectation
    n, k = gamma.shape
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    elb0 = elogbeta[:, 0]
    _, ids = jax.lax.top_k(gamma, W)
    ids = ids.astype(jnp.int32)
    topvals = jnp.take_along_axis(elogpi, ids, axis=1)
    flat_e = elogpi.reshape(-1)
    flat_m = mphi.reshape(-1)
    e_blocks = edges.reshape(num_blocks, -1, 2)
    m_blocks = mask.reshape(num_blocks, -1)

    def block(carry, blk):
        gacc_flat, sumk, s3 = carry
        e, m = blk
        p, q = e[:, 0], e[:, 1]
        idp, idq = ids[p], ids[q]
        cand = jnp.concatenate([idp, idq], axis=1)          # (B, 2W)
        lq_at_p = flat_e[q[:, None] * k + idp]
        lp_at_q = flat_e[p[:, None] * k + idq]
        logits = jnp.concatenate(
            [topvals[p] + lq_at_p, lp_at_q + topvals[q]], axis=1)
        logits = logits + elb0[cand]
        sort_ids, sort_logits = jax.lax.sort((cand, logits), num_keys=1)
        dup = jnp.concatenate(
            [jnp.zeros((cand.shape[0], 1), bool),
             sort_ids[:, 1:] == sort_ids[:, :-1]], axis=1)
        phi = jax.nn.softmax(jnp.where(dup, -jnp.inf, sort_logits),
                             axis=-1)
        phi = jnp.where(dup, 0.0, phi) * m[:, None]
        slot_p = p[:, None] * k + sort_ids
        slot_q = q[:, None] * k + sort_ids
        gacc_flat = gacc_flat.at[slot_p].add(phi)
        gacc_flat = gacc_flat.at[slot_q].add(phi)
        sumk = sumk.at[sort_ids].add(2.0 * phi)
        contrib = jnp.where(dup, 0.0, flat_m[slot_p] * flat_m[slot_q])
        s3 = s3.at[sort_ids].add(contrib * m[:, None])
        return (gacc_flat, sumk, s3), None

    (gacc_flat, sumk, s3), _ = jax.lax.scan(
        block,
        (jnp.zeros(n * k, jnp.float32), jnp.zeros((k,), jnp.float32),
         jnp.zeros((k,), jnp.float32)),
        (e_blocks, m_blocks))
    gnext, mphi_new, s1, s2, lam0 = mean_indicator_update(
        gacc_flat.reshape(n, k), sumk, deg, consts, annealing)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts), mphi_new


def compact_elogpi(gamma_c, rest) -> jax.Array:
    """Dirichlet expectation for COLUMN-COMPACTED gamma (-prune): the
    normalizer psi(sum_k gamma_nk) must span all K columns, so the
    columns not represented in gamma_c enter as the scalar
    rest = (K - K_pad) * alpha (the pad slots inside gamma_c already sit
    at alpha) — exact, because a pruned sweep leaves every inactive
    column at alpha (the reference's active-k path never adds phi
    outside the active union and gammanext is re-initialized to alpha,
    src/linksampling.cc:634-664, 448-450)."""
    return jax.scipy.special.digamma(gamma_c) - jax.scipy.special.digamma(
        gamma_c.sum(axis=-1, keepdims=True) + rest)


def compact_sweep_body(gamma_c, lam_c, edges, mask, deg, consts: LSConsts,
                       rest, colmask, num_blocks: int,
                       freeze: bool = False, conv=None):
    """One pruned sweep at the compacted width K_pad (dense-layout form of the
    reference's active-k pruning, src/linksampling.cc:634-664): identical
    math to _sweep_body restricted to the active columns. Padded columns
    (colmask 0) are excluded from the phi softmax via a -1e30 logit bias
    and end the sweep at (alpha, eta) like every inactive column.
    Annealing is over by the time pruning engages (annealing = 0).
    freeze composes: converged flags index the COMPACTED columns, same
    criterion (gamma - alpha >= 1 on the active columns only — inactive
    columns are at alpha and could never qualify)."""
    from svinet_tpu.ops.expectations import dirichlet_expectation
    elogpi = compact_elogpi(gamma_c, rest)
    elogbeta = dirichlet_expectation(lam_c)
    elb0 = jnp.where(colmask > 0, elogbeta[:, 0], -1e30)
    if freeze and conv is None:
        conv = converged_of(gamma_c, consts.alpha)
    gacc, sumk = phi_pass(elogpi, elb0, edges, mask, num_blocks, conv)
    gnext, mphi, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, jnp.float32(0.0))
    s3 = s3_pass(mphi, edges, mask, num_blocks, conv)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts)


def compact_fused_sweep_body(gamma_c, lam_c, mphi_c, edges, mask, deg,
                             consts: LSConsts, rest, colmask,
                             num_blocks: int):
    """-prune x -fuse-s3: the packed-row fused sweep at compacted width."""
    from svinet_tpu.ops.expectations import dirichlet_expectation
    elogpi = compact_elogpi(gamma_c, rest)
    elogbeta = dirichlet_expectation(lam_c)
    elb0 = jnp.where(colmask > 0, elogbeta[:, 0], -1e30)
    packed = jnp.concatenate([elogpi, mphi_c], axis=1)
    gacc, sumk, s3 = fused_phi_s3_pass(packed, elb0, edges, mask,
                                       num_blocks)
    gnext, mphi_new, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, jnp.float32(0.0))
    return gnext, finish_lambda(s1, s2, s3, lam0, consts), mphi_new
