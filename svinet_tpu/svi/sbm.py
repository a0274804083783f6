"""SBM engine (-single) — single-membership stochastic blockmodel.

JAX re-design of the reference's SBM (reference: src/sbm.cc):
global gamma (K,) Dirichlet over group proportions (alpha = sbm_alpha =
0.5, src/env.hh:345), per-node soft assignments phi (n,K), lambda (K+1,2)
where row K is the cross-community link rate (src/sbm.hh:126-132).

batch_infer (reference: src/sbm.cc:457-543): an inner E-step of up to 10
rounds updating every node's phi,

  phi_pk ~ exp( Elogpi_k
                + sum_{q:y=1} [phi_qk (A_k - A_K)]        A = Elogbeta[.,0]
                + sum_{q:y=0} [phi_qk (B_k - B_K)] )      B = Elogbeta[.,1]

(the per-node terms deg_p*A_K and n0_p*B_K are constant over k and cancel
in the softmax; reference: batch_update_phi src/sbm.cc:415-455), stopping
when the total phi change < 0.01; then the M-step

  gamma_k   = alpha + sum_i phi_ik
  lambda_k  = eta + (sum_links y phiphi, sum_nonlinks phiphi)
  lambda_K  = eta + (sum_k sum_links (1-phiphi),
                     sum_k sum_nonlinks (1-phiphi))
(reference: src/sbm.cc:485-525).

The reference's E-step is Gauss-Seidel over nodes; here it is the Jacobi
(simultaneous) variant — the vectorizable fixed point with the same
stationary points — so one round is one edge-segment-sum plus one (n,K)
softmax. Nonlink sums use totals minus link sums: the O(n^2)
pair loop never materializes.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.ops.expectations import dirichlet_expectation
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.evals.likelihood import HeldoutResult
from svinet_tpu.svi.base import EngineBase


N_CHUNKS = 16   # Gauss-Seidel chunk count (node id % N_CHUNKS)


def chunk_incident_pairs(pairs: np.ndarray, n_chunks: int = N_CHUNKS):
    """Per-chunk incident pair lists for the blocked Gauss-Seidel E-step:
    chunk c's list holds every pair with an endpoint in chunk c
    (node id % n_chunks == c), padded to a common length. A chunk's
    phi_update then scatters only its own incident pairs instead of the
    whole graph — the full-edge scatter repeated per chunk was ~n_chunks
    times the necessary E-step work. Returns (pairs (C,Emax,2) int32,
    mask (C,Emax) f32)."""
    pairs = pairs.reshape(-1, 2).astype(np.int32)
    cid_p = pairs[:, 0] % n_chunks
    cid_q = pairs[:, 1] % n_chunks
    lists = [pairs[(cid_p == c) | (cid_q == c)] for c in range(n_chunks)]
    emax = max(1, max(len(l) for l in lists))
    emax = ((emax + 63) // 64) * 64
    out = np.zeros((n_chunks, emax, 2), np.int32)
    msk = np.zeros((n_chunks, emax), np.float32)
    for c, l in enumerate(lists):
        out[c, :len(l)] = l
        msk[c, :len(l)] = 1.0
    return out, msk


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("estep_rounds",))
def sbm_batch_step(phi, gamma, lam, edges, mask, held_pairs, held_mask,
                   chunk_edges, chunk_emask, chunk_held, chunk_hmask,
                   alpha, eta, n_valid_pairs, estep_rounds: int = 10):
    """One batch coordinate-ascent iteration: E-step fixed point + M-step.
    held_pairs/held_mask: every heldout-split pair, which the reference
    excludes from every pair sum (edge_ok, src/sbm.hh:311-329) — here
    subtracted from the closed-form nonlink totals. chunk_*: per-chunk
    incident pair lists (chunk_incident_pairs) so each Gauss-Seidel
    chunk scatters only its own edges."""
    n, k = phi.shape
    elogpi = dirichlet_expectation(gamma)          # (K,)
    elogbeta = dirichlet_expectation(lam)          # (K+1,2)
    a = elogbeta[:k, 0]
    b = elogbeta[:k, 1]
    a_cross = elogbeta[k, 0]
    b_cross = elogbeta[k, 1]
    p, q = edges[:, 0], edges[:, 1]
    mcol = mask[:, None]
    hp, hq = held_pairs[:, 0], held_pairs[:, 1]
    hcol = held_mask[:, None]

    def phi_update(phi, ce, cm, che, chm):
        """One-shot phi given the CURRENT phi of the rest, over one
        chunk's incident pairs (rows outside the chunk come out partial
        and are discarded by the caller's where)."""
        cp, cq = ce[:, 0], ce[:, 1]
        ccol = cm[:, None]
        # S1 = sum of neighbor phis over training links (both directions)
        s1 = jnp.zeros_like(phi)
        s1 = s1.at[cp].add(phi[cq] * ccol)
        s1 = s1.at[cq].add(phi[cp] * ccol)
        # heldout partners drop out of the nonlink bucket entirely
        chp, chq = che[:, 0], che[:, 1]
        chcol = chm[:, None]
        hacc = jnp.zeros_like(phi)
        hacc = hacc.at[chp].add(phi[chq] * chcol)
        hacc = hacc.at[chq].add(phi[chp] * chcol)
        tot = phi.sum(0)[None, :] - phi             # exclude self
        s0 = tot - s1 - hacc
        logits = elogpi[None, :] + s1 * (a - a_cross) + s0 * (b - b_cross)
        return jax.nn.softmax(logits, axis=-1)

    # The reference's E-step is Gauss-Seidel over nodes — sequential
    # updates propagate emerging asymmetry coherently, which a pure Jacobi
    # sweep lacks (it is attracted to the all-one-community fixed point).
    # Blocked Gauss-Seidel keeps that property while staying vectorized:
    # nodes update chunk-by-chunk, each chunk seeing the chunks before it.
    n_chunks = N_CHUNKS
    chunk_ids = jnp.arange(n) % n_chunks   # interleaved chunks

    def estep_round(state):
        i, phi, _ = state
        def chunk_body(c, phi_c):
            phi_new = phi_update(phi_c, chunk_edges[c], chunk_emask[c],
                                 chunk_held[c], chunk_hmask[c])
            sel = (chunk_ids == c)[:, None]
            return jnp.where(sel, phi_new, phi_c)
        phi_new = jax.lax.fori_loop(0, n_chunks, chunk_body, phi)
        change = jnp.abs(phi_new - phi).sum()
        return i + 1, phi_new, change

    def cond(state):
        i, _, change = state
        return (i < estep_rounds) & (change >= 0.01)

    _, phi, _ = jax.lax.while_loop(
        cond, estep_round, (0, phi, jnp.asarray(jnp.inf, phi.dtype)))

    # ---- M-step --------------------------------------------------------
    gamma_new = alpha + phi.sum(0)

    link_pp = ((phi[p] * phi[q]) * mcol).sum(0)     # (K,) sum over links
    held_pp = ((phi[hp] * phi[hq]) * hcol).sum(0)   # heldout pairs excluded
    t = phi.sum(0)
    all_pp = 0.5 * (t * t - (phi * phi).sum(0))     # sum over ALL i<j pairs
    zero_pp = jnp.maximum(all_pp - link_pp - held_pp, 0.0)
    n_links = mask.sum()
    n_zeros = jnp.maximum(n_valid_pairs - n_links, 0.0)

    lam_k = jnp.stack([link_pp, zero_pp], axis=1)
    lam_cross = jnp.stack([
        (k * n_links - link_pp.sum())[None],
        (k * n_zeros - zero_pp.sum())[None]], axis=1).reshape(1, 2)
    lam_new = eta + jnp.concatenate([lam_k, lam_cross], axis=0)
    return phi, gamma_new, lam_new


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def sbm_stoch_step(phi, gamma, lam, r, dst, y, w, noderho, alpha, eta,
                   phi_scale, gamma_scale, lambda_scale, rhot):
    """One stochastic SBM iteration around start node r
    (reference: SBM::opt_process + update_phit/update_phi/
    update_gammat_lambdat/update_gamma_lambda, src/sbm.cc:388-699)."""
    n, k = phi.shape
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    a_k = elogbeta[:k, 0]
    b_k = elogbeta[:k, 1]
    a_x = elogbeta[k, 0]
    b_x = elogbeta[k, 1]
    yf = (y == 1)[:, None]
    wc = w[:, None]

    def pair_term(phi_partner):
        """(B,K): (1-phi_b)ELF_cross + phi_b ELF_k for each pair."""
        elf_k = jnp.where(yf, a_k, b_k)
        elf_x = jnp.where(yf, a_x, b_x)
        return (1.0 - phi_partner) * elf_x + phi_partner * elf_k

    # phit for the start node: sum over its pairs
    t_r = (pair_term(phi[dst]) * wc).sum(0)
    phit_r = jax.nn.softmax(elogpi + phi_scale * t_r)
    # phit for each partner: just its single pair with r (old phi_r)
    t_d = pair_term(phi[r][None, :])
    phit_d = jax.nn.softmax(elogpi[None, :] + phi_scale * t_d, axis=-1)

    # blend with per-node Robbins-Monro rates, renormalize. Padding slots
    # carry dst=0, so route them to a dump row to keep node 0's update
    # from colliding with the pad writes.
    dst_safe = jnp.where(w > 0, dst, n)
    phit_full = jnp.zeros((n + 1, k), phi.dtype).at[dst_safe].set(
        phit_d)[:n]
    phit_full = phit_full.at[r].set(phit_r)
    blended = (1.0 - noderho) * phi + noderho * phit_full
    blended = blended / jnp.maximum(blended.sum(1, keepdims=True), 1e-30)
    phi = jnp.where(noderho > 0, blended, phi)

    # sufficient statistics from the NEW phi
    pp = phi[r][None, :] * phi[dst] * wc               # (B,K)
    gsum = ((phi[r][None, :] + phi[dst]) * wc).sum(0)
    sum_a = jnp.where(yf, pp, 0.0).sum(0)
    sum_b = jnp.where(yf, 0.0, pp).sum(0)
    n1 = (w * (y == 1)).sum()
    n0 = (w * (y == 0)).sum()
    s1 = jnp.where(yf, pp, 0.0).sum()
    s0 = jnp.where(yf, 0.0, pp).sum()

    gammat = alpha + gamma_scale * gsum
    lamt_k = eta[:k] + lambda_scale * jnp.stack([sum_a, sum_b], 1)
    # cross row: the reference's n1/n0 counters accumulate once per
    # (k, pair) and are then divided by _k, i.e. the RAW pair counts
    # (reference: src/sbm.cc:696-698) — no extra /k here
    lamt_x = eta[k] + lambda_scale * jnp.stack([n1 - s1, n0 - s0])
    lambdat = jnp.concatenate([lamt_k, lamt_x[None, :]], axis=0)

    gamma = (1.0 - rhot) * gamma + rhot * gammat
    lam = (1.0 - rhot) * lam + rhot * lambdat
    return phi, gamma, lam


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("estep_rounds", "n_iters"))
def sbm_batch_multi_step(phi, gamma, lam, edges, mask, held_pairs,
                         held_mask, chunk_edges, chunk_emask, chunk_held,
                         chunk_hmask, alpha, eta, n_valid_pairs,
                         val_pairs, val_y, estep_rounds: int = 10,
                         n_iters: int = 1):
    """n_iters batch coordinate-ascent iterations fused into one device
    program, with the heldout sums of the FINAL state as the tail —
    one dispatch per report interval instead of one per iteration plus
    a standalone eval (the same dispatch-count fusion as the other
    engines; round-4 review item 5). Returns (phi, gamma, lam,
    sums (6,))."""
    def body(_, st):
        p_, g_, l_ = st
        return sbm_batch_step.__wrapped__(
            p_, g_, l_, edges, mask, held_pairs, held_mask, chunk_edges,
            chunk_emask, chunk_held, chunk_hmask, alpha, eta,
            n_valid_pairs, estep_rounds)
    phi, gamma, lam = jax.lax.fori_loop(0, n_iters, body,
                                        (phi, gamma, lam))
    ll = sbm_edge_loglik.__wrapped__(phi, lam, val_pairs, val_y)
    ones = val_y == 1
    onesf = ones.astype(jnp.float32)
    sums = jnp.array([
        ll.sum(), jnp.float32(ll.shape[0]),
        jnp.where(ones, 0.0, ll).sum(), (1.0 - onesf).sum(),
        jnp.where(ones, ll, 0.0).sum(), onesf.sum()])
    return phi, gamma, lam, sums


@jax.jit
def sbm_edge_loglik(phi, lam, pairs, y):
    """Reference: SBM::edge_likelihood2, src/sbm.hh:285-308."""
    k = phi.shape[1]
    rate = lam[:, 0] / (lam[:, 0] + lam[:, 1])     # (K+1,)
    pp = (phi[pairs[:, 0]] * phi[pairs[:, 1]])     # (B,K)
    inner = pp.sum(-1)
    r = jnp.where(y[:, None] == 1, rate[None, :k], 1.0 - rate[None, :k])
    rc = jnp.where(y == 1, rate[k], 1.0 - rate[k])
    s = (pp * r).sum(-1) + (1.0 - inner) * rc
    return jnp.log(jnp.maximum(s, 1e-30))


class SBM(EngineBase):
    """Host driver for -single."""

    stop_min_iter = 5000         # guard iter > 5000 (src/sbm.cc:895)
    stop_decline_reports = 3     # nh > 3 (src/sbm.cc:907)

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, network, rng)
        n, k = self.n, self.k
        self.sbm_alpha = 0.5  # reference: src/env.hh:345

        g0 = self.rng.gamma(100.0 * (100.0 / k), 0.01, size=k)
        # The symmetric fixed point (all nodes in one community) has a
        # large attraction basin under random inits — the reference's
        # gamma-noise init (src/sbm.cc:354-369) collapses there on most
        # seeds. Structured init makes convergence deterministic:
        # phi seeded from a short label-propagation pass (the findk
        # kernel) and lambda started assortative (diag rate 0.9, cross
        # 0.1), which every seed then refines to the same optimum.
        phi0 = self._label_prop_phi_init()
        l0 = np.concatenate([np.tile([9.0, 1.0], (k, 1)), [[1.0, 9.0]]])
        self.gamma_k = jnp.asarray(g0, jnp.float32)     # (K,) global
        self.phi = jnp.asarray(phi0, jnp.float32)
        self.lam = jnp.asarray(l0, jnp.float32)
        self.eta = jnp.asarray(
            np.tile([cfg.eta0, cfg.eta1], (k + 1, 1)), jnp.float32)

        e, m = pad_edges(network.training_links, cfg.edge_block)
        self.edges = jnp.asarray(e)
        self.mask = jnp.asarray(m)
        # EVERY split is excluded from the closed-form zero totals, like
        # edge_ok: a precision-set link left out of `held` would be
        # counted as a nonlink in the lambda M-step. Deduplicate by pair
        # key — a pair present in two splits (e.g. a -load-test file
        # overlapping the sampled validation split) must be subtracted
        # exactly once from the totals
        held = np.concatenate(
            [network.validation_pairs.reshape(-1, 2),
             network.heldout_pairs.reshape(-1, 2),
             network.test_pairs.reshape(-1, 2),
             network.precision_pairs.reshape(-1, 2)],
            axis=0).astype(np.int32)
        if len(held):
            keys = held[:, 0].astype(np.int64) * n + held[:, 1]
            held = held[np.sort(np.unique(keys, return_index=True)[1])]
        ce, cm = chunk_incident_pairs(network.training_links)
        self.chunk_edges = jnp.asarray(ce)
        self.chunk_emask = jnp.asarray(cm)
        che, chm = chunk_incident_pairs(held)
        self.chunk_held = jnp.asarray(che)
        self.chunk_hmask = jnp.asarray(chm)
        hp, hm = pad_edges(held, 64)
        self.held_pairs = jnp.asarray(hp)
        self.held_mask = jnp.asarray(hm)
        self.n_valid_pairs = jnp.float32(network.total_pairs - len(held))
        self._resume_if_requested()

    def _state_dict(self):
        d = self._host_state()
        d.update(phi=self.phi, gamma_k=self.gamma_k, lam=self.lam)
        # per-node Robbins-Monro counters are schedule state (like
        # FastAMM's): without them a resume takes near-initial-size phi
        # steps on every touched node
        if hasattr(self, "_nodec"):
            d["nodec"] = self._nodec
        return d

    def _restore_state(self, state) -> None:
        self.phi = self._as_device(state["phi"])
        self.gamma_k = self._as_device(state["gamma_k"])
        self.lam = self._as_device(state["lam"])
        nc = state.get("nodec")
        if nc is not None:
            self._nodec = np.asarray(nc, np.int64)
        self._restore_host_state(state)

    def _label_prop_phi_init(self) -> np.ndarray:
        """phi init from log10(n)+2 label-propagation sweeps: the largest
        propagated labels map round-robin onto the K groups, each node
        gets 0.8 on its group + 0.2 spread."""
        import math
        from svinet_tpu.svi.fastinit import vote_topk
        n, k = self.n, self.k
        e, m = pad_edges(self.network.training_links, 64)
        e_d, m_d = jnp.asarray(e), jnp.asarray(m)
        labels = jnp.arange(n, dtype=jnp.int32)
        for _ in range(int(math.log10(max(n, 10))) + 2):
            ids, _ = vote_topk(labels, e_d, m_d, n, min(8, n))
            labels = jnp.where(ids[:, 0] < n, ids[:, 0], labels)
        lab = np.asarray(labels)
        uniq, counts = np.unique(lab, return_counts=True)
        order = uniq[np.argsort(-counts)]
        lab_map = {int(u): i % k for i, u in enumerate(order)}
        hard = np.array([lab_map[int(x)] for x in lab])
        phi0 = np.full((n, k), 0.2 / k, np.float32)
        phi0[np.arange(n), hard] += 0.8
        return phi0

    # EngineBase.report uses (gamma, lam) mixed-membership likelihood;
    # SBM overrides with its phi-based mixture.
    def report(self) -> bool:
        cfg = self.cfg
        sums = getattr(self, "_sbm_sums", None)
        if sums is not None:
            # sums rode the fused batch program's tail (one dispatch per
            # report interval)
            s, c, s0, c0, s1, c1 = (float(v) for v in sums)
            res = HeldoutResult(
                avg=s / max(c, 1), count=int(c),
                avg0=s0 / max(c0, 1), count0=int(c0),
                avg1=s1 / max(c1, 1), count1=int(c1))
        else:
            ll = np.asarray(sbm_edge_loglik(self.phi, self.lam,
                                            self.val_pairs, self.val_y))
            y = np.asarray(self.val_y)
            ones = y == 1
            res = HeldoutResult(
                avg=float(ll.mean()), count=len(ll),
                avg0=float(ll[~ones].mean()) if (~ones).any() else 0.0,
                count0=int((~ones).sum()),
                avg1=float(ll[ones].mean()) if ones.any() else 0.0,
                count1=int(ones.sum()))
        nshol = self._vf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        self._hf.write(self.iteration, self.duration(), res,
                       cfg.zeros_prob, cfg.ones_prob)
        stop = self._stop_and_write_max(nshol, None)
        self._end_of_report()   # SIGTERM save-and-continue + periodic ckpt
        return stop and cfg.use_validation_stop

    def batch_infer(self) -> None:
        cfg = self.cfg
        r = max(cfg.reportfreq, 1)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            # every iteration up to the next report boundary + the eval
            # tail in ONE device program
            todo = r - (self.iteration % r)
            if cfg.max_iterations:
                todo = min(todo,
                           cfg.max_iterations - self.iteration + 1)
            self._sbm_sums = None
            (self.phi, self.gamma_k, self.lam,
             sums) = sbm_batch_multi_step(
                self.phi, self.gamma_k, self.lam, self.edges, self.mask,
                self.held_pairs, self.held_mask,
                self.chunk_edges, self.chunk_emask,
                self.chunk_held, self.chunk_hmask,
                jnp.float32(self.sbm_alpha), self.eta,
                self.n_valid_pairs, self.val_pairs, self.val_y,
                n_iters=int(todo))
            self._sbm_sums = np.asarray(sums)
            self.iteration += todo
            if self.iteration % r == 0:
                if self.report():
                    self.do_on_stop()
                    return

    # ------------------------------------------------------------------
    def infer(self) -> None:
        """Stochastic (infset-style) SVI (reference: SBM::infer,
        src/sbm.cc:545-588): each iteration a Bernoulli(0.001) coin picks
        an informative step (start node's links + preprocessed zeros,
        phi_scale n/2, gamma_scale 1/2, lambda_scale n/2) or a
        non-informative step (k random nonlink partners, scales
        n^2/(2 eps k), n/(2 eps k); src/sbm.cc:763-843). Touched nodes
        blend phi toward the scaled one-shot estimate with per-node
        Robbins-Monro rates; gamma/lambda take a global rho_t step."""
        cfg = self.cfg
        net = self.network
        if net.sparse_zeros_ptr is None:
            import os
            nb = cfg.file_str("neighbors.bin")
            if os.path.exists(nb):
                net.load_neighborhood_sets(nb)
            elif os.path.exists("neighbors.bin"):
                net.load_neighborhood_sets("neighbors.bin")
            else:
                net.set_neighborhood_sets(cfg)
        if not hasattr(self, "_nodec"):   # may be restored by -resume
            self._nodec = np.zeros(self.n, np.int64)
        inf_eps = 0.001   # reference: src/sbm.cc:9
        max_deg = int(net.training_deg.max()) if self.n else 1
        pad = 1 << int(np.ceil(np.log2(max(max_deg + 101, self.k, 64))))
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            r = int(self.rng.integers(0, self.n))
            if self.rng.uniform() >= inf_eps:
                others = np.concatenate([
                    net.neighbors(r), net.sparse_zeros(r)]).astype(np.int64)
                phi_scale = self.n / 2.0
                gamma_scale = 0.5
                lambda_scale = self.n / 2.0
            else:
                # batched random nonlink draws (svi/sampling.py), same
                # criteria as the reference's scalar loop
                # (src/sbm.cc:700-760)
                from svinet_tpu.svi.sampling import random_nonlink_draws
                inf_sorted = np.sort(net.sparse_zeros(r).astype(np.int64))
                others = random_nonlink_draws(
                    self.rng, net, self.n, r, self.k, inf_sorted,
                    max_tries=50 * self.k)
                phi_scale = (self.n * self.n) / (2 * inf_eps * self.k)
                gamma_scale = self.n / (2 * inf_eps * self.k)
                lambda_scale = phi_scale
            lo = np.minimum(r, others)
            hi = np.maximum(r, others)
            ok = net.edge_ok_mask(lo, hi) & (others != r)
            others = others[ok]
            ys = net.y(np.full(len(others), r), others).astype(np.int32)

            dst = np.zeros(pad, np.int32)
            yy = np.zeros(pad, np.int32)
            ww = np.zeros(pad, np.float32)
            m = min(len(others), pad)
            dst[:m] = others[:m]
            yy[:m] = ys[:m]
            ww[:m] = 1.0
            if m == 0:
                # nothing to step on, but the report boundary must not
                # be skipped: the heldout trace and the stopper expect a
                # row every reportfreq iterations regardless
                self.iteration += 1
                if self.iteration % cfg.reportfreq == 0:
                    if self.report():
                        self.do_on_stop()
                        return
                continue

            noderho = np.zeros((self.n, 1), np.float32)
            for a in [r] + [int(x) for x in others]:
                noderho[a, 0] = (cfg.nodetau0 + self._nodec[a]) ** (
                    -cfg.nodekappa)
                self._nodec[a] += 1
            rhot = (cfg.tau0 + (self.iteration + 1)) ** (-cfg.kappa)

            self.phi, self.gamma_k, self.lam = sbm_stoch_step(
                self.phi, self.gamma_k, self.lam, jnp.int32(r),
                jnp.asarray(dst), jnp.asarray(yy), jnp.asarray(ww),
                jnp.asarray(noderho), jnp.float32(self.sbm_alpha),
                self.eta, jnp.float32(phi_scale), jnp.float32(gamma_scale),
                jnp.float32(lambda_scale), jnp.float32(rhot))
            self.iteration += 1
            if self.iteration % cfg.reportfreq == 0:
                if self.report():
                    self.do_on_stop()
                    return

    def do_on_stop(self, next_iteration=None) -> None:
        cfg = self.cfg
        phi = np.asarray(self.phi)
        lam = np.asarray(self.lam)
        # save phi rows as gamma.txt (the per-node variational params) and
        # the (K+1)x2 lambda (reference: SBM::save_model, src/sbm.cc:298-340)
        with open(cfg.file_str("gamma.txt"), "w") as f:
            for i in range(self.n):
                vals = "\t".join(f"{v:.5f}" for v in phi[i])
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t{vals}\n")
        with open(cfg.file_str("lambda.txt"), "w") as f:
            for kk in range(lam.shape[0]):
                f.write(f"{kk}\t{lam[kk,0]:.5f}\t{lam[kk,1]:.5f}\n")
        groups = phi.argmax(1)
        with open(cfg.file_str("groups.txt"), "w") as f:
            for i in range(self.n):
                vals = "\t".join(f"{v:.3f}" for v in phi[i])
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t{vals}\t"
                        f"{int(groups[i])}\n")
        comms = {}
        for i, g in enumerate(groups):
            comms.setdefault(int(g), []).append(i)
        from svinet_tpu.io.writers import write_communities
        write_communities(cfg.file_str("communities.txt"), comms,
                          self.network.seq2id)
        if getattr(cfg, "checkpoint_freq", 0.0):
            self.save_checkpoint(next_iteration)
