"""MMSBOrig engine (-orig) — Airoldi et al. full-blockmodel batch VI.

JAX re-design of the reference's MMSBInferOrig
(reference: src/mmsbinferorig.cc:211-294): full K x K beta matrix with a
point-estimated M-step beta_gh = sum y phi1_g phi2_h / sum phi1_g phi2_h,
and a PhiComp2 local step over the K x K f matrix
(reference: src/mmsbinferorig.hh:120-209):

  phi1_g = softmax_g( Elogpi[p,g] + sum_h log f_gh phi2_h )
  phi2_g = softmax_g( Elogpi[q,g] + sum_h log f_gh phi1_h )
  f_gh   = beta_gh^y (1-beta_gh)^(1-y)

The reference loops over ALL ordered pairs (p,q), p != q; by symmetry of
the coupled update the (q,p) solution is the (p,q) solution with phi1/phi2
swapped, so each unordered pair is solved once and contributes
gamma_p += 2 phi1, gamma_q += 2 phi2 and the symmetrized K x K moment
y*(phi1 phi2^T + phi2 phi1^T). The local step's K-vector-times-logf
products run as (B,K)x(K,K) matmuls. Every float32 matrix product here
passes precision=HIGHEST: the reference computes them in double, and a
GPU would otherwise run them in TF32 (about three decimal digits).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.ops.expectations import dirichlet_expectation, dirichlet_mean
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.evals.likelihood import HeldoutResult
from svinet_tpu.io.writers import write_groups
from svinet_tpu.svi.base import EngineBase

_HIGHEST = jax.lax.Precision.HIGHEST


def _phi2_fixed_point(elogpi_p, elogpi_q, logf1, logf0, y, max_iters,
                      thresh):
    """Coupled Jacobi fixed point over the K x K f matrix for B pairs."""
    b, k = elogpi_p.shape
    yf = (y == 1)[:, None]
    phi0 = jnp.full((b, k), 1.0 / k, elogpi_p.dtype)

    def matvec(phi):
        # (B,K) @ (K,K)^T : row g = sum_h logf[g,h] phi_h
        return jnp.where(yf, jnp.matmul(phi, logf1.T, precision=_HIGHEST),
                         jnp.matmul(phi, logf0.T, precision=_HIGHEST))

    def round_(state):
        i, phi1, phi2, _ = state
        n1 = jax.nn.softmax(elogpi_p + matvec(phi2), axis=-1)
        n2 = jax.nn.softmax(elogpi_q + matvec(phi1), axis=-1)
        change = jnp.maximum(jnp.abs(n1 - phi1).mean(-1),
                             jnp.abs(n2 - phi2).mean(-1)).max()
        return i + 1, n1, n2, change

    def cond(state):
        i, _, _, change = state
        return (i < max_iters) & (change >= thresh)

    _, phi1, phi2, _ = jax.lax.while_loop(
        cond, round_, (0, phi0, phi0, jnp.asarray(jnp.inf, phi0.dtype)))
    return phi1, phi2


@functools.partial(jax.jit, static_argnames=("num_blocks", "max_iters"))
def orig_approx_elbo(gamma_new, gamma_old, beta_old, beta_new, pairs, y, w,
                     alpha, num_blocks: int, max_iters: int,
                     thresh: float = 1e-5):
    """Approximate ELBO of the full blockmodel (reference GLOBALPHIS
    feature: MMSBInferOrig::approx_log_likelihood,
    src/mmsbinferorig.cc:624-698, logged to logl.txt). The reference
    stores every pair's phi in an n x n x K D3 (mmsbinferorig.hh:92-101)
    purely to reuse them here; on a device the store would be n^2 K floats,
    so the phis are RE-DERIVED per pair block from the same fixed point
    they were solved with — the E-step's expectations, i.e. gamma_old's
    Elogpi and the PRE-M-step beta_old (src/mmsbinferorig.cc:238-242) —
    identical values, no global store. The f cross-term and the pair
    Elogpi terms use the POST-update beta_new/gamma_new exactly as the
    reference (compute_f reads the updated _beta at
    src/mmsbinferorig.cc:646, after set_dir_exp). Each unordered pair
    counts twice (the reference loops ordered pairs; beta is symmetric
    by the symmetrized M-step, so x2 is exact)."""
    from jax.scipy.special import gammaln
    n, k = gamma_new.shape
    elogpi_old = dirichlet_expectation(gamma_old)
    elogpi_new = dirichlet_expectation(gamma_new)
    logf1 = jnp.log(jnp.maximum(beta_old, 1e-30))
    logf0 = jnp.log(jnp.maximum(1.0 - beta_old, 1e-30))
    lf1 = jnp.log(beta_new + 1e-10)          # reference: log(f + 1e-10)
    lf0 = jnp.log(1.0 - beta_new + 1e-10)
    p_blocks = pairs.reshape(num_blocks, -1, 2)
    y_blocks = y.reshape(num_blocks, -1)
    w_blocks = w.reshape(num_blocks, -1)

    def block(s, blk):
        e, yy, ww = blk
        p, q = e[:, 0], e[:, 1]
        phi1, phi2 = _phi2_fixed_point(elogpi_old[p], elogpi_old[q],
                                       logf1, logf0, yy, max_iters,
                                       thresh)
        t1 = jnp.einsum("bg,gh,bh->b", phi1, lf1, phi2,
                        precision=_HIGHEST)
        t0 = jnp.einsum("bg,gh,bh->b", phi1, lf0, phi2,
                        precision=_HIGHEST)
        pair = jnp.where(yy == 1, t1, t0)
        pair = pair + (phi1 * elogpi_new[p]).sum(-1) \
            + (phi2 * elogpi_new[q]).sum(-1) \
            - (phi1 * jnp.log(jnp.maximum(phi1, 1e-30))).sum(-1) \
            - (phi2 * jnp.log(jnp.maximum(phi2, 1e-30))).sum(-1)
        return s + (2.0 * ww * pair).sum(), None

    s, _ = jax.lax.scan(block, jnp.float32(0.0),
                        (p_blocks, y_blocks, w_blocks))
    # per-node Dirichlet prior/entropy terms (src/mmsbinferorig.cc:668-688)
    a = jnp.float32(alpha)
    s = s + n * (gammaln(k * a) - k * gammaln(a))
    s = s + ((a - 1.0) * elogpi_new).sum()
    s = s - (gammaln(gamma_new.sum(1)).sum() - gammaln(gamma_new).sum())
    s = s - ((gamma_new - 1.0) * elogpi_new).sum()
    return s


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("num_blocks", "max_iters"))
def orig_batch_step(gamma, beta, pairs, y, w, alpha,
                    num_blocks: int, max_iters: int, thresh: float = 1e-5):
    """One full batch iteration (reference: src/mmsbinferorig.cc:211-270)."""
    n, k = gamma.shape
    elogpi = dirichlet_expectation(gamma)
    logf1 = jnp.log(jnp.maximum(beta, 1e-30))
    logf0 = jnp.log(jnp.maximum(1.0 - beta, 1e-30))
    p_blocks = pairs.reshape(num_blocks, -1, 2)
    y_blocks = y.reshape(num_blocks, -1)
    w_blocks = w.reshape(num_blocks, -1)

    def block(carry, blk):
        gacc, bnum, bden = carry
        e, yy, ww = blk
        p, q = e[:, 0], e[:, 1]
        phi1, phi2 = _phi2_fixed_point(elogpi[p], elogpi[q], logf1, logf0,
                                       yy, max_iters, thresh)
        wc = ww[:, None]
        gacc = gacc.at[p].add(2.0 * wc * phi1)
        gacc = gacc.at[q].add(2.0 * wc * phi2)
        # symmetrized ordered-pair moments, weighted (B,K)x(B,K) -> (K,K)
        w1 = phi1 * wc
        yw1 = phi1 * (wc * yy[:, None])
        outer_all = jnp.matmul(w1.T, phi2, precision=_HIGHEST)
        outer_y = jnp.matmul(yw1.T, phi2, precision=_HIGHEST)
        bnum = bnum + outer_y + outer_y.T
        bden = bden + outer_all + outer_all.T
        return (gacc, bnum, bden), None

    (gacc, bnum, bden), _ = jax.lax.scan(
        block,
        (jnp.zeros((n, k), gamma.dtype), jnp.zeros((k, k), gamma.dtype),
         jnp.zeros((k, k), gamma.dtype)),
        (p_blocks, y_blocks, w_blocks))

    gamma_new = alpha + gacc
    beta_new = jnp.clip(bnum / jnp.maximum(bden, 1e-30), 1e-5, 1.0 - 1e-5)
    return gamma_new, beta_new


@jax.jit
def orig_edge_loglik(gamma, beta, pairs, y):
    """s = sum_gh pi_p,g pi_q,h beta_gh^y (1-beta_gh)^(1-y)
    (reference: MMSBInferOrig::edge_likelihood)."""
    pi = dirichlet_mean(gamma)
    pp = pi[pairs[:, 0]]
    qq = pi[pairs[:, 1]]
    rate = jnp.where(y[:, None, None] == 1, beta[None], 1.0 - beta[None])
    s = jnp.einsum("bg,bgh,bh->b", pp, rate, qq, precision=_HIGHEST)
    return jnp.log(jnp.maximum(s, 1e-30))


class MMSBOrig(EngineBase):
    """Host driver for -orig.

    The stock reference build has NO stopping rule here (its heldout
    controller is compiled out under `#if 0`, src/mmsbinferorig.cc:499-522;
    only the GLOBALPHIS ELBO-decline stop exists, src/mmsbinferorig.cc:713-718)
    — it runs until killed. This engine keeps the classic heldout
    controller (guard iter > min(n, 5000)) as a strict improvement."""

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, network, rng)
        n, k = self.n, self.k
        g0 = self.rng.gamma(100.0, 0.01, size=(n, k))
        if cfg.itype == 0:
            # init_beta1: random uniform (reference: src/mmsbinferorig.cc:167-186)
            b0 = np.clip(self.rng.integers(0, 100, size=(k, k)) / 100.0,
                         0.01, 0.99)
        else:
            # init_beta2: data-derived assortative diag + epsilon off-diag
            # (reference: src/mmsbinferorig.cc:189-209)
            eta0 = cfg.total_pairs * cfg.ones_prob / k
            eta1 = cfg.total_pairs / (k * k) - eta0
            if eta1 < 0:
                eta1 = 1.0
            b0 = np.full((k, k), cfg.epsilon)
            np.fill_diagonal(b0, eta0 / (eta0 + eta1))
        self.gamma = jnp.asarray(g0, jnp.float32)
        self.beta = jnp.asarray(b0, jnp.float32)
        self._block = min(cfg.edge_block, 2048)

        iu = np.triu_indices(n, k=1)
        lo = iu[0].astype(np.int64)
        hi = iu[1].astype(np.int64)
        ok = network.edge_ok_mask(lo, hi)
        pairs = np.stack([lo[ok], hi[ok]], 1).astype(np.int32)
        ys = network.y(pairs[:, 0], pairs[:, 1]).astype(np.int32)
        pp, mask = pad_edges(pairs, self._block)
        yy = np.zeros(len(pp), np.int32)
        yy[: len(ys)] = ys
        self.pairs = jnp.asarray(pp)
        self.y = jnp.asarray(yy)
        self.w = jnp.asarray(mask)
        self.nb = len(pp) // self._block
        self._resume_if_requested()

    def _state_dict(self):
        d = self._host_state()
        d.update(gamma=self.gamma, beta=self.beta)
        return d

    def _restore_state(self, state) -> None:
        self.gamma = self._as_device(state["gamma"])
        self.beta = self._as_device(state["beta"])
        self._restore_host_state(state)

    def report(self) -> bool:
        cfg = self.cfg
        ll = np.asarray(orig_edge_loglik(self.gamma, self.beta,
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
        lf = (open(cfg.file_str("logl.txt"),
                   "a" if cfg.resume else "w") if cfg.logl else None)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            # capture only when the step ENDS a report interval — the
            # ELBO consumes g_old/b_old at report boundaries only, and
            # the jnp.copy is a full (n,K) device allocation
            want_elbo = (lf is not None
                         and (self.iteration + 1) % cfg.reportfreq == 0)
            g_old = self.gamma if want_elbo else None
            b_old = self.beta if want_elbo else None
            self.gamma, self.beta = orig_batch_step(
                jnp.copy(self.gamma) if want_elbo else self.gamma,
                self.beta, self.pairs, self.y, self.w,
                jnp.float32(cfg.alpha), num_blocks=self.nb,
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh)
            self.iteration += 1
            if lf is not None and self.iteration % cfg.reportfreq == 0:
                # -logl: the reference's GLOBALPHIS approx-ELBO trace,
                # written at report boundaries only
                # (src/mmsbinferorig.cc:286-292, 690-692); stopping stays
                # on the heldout rule like the non-GLOBALPHIS build
                s = float(orig_approx_elbo(
                    self.gamma, g_old, b_old, self.beta, self.pairs,
                    self.y, self.w, cfg.alpha, num_blocks=self.nb,
                    max_iters=cfg.online_iterations,
                    thresh=cfg.meanchangethresh))
                lf.write(f"{self.iteration}\t{self.duration()}\t{s:.5f}\n")
                lf.flush()
            if self.iteration % cfg.reportfreq == 0:
                if self.report():
                    self.do_on_stop()
                    return

    def do_on_stop(self, next_iteration=None) -> None:
        cfg = self.cfg
        gamma = np.asarray(self.gamma)
        beta = np.asarray(self.beta)
        with open(cfg.file_str("gamma.txt"), "w") as f:
            for i in range(self.n):
                vals = "\t".join(f"{v:.5f}" for v in gamma[i])
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t{vals}\n")
        with open(cfg.file_str("beta.txt"), "w") as f:
            for g in range(self.k):
                f.write("\t".join(f"{v:.5f}" for v in beta[g]) + "\n")
        write_groups(cfg.file_str("groups.txt"), gamma, self.network.seq2id)
        if getattr(cfg, "checkpoint_freq", 0.0):
            self.save_checkpoint(next_iteration)
