"""FastAMM engine (-infset) — stratified-subset SVI for massive sparse graphs.

JAX re-design of the reference's FastAMM (reference:
src/fastamm.cc:548-672): each iteration picks a random start node and a
Bernoulli(1e-4) coin chooses
(a) an informative step — all the node's links plus its preprocessed
    informative zeros (opt_process, src/fastamm.cc:914-1049), scale n/2;
(b) a non-informative step — noninf_setsize (200) random non-informative
    zeros from a shuffled-node ring (opt_process_noninf,
    src/fastamm.cc:1051-1126), scale n^2 / (2 eps_inf setsize).
Per-pair coupled phi fixed points produce sufficient statistics; ONLY the
touched nodes take a gamma step, each with its own Robbins-Monro counter
(src/fastamm.cc:592-602); lambda updates every iteration
(src/fastamm.cc:604-616).

The per-iteration pair set is tiny (deg + <=100 zeros, or 200 zeros), so
the minibatch is assembled host-side and shipped as one padded block; the
phi solve + scatter + the masked per-node update run as one jitted program.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.ops.expectations import dirichlet_expectation
from svinet_tpu.ops.phicomp import phi_fixed_point
from svinet_tpu.svi.base import EngineBase

INF_EPSILON = 1e-4       # reference: src/fastamm.cc:18
NONINF_SETSIZE = 200     # reference: src/fastamm.cc:18


def _fastamm_body(gamma, lam, pairs, y, w, touched, rho, alpha, eta,
                  scale, rhot, do_lambda, log_eps, max_iters: int,
                  thresh: float):
    """One FastAMM iteration. touched: (T,) node indices taking a gamma
    step this iteration (pad with n -> dump row); rho: (T,) their
    Robbins-Monro rates. Sparse form keeps the fused multi-step transfer
    at O(T) per iteration instead of O(n)."""
    n, k = gamma.shape
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    p, q = pairs[:, 0], pairs[:, 1]
    phi1, phi2 = phi_fixed_point(elogpi[p], elogpi[q], elogbeta, y,
                                 log_eps, max_iters, thresh)
    wc = w[:, None]
    gacc = jnp.zeros_like(gamma)
    gacc = gacc.at[p].add(wc * phi1)
    gacc = gacc.at[q].add(wc * phi2)
    pp = phi1 * phi2 * wc
    yf = (y == 1)[:, None]
    lacc = jnp.stack([jnp.where(yf, pp, 0.0).sum(0),
                      jnp.where(yf, 0.0, pp).sum(0)], axis=1)

    rows = jnp.clip(touched, 0, n - 1)
    upd = (1.0 - rho[:, None]) * gamma[rows] + rho[:, None] * (
        alpha + scale * gacc[rows])
    gpad = jnp.concatenate([gamma, jnp.zeros((1, k), gamma.dtype)])
    gamma = gpad.at[jnp.where(touched < n, touched, n)].set(upd)[:n]
    lambdat = eta + scale * lacc
    lam = jnp.where(do_lambda > 0,
                    (1.0 - rhot) * lam + rhot * lambdat, lam)
    return gamma, lam


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("max_iters",))
def fastamm_step(gamma, lam, pairs, y, w, touched, rho, alpha, eta,
                 scale, rhot, do_lambda, log_eps, max_iters: int,
                 thresh: float = 1e-5):
    return _fastamm_body(gamma, lam, pairs, y, w, touched, rho, alpha,
                         eta, scale, rhot, do_lambda, log_eps, max_iters,
                         thresh)


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("max_iters",))
def fastamm_multi_step(gamma, lam, b_pairs, b_y, b_w, b_touched, b_rho,
                       alpha, eta, b_scale, b_rhot, do_lambda, log_eps,
                       max_iters: int, thresh: float = 1e-5):
    """A report interval of FastAMM iterations in one device program."""
    def one(state, xs):
        g, l = state
        pairs, y, w, touched, rho, scale, rhot = xs
        return _fastamm_body(g, l, pairs, y, w, touched, rho, alpha, eta,
                             scale, rhot, do_lambda, log_eps, max_iters,
                             thresh), None
    (gamma, lam), _ = jax.lax.scan(
        one, (gamma, lam),
        (b_pairs, b_y, b_w, b_touched, b_rho, b_scale, b_rhot))
    return gamma, lam


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("max_iters", "tail_blocks"))
def fastamm_multi_step_ho(gamma, lam, b_pairs, b_y, b_w, b_touched,
                          b_rho, alpha, eta, b_scale, b_rhot, do_lambda,
                          log_eps, tail_pairs, tail_y, tail_w, eps,
                          max_iters: int, thresh: float = 1e-5,
                          tail_blocks=()):
    """fastamm_multi_step + the per-report eval sums on the final state
    (one dispatch per report; see svi/base.py eval-tail notes)."""
    from svinet_tpu.evals.likelihood import multi_heldout_sums

    def one(state, xs):
        g, l = state
        pairs, y, w, touched, rho, scale, rhot = xs
        return _fastamm_body(g, l, pairs, y, w, touched, rho, alpha, eta,
                             scale, rhot, do_lambda, log_eps, max_iters,
                             thresh), None
    (gamma, lam), _ = jax.lax.scan(
        one, (gamma, lam),
        (b_pairs, b_y, b_w, b_touched, b_rho, b_scale, b_rhot))
    sums = multi_heldout_sums(gamma, lam, tail_pairs, tail_y, tail_w,
                              eps, tail_blocks)
    return gamma, lam, sums


class FastAMM(EngineBase):
    """Host driver for -infset (requires a -preprocess run or computes the
    neighborhood sets inline when neighbors.bin is absent)."""

    dual_heldout_splits = True   # src/fastamm.cc:319-320

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, network, rng)
        n, k = self.n, self.k

        if network.sparse_zeros_ptr is None:
            import os
            nb = cfg.file_str("neighbors.bin")
            if os.path.exists(nb):
                network.load_neighborhood_sets(nb)
            elif os.path.exists("neighbors.bin"):
                network.load_neighborhood_sets("neighbors.bin")
            else:
                print("+ neighbors.bin not found; preprocessing inline")
                network.set_neighborhood_sets(cfg)

        # -fastqueue W: sparse top-W gamma (ops/sparse_gamma.py, the
        # FastQueue equivalent for huge K, src/fastqueue.hh:22-307) —
        # the (n,K) state is never materialized; init draws W random
        # slots per node with the same Gamma(100, 0.01) marginals as the
        # dense init and a uniform tail carrying the other K-W units
        self._W = int(cfg.fastqueue_width)
        if self._W > 0:
            if self._W >= k:
                raise SystemExit("-fastqueue width must be < k")
            # the sparse state is the top-W compression of the dense
            # Gamma(100, 0.01) init (src/fastamm2.cc:497-532): draw the
            # dense rows BLOCKWISE and keep each row's W largest entries
            # (distinct ids by construction — duplicate slot ids would
            # make densify drop mass and _value_at_slots double-count)
            # plus the exact remainder mass. Only (B, k) ever exists.
            w = self._W
            ids = np.empty((n, w), np.int32)
            vals = np.empty((n, w), np.float32)
            rest = np.empty(n, np.float32)
            bsz = max(1, (1 << 24) // max(k, 1))
            for lo in range(0, n, bsz):
                g = self.rng.gamma(100.0, 0.01,
                                   size=(min(bsz, n - lo), k))
                top = np.argpartition(-g, w - 1, axis=1)[:, :w]
                v = np.take_along_axis(g, top, 1)
                hi = lo + len(g)
                ids[lo:hi] = top
                vals[lo:hi] = v
                rest[lo:hi] = np.maximum(g.sum(1) - v.sum(1), 0.0)
            self.ids = jnp.asarray(ids)
            self.vals = jnp.asarray(vals)
            self.rest = jnp.asarray(rest)
            self.gamma = None
            cfg.plog("fastqueue width", self._W)
        else:
            from svinet_tpu.svi.mmsb import init_gamma_random
            self.gamma = jnp.asarray(init_gamma_random(self.rng, n, k),
                                     jnp.float32)
        l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        self.lam = jnp.asarray(l0, jnp.float32)
        self.eta = jnp.asarray(l0, jnp.float32)
        self.alpha = jnp.float32(cfg.alpha)
        self.log_eps = jnp.float32(np.log(cfg.epsilon))

        self._nodec = np.zeros(n, np.int64)
        self._shuffled = self.rng.permutation(n)
        self._lambda_start_iter = 0
        # cmap.txt: per-report mean/stdev of sampled neighborhood-set
        # sizes (reference: src/fastamm.cc:223-227, 636-640)
        self._nbr_sizes: list = []
        self._cmapf = open(cfg.file_str("cmap.txt"),
                           "a" if cfg.resume else "w")
        # fixed padded batch size: max informative set or noninf set
        max_deg = int(network.training_deg.max()) if n else 0
        self._pad = 1 << int(np.ceil(np.log2(
            max(max_deg + 100 + 1, NONINF_SETSIZE, 64))))
        self._resume_if_requested()

    # ------------------------------------------------------------------
    def report(self) -> bool:
        stop = super().report()
        sizes = self._nbr_sizes or [0]
        self._cmapf.write(f"{self.iteration}\t{self.duration()}\t"
                          f"{np.mean(sizes):.5f}\t{np.std(sizes):.5f}\n")
        self._cmapf.flush()
        self._nbr_sizes = []
        return stop

    def _edge_ok(self, lo, hi) -> np.ndarray:
        return self.network.edge_ok_mask(lo, hi)

    def _informative_sample(self) -> Tuple[np.ndarray, np.ndarray, list]:
        r = int(self.rng.integers(0, self.n))
        nbrs = self.network.neighbors(r).astype(np.int64)
        zeros = self.network.sparse_zeros(r).astype(np.int64)
        others = np.concatenate([nbrs, zeros])
        ys = np.concatenate([np.ones(len(nbrs), np.int32),
                             np.zeros(len(zeros), np.int32)])
        lo = np.minimum(r, others)
        hi = np.maximum(r, others)
        ok = self._edge_ok(lo, hi) & (others != r)
        pairs = np.stack([lo[ok], hi[ok]], 1)
        nodes = [r] + [int(x) for x in others[ok]]
        self._nbr_sizes.append(int(ok.sum()))
        return pairs.astype(np.int32), ys[ok], nodes

    def _noninf_sample(self) -> Tuple[np.ndarray, np.ndarray, list]:
        # batched ring walk (svi/sampling.py): same first-`setsize`
        # survivors as the reference's one-node-at-a-time scan
        # (src/fastamm.cc:1051-1126) at numpy speed
        from svinet_tpu.svi.sampling import (ring_nonlink_scan,
                                             nonlink_accept)
        r = int(self.rng.integers(0, self.n))
        inf_sorted = np.sort(self.network.sparse_zeros(r).astype(np.int64))
        start = int(self.rng.integers(0, self.n))
        others = ring_nonlink_scan(
            self._shuffled, self.n, start, NONINF_SETSIZE,
            nonlink_accept(self.network, r, inf_sorted,
                           require_edge_ok=True))
        lo = np.minimum(r, others)
        hi = np.maximum(r, others)
        pairs = np.stack([lo, hi], 1).astype(np.int32) if len(others) else \
            np.zeros((0, 2), np.int32)
        nodes = [r] + [int(x) for x in others]
        return pairs, np.zeros(len(others), np.int32), nodes

    # ------------------------------------------------------------------
    def _prepare(self, it: int):
        """Sample one iteration's pair set + touched-node schedule;
        advances the per-node counters host-side."""
        cfg = self.cfg
        n = self.n
        coin = self.rng.uniform() < INF_EPSILON
        if not coin:
            pairs, ys, nodes = self._informative_sample()
            scale = n / 2.0
        else:
            pairs, ys, nodes = self._noninf_sample()
            scale = (float(n) * n) / (2.0 * INF_EPSILON * NONINF_SETSIZE)

        pad = self._pad
        pp = np.zeros((pad, 2), np.int32)
        yy = np.zeros(pad, np.int32)
        ww = np.zeros(pad, np.float32)
        m = min(len(pairs), pad)
        pp[:m] = pairs[:m]
        yy[:m] = ys[:m]
        ww[:m] = 1.0

        tpad = pad + 8
        touched = np.full(tpad, n, np.int32)      # pad -> dump row
        rho = np.zeros(tpad, np.float32)
        for j, a in enumerate(nodes[:tpad]):
            touched[j] = a
            rho[j] = (cfg.nodetau0 + self._nodec[a]) ** (-cfg.nodekappa)
            self._nodec[a] += 1

        rhot = (cfg.tau0 + (it - self._lambda_start_iter + 1)
                ) ** (-cfg.kappa)
        return pp, yy, ww, touched, rho, scale, rhot

    def _local_idx(self, pp: np.ndarray, touched: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Map pair endpoints to their positions in the touched list
        (pad pairs land on the trailing dump slot)."""
        pos = {int(a): j for j, a in enumerate(touched)}
        dump = len(touched) - 1
        lp = np.fromiter((pos.get(int(x), dump) for x in pp[:, 0]),
                         np.int32, len(pp))
        lq = np.fromiter((pos.get(int(x), dump) for x in pp[:, 1]),
                         np.int32, len(pp))
        return lp, lq

    def _step_many_sparse(self, count: int) -> None:
        from svinet_tpu.ops.sparse_gamma import (
            sparse_fastamm_step, sparse_fastamm_multi_step)
        cfg = self.cfg
        batches = [self._prepare(self.iteration + b) for b in range(count)]
        do_lam = jnp.float32(0.0 if cfg.nolambda else 1.0)
        locs = [self._local_idx(b[0], b[3]) for b in batches]
        if count == 1:
            pp, yy, ww, touched, rho, scale, rhot = batches[0]
            lp, lq = locs[0]
            self.ids, self.vals, self.rest, self.lam = sparse_fastamm_step(
                self.ids, self.vals, self.rest, self.lam,
                jnp.asarray(pp), jnp.asarray(yy), jnp.asarray(ww),
                jnp.asarray(lp), jnp.asarray(lq), jnp.asarray(touched),
                jnp.asarray(rho), self.alpha, self.eta, jnp.float32(scale),
                jnp.float32(rhot), do_lam, self.log_eps, k=self.k,
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh)
            return
        stack = lambda i, dt: jnp.asarray(
            np.stack([b[i] for b in batches]).astype(dt))
        self.ids, self.vals, self.rest, self.lam = \
            sparse_fastamm_multi_step(
                self.ids, self.vals, self.rest, self.lam,
                stack(0, np.int32), stack(1, np.int32), stack(2, np.float32),
                jnp.asarray(np.stack([l[0] for l in locs])),
                jnp.asarray(np.stack([l[1] for l in locs])),
                stack(3, np.int32), stack(4, np.float32),
                self.alpha, self.eta, stack(5, np.float32),
                stack(6, np.float32), do_lam, self.log_eps, k=self.k,
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh)

    def _heldout(self, pairs, y):
        if not self._W:
            return super()._heldout(pairs, y)
        from svinet_tpu.evals.likelihood import HeldoutResult
        from svinet_tpu.ops.sparse_gamma import sparse_pair_scores
        s_one, inner = sparse_pair_scores(
            self.ids, self.vals, self.rest, self.lam, jnp.asarray(pairs),
            k=self.k)
        s_one = np.asarray(s_one)
        inner = np.asarray(inner)
        eps = self.cfg.epsilon
        s_zero = inner - s_one + (1.0 - inner) * (1.0 - eps)
        yy = np.asarray(y)
        s = np.where(yy == 1, s_one, s_zero)
        ll = np.log(np.maximum(s, 1e-30))
        ones = yy == 1
        return HeldoutResult(
            avg=float(ll.mean()), count=len(ll),
            avg0=float(ll[~ones].mean()) if (~ones).any() else 0.0,
            count0=int((~ones).sum()),
            avg1=float(ll[ones].mean()) if ones.any() else 0.0,
            count1=int(ones.sum()))

    def log_communities(self) -> None:
        if not self._W:
            return super().log_communities()
        # link-community extraction on the sparse state: argmax phi over
        # each link's union slots; membership counting via sorted
        # (node, community) keys — no (n,K) host matrix
        from svinet_tpu.ops.sparse_gamma import sparse_edge_assignments
        from svinet_tpu.io.writers import write_communities
        cfg = self.cfg
        tl = self.network.training_links
        cids, mx = [], []
        for lo in range(0, len(tl), 8192):
            c, m = sparse_edge_assignments(
                self.ids, self.vals, self.rest, self.lam,
                jnp.asarray(tl[lo: lo + 8192]), k=self.k)
            cids.append(np.asarray(c))
            mx.append(np.asarray(m))
        cids = np.concatenate(cids) if cids else np.zeros(0, np.int32)
        mx = np.concatenate(mx) if mx else np.zeros(0)
        sel = mx > cfg.link_thresh
        nodes = np.concatenate([tl[sel, 0], tl[sel, 1]]).astype(np.int64)
        cs = np.concatenate([cids[sel], cids[sel]]).astype(np.int64)
        keys, counts = np.unique(nodes * self.k + cs, return_counts=True)
        keep = counts > cfg.lt_min_deg
        comms: dict = {}
        for key in keys[keep]:
            comms.setdefault(int(key % self.k), []).append(
                int(key // self.k))
        self._communities = comms
        write_communities(cfg.file_str("communities.txt"), comms,
                          self.network.seq2id)
        # mcount.txt / aggregate.txt from the same sorted keys
        m_nodes, m_counts = np.unique(keys[keep] // self.k,
                                      return_counts=True)
        with open(cfg.file_str("mcount.txt"), "w") as f:
            for node, c in zip(m_nodes, m_counts):
                f.write(f"{int(node)}\t"
                        f"{int(self.network.seq2id[int(node)])}\t{int(c)}\n")
        with open(cfg.file_str("aggregate.txt"), "w") as f:
            vs, cc = np.unique(m_counts, return_counts=True)
            for v, c in zip(vs, cc):
                f.write(f"{int(v)}\t{int(c)}\n")
        if self._mutual is not None:
            from svinet_tpu.evals.nmi import overlapping_nmi, read_cover_file
            ours = read_cover_file(cfg.file_str("communities.txt"))
            gt = read_cover_file(cfg.file_str("ground_truth.txt"))
            self._mutual.write(f"mutual3:\t{overlapping_nmi(gt, ours):g}\n")
            self._mutual.flush()

    def _state_dict(self):
        if not self._W:
            d = super()._state_dict()
        else:
            d = self._host_state()
            d.update(ids=self.ids, vals=self.vals, rest=self.rest,
                     lam=self.lam)
        # per-node Robbins-Monro counters ARE schedule state (reference:
        # src/fastamm.cc:594 keeps per-node counts): losing them on
        # resume resets every touched node's rho to (nodetau0)^-nodekappa
        d["nodec"] = self._nodec
        return d

    def _restore_state(self, state) -> None:
        if not self._W:
            super()._restore_state(state)
        else:
            self.ids = self._as_device(state["ids"])
            self.vals = self._as_device(state["vals"])
            self.rest = self._as_device(state["rest"])
            self.lam = self._as_device(state["lam"])
            self._restore_host_state(state)
        nc = state.get("nodec")
        if nc is not None:
            self._nodec = np.asarray(nc, np.int64)

    def do_on_stop(self, next_iteration=None) -> None:
        if not self._W:
            return super().do_on_stop(next_iteration=next_iteration)
        # densify for the TSV interop surface (gamma.txt is (n,K) text by
        # schema regardless of the in-memory representation)
        from svinet_tpu.ops.sparse_gamma import densify
        self.gamma = densify(self.ids, self.vals, self.rest, self.k)
        super().do_on_stop(next_iteration=next_iteration)
        self.gamma = None

    def _step_many(self, count: int) -> None:
        """`count` iterations fused into one device call (host sampling,
        device scan — same dispatch-count optimization as the other
        engines)."""
        if self._W:
            return self._step_many_sparse(count)
        cfg = self.cfg
        batches = [self._prepare(self.iteration + b) for b in range(count)]
        do_lam = jnp.float32(0.0 if cfg.nolambda else 1.0)
        self._tail_res = None
        tail = self._tail_device_sets()
        stack = lambda i, dt: jnp.asarray(
            np.stack([b[i] for b in batches]).astype(dt))
        if tail is not None:
            tp, ty, tw, tnb, _ = tail
            self.gamma, self.lam, sums = fastamm_multi_step_ho(
                self.gamma, self.lam, stack(0, np.int32),
                stack(1, np.int32), stack(2, np.float32),
                stack(3, np.int32), stack(4, np.float32),
                self.alpha, self.eta, stack(5, np.float32),
                stack(6, np.float32), do_lam, self.log_eps,
                tp, ty, tw, jnp.float32(cfg.epsilon),
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh, tail_blocks=tnb)
            self._stash_tail(sums)
            return
        if count == 1:
            pp, yy, ww, touched, rho, scale, rhot = batches[0]
            self.gamma, self.lam = fastamm_step(
                self.gamma, self.lam, jnp.asarray(pp), jnp.asarray(yy),
                jnp.asarray(ww), jnp.asarray(touched), jnp.asarray(rho),
                self.alpha, self.eta, jnp.float32(scale),
                jnp.float32(rhot), do_lam, self.log_eps,
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh)
            return
        self.gamma, self.lam = fastamm_multi_step(
            self.gamma, self.lam, stack(0, np.int32), stack(1, np.int32),
            stack(2, np.float32), stack(3, np.int32), stack(4, np.float32),
            self.alpha, self.eta, stack(5, np.float32),
            stack(6, np.float32), do_lam, self.log_eps,
            max_iters=cfg.online_iterations, thresh=cfg.meanchangethresh)

    def _step(self) -> None:
        self._step_many(1)

    def infer(self) -> None:
        cfg = self.cfg
        r = max(cfg.reportfreq, 1)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            todo = r - (self.iteration % r)
            if cfg.max_iterations:
                todo = min(todo, cfg.max_iterations - self.iteration + 1)
            self._step_many(todo)
            self.iteration += todo
            if self.iteration % r == 0:
                if self.report():
                    self.do_on_stop()
                    return
