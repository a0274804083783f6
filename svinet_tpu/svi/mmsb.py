"""MMSBInfer engine — classic SVI with iterated per-pair local steps.

JAX re-design of the reference's MMSBInfer
(reference: src/mmsbinfer.cc:459-930): per iteration, sample a minibatch
of node pairs (random pairs | a random node's n-1 pairs | stratified
link/nonlink families), run the coupled phi fixed point per pair
(ops/phicomp.py), then take natural-gradient Robbins-Monro steps on
gamma and lambda:

  rho_node = (nodetau0 + iter/100)^(-nodekappa)
  gamma <- (1-rho_node) gamma + rho_node (alpha + w * gamma_hat)
      w = scale/mbsize (rpair, scale=total_pairs [*family_prob when
      stratified]) or scale = n/2 (rnode)
      (reference: src/mmsbinfer.cc:563-597)
  lambda update gated by delaylearn until iter*s > total_pairs, then
  rho_t = (tau0 + iter - lambda_start_iter + 1)^(-kappa)
  lambda <- (1-rho_t) lambda + rho_t (eta + w * lambda_hat)
      (reference: src/mmsbinfer.cc:611-641)

batch_infer sweeps ALL non-heldout pairs (links and nonlinks) each
iteration with plain coordinate ascent gamma = alpha + sum phi
(reference: src/mmsbinfer.cc:833-930).

The per-pair C++ loop becomes a lax.scan over padded pair blocks; each
block solves the phi fixed point for the whole block at once and
scatter-adds weighted sufficient statistics. Minibatches are sampled
host-side with numpy (matching the reference's rejection sampling
semantics exactly, src/mmsbinfer.hh:719-748) and shipped as one small
(s,2) array per step.
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
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.ops.phicomp import phi_fixed_point
from svinet_tpu.svi.base import EngineBase


def pair_block_stats(elogpi, elogbeta, pairs, y, w, num_blocks: int,
                     log_eps: float, max_iters: int, thresh: float):
    """Scan over pair blocks: solve phi fixed point, accumulate weighted
    sufficient statistics gamma_hat (n,K) and lambda_hat (K,2)."""
    n, k = elogpi.shape
    p_blocks = pairs.reshape(num_blocks, -1, 2)
    y_blocks = y.reshape(num_blocks, -1)
    w_blocks = w.reshape(num_blocks, -1)

    def block(carry, blk):
        gacc, lacc = carry
        e, yy, ww = blk
        p, q = e[:, 0], e[:, 1]
        phi1, phi2 = phi_fixed_point(elogpi[p], elogpi[q], elogbeta, yy,
                                     log_eps, max_iters, thresh)
        wc = ww[:, None]
        gacc = gacc.at[p].add(wc * phi1)
        gacc = gacc.at[q].add(wc * phi2)
        pp = phi1 * phi2 * wc
        yf = (yy == 1)[:, None]
        lacc = lacc + jnp.stack(
            [jnp.where(yf, pp, 0.0).sum(0), jnp.where(yf, 0.0, pp).sum(0)],
            axis=1)
        return (gacc, lacc), None

    (gacc, lacc), _ = jax.lax.scan(
        block,
        (jnp.zeros((n, k), elogpi.dtype), jnp.zeros((k, 2), elogpi.dtype)),
        (p_blocks, y_blocks, w_blocks))
    return gacc, lacc


def nonuniform_weights(gamma, pairs, y, mask, infthresh: float):
    """-nonuniform pair weighting, on device from the CURRENT gamma
    (reference: MMSBInfer::opt_nonuniform_process,
    src/mmsbinfer.cc:1525-1700). Pairs are classified by the prior link
    probability p_i = E[pi_p] . E[pi_q]:

      links                        all processed, weight = #links
      zeros with p_i <  infthresh  first 1 processed,  weight = #noninf zeros
      zeros with p_i >= infthresh  first 0.1% processed, weight = #inf zeros

    (caps n1_max/n2_max/n3_max and the per-category phi scaling at
    src/mmsbinfer.cc:1568-1571, 1608-1655; the phi pre-scale by the
    category count and the 1/count on lambda_hat net out to `count` on
    both gamma_hat and lambda_hat, folded here into one weight).
    Returns (weights, n_processed) — n_processed feeds the rnode scale
    3n / (2 (n1+n2+n3)) (src/mmsbinfer.cc:571-572)."""
    gp = gamma[pairs[:, 0]]
    gq = gamma[pairs[:, 1]]
    pip = gp / gp.sum(-1, keepdims=True)
    piq = gq / gq.sum(-1, keepdims=True)
    p_i = jnp.clip((pip * piq).sum(-1), 0.0, 1.0)
    valid = mask > 0
    is_link = (y == 1) & valid
    noninf = (y == 0) & valid & (p_i < infthresh)
    inf = (y == 0) & valid & (p_i >= infthresh)
    nones = is_link.sum()
    nz_inf = inf.sum()
    nz_noninf = noninf.sum()
    n3_max = (0.001 * nz_inf).astype(jnp.int32)
    sel_noninf = noninf & (jnp.cumsum(noninf.astype(jnp.int32)) <= 1)
    sel_inf = inf & (jnp.cumsum(inf.astype(jnp.int32)) <= n3_max)
    f = gamma.dtype
    w = (is_link.astype(f) * nones.astype(f)
         + sel_noninf.astype(f) * nz_noninf.astype(f)
         + sel_inf.astype(f) * nz_inf.astype(f))
    n_processed = nones + sel_noninf.sum() + sel_inf.sum()
    return w, n_processed


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "max_iters", "infthresh",
                                    "nonuniform"))
def svi_step(gamma, lam, pairs, y, w, alpha, eta, gscale, lscale,
             noderhot, rhot, do_lambda, log_eps, num_blocks: int,
             max_iters: int, thresh: float = 1e-5,
             infthresh: float = 0.0, nonuniform: bool = False):
    """One natural-gradient SVI step (reference: src/mmsbinfer.cc:563-641).

    gscale/lscale fold in scale/mbsize; noderhot/rhot are the Robbins-Monro
    rates (host computes them from the step index — replica-consistent by
    construction, no communication needed). infthresh > 0 masks out
    uninformative zero-pairs: nonlinks whose max_k pi_p pi_q falls below
    the threshold skip the local step entirely (reference:
    MMSBInfer::opt_process, src/mmsbinfer.cc:1192-1298). nonuniform
    replaces the mask with the category-weighted sampler and the rnode
    scale 3n/(2 n_processed) (src/mmsbinfer.cc:1525-1700, 571-572);
    with it set, gscale/lscale carry the rnode flag: > 0 means rnode
    (device-computed scale), <= 0 means keep the host scale as |gscale|."""
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    if nonuniform and infthresh > 0.0:
        wnu, n_proc = nonuniform_weights(gamma, pairs, y, w, infthresh)
        n = jnp.asarray(gamma.shape[0], gamma.dtype)
        dev_scale = 3.0 * n / (2.0 * jnp.maximum(n_proc, 1).astype(
            gamma.dtype))
        gscale = jnp.where(gscale > 0, dev_scale, -gscale)
        lscale = jnp.where(lscale > 0, dev_scale, -lscale)
        w = wnu
    elif infthresh > 0.0:
        # normalize only the gathered minibatch rows, not all of gamma
        gp = gamma[pairs[:, 0]]
        gq = gamma[pairs[:, 1]]
        pip = gp / gp.sum(-1, keepdims=True)
        piq = gq / gq.sum(-1, keepdims=True)
        inf = (pip * piq).max(-1) >= infthresh
        w = jnp.where((y == 1) | inf, w, 0.0)
    gacc, lacc = pair_block_stats(elogpi, elogbeta, pairs, y, w, num_blocks,
                                  log_eps, max_iters, thresh)
    gammat = alpha + gscale * gacc
    gamma = (1.0 - noderhot) * gamma + noderhot * gammat
    lambdat = eta + lscale * lacc
    lam = jnp.where(do_lambda > 0,
                    (1.0 - rhot) * lam + rhot * lambdat, lam)
    return gamma, lam


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "max_iters", "infthresh",
                                    "nonuniform"))
def svi_multi_step(gamma, lam, batch_pairs, batch_y, batch_w, alpha, eta,
                   gscales, lscales, noderhots, rhots, do_lambdas,
                   log_eps, num_blocks: int, max_iters: int,
                   thresh: float = 1e-5, infthresh: float = 0.0,
                   nonuniform: bool = False):
    """B natural-gradient SVI steps fused into one device program.

    batch_pairs: (B, s, 2) pre-sampled minibatches (host rng keeps the
    reference's rejection-sampling semantics); per-step schedule scalars
    arrive as (B,) arrays. One host round trip per report interval — the
    same dispatch-count optimization as linksampling_multi_sweep."""

    def one(state, xs):
        g, l = state
        pairs, y, w, gs, ls, nr, rt, dl = xs
        g, l = svi_step.__wrapped__(
            g, l, pairs, y, w, alpha, eta, gs, ls, nr, rt, dl, log_eps,
            num_blocks, max_iters, thresh, infthresh, nonuniform)
        return (g, l), None

    (gamma, lam), _ = jax.lax.scan(
        one, (gamma, lam),
        (batch_pairs, batch_y, batch_w, gscales, lscales, noderhots,
         rhots, do_lambdas))
    return gamma, lam


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "max_iters", "infthresh",
                                    "nonuniform", "tail_blocks"))
def svi_multi_step_ho(gamma, lam, batch_pairs, batch_y, batch_w, alpha,
                      eta, gscales, lscales, noderhots, rhots, do_lambdas,
                      log_eps, tail_pairs, tail_y, tail_w, eps,
                      num_blocks: int, max_iters: int,
                      thresh: float = 1e-5, infthresh: float = 0.0,
                      nonuniform: bool = False, tail_blocks=()):
    """svi_multi_step + the per-report pair-set sums (stop split,
    validation split, training sample) evaluated on the FINAL state as
    the tail of the same program — one dispatch per report instead of
    step + 2-3 standalone evals (round-4 review item 5; reference
    evaluates each set in its own pass, src/mmsbinfer.cc:2085-2174).
    Returns (gamma, lam, (S, 6) sums)."""
    from svinet_tpu.evals.likelihood import multi_heldout_sums

    def one(state, xs):
        g, l = state
        pairs, y, w, gs, ls, nr, rt, dl = xs
        g, l = svi_step.__wrapped__(
            g, l, pairs, y, w, alpha, eta, gs, ls, nr, rt, dl, log_eps,
            num_blocks, max_iters, thresh, infthresh, nonuniform)
        return (g, l), None

    (gamma, lam), _ = jax.lax.scan(
        one, (gamma, lam),
        (batch_pairs, batch_y, batch_w, gscales, lscales, noderhots,
         rhots, do_lambdas))
    sums = multi_heldout_sums(gamma, lam, tail_pairs, tail_y, tail_w,
                              eps, tail_blocks)
    return gamma, lam, sums


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "max_iters"))
def batch_step(gamma, lam, pairs, y, w, alpha, eta, do_lambda, log_eps,
               num_blocks: int, max_iters: int, thresh: float = 1e-5):
    """One full coordinate-ascent pass over all non-heldout pairs
    (reference: MMSBInfer::batch_infer, src/mmsbinfer.cc:833-895)."""
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    gacc, lacc = pair_block_stats(elogpi, elogbeta, pairs, y, w, num_blocks,
                                  log_eps, max_iters, thresh)
    gamma = alpha + gacc
    lam = jnp.where(do_lambda > 0, eta + lacc, lam)
    return gamma, lam


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "max_iters",
                                    "tail_blocks"))
def batch_step_ho(gamma, lam, pairs, y, w, alpha, eta, do_lambda,
                  log_eps, tail_pairs, tail_y, tail_w, eps,
                  num_blocks: int, max_iters: int, thresh: float = 1e-5,
                  tail_blocks=()):
    """batch_step + the eval tail (see svi_multi_step_ho)."""
    from svinet_tpu.evals.likelihood import multi_heldout_sums
    gamma, lam = batch_step.__wrapped__(
        gamma, lam, pairs, y, w, alpha, eta, do_lambda, log_eps,
        num_blocks, max_iters, thresh)
    sums = multi_heldout_sums(gamma, lam, tail_pairs, tail_y, tail_w,
                              eps, tail_blocks)
    return gamma, lam, sums


def init_gamma_random(rng: np.random.Generator, n: int, k: int,
                      deterministic: bool = False) -> np.ndarray:
    """gamma_ij ~ Gamma(shape=100, scale=0.01): mean 1 with ~10% noise — a
    near-symmetric start whose small fluctuations break community symmetry
    (reference: MMSBInfer::init_gamma, src/mmsbinfer.cc:373-386).
    Deterministic mode uses the reference's closed-form seed grid
    (src/mmsbinfer.cc:376-383)."""
    if deterministic:
        i = np.arange(n)[:, None].astype(np.float64)
        j = np.arange(k)[None, :].astype(np.float64)
        g = 0.09 + 0.01 * ((i + 1.0) / (i + j + 1.0))
        return np.minimum(g, 0.9)
    return rng.gamma(100.0, 1.0 / 100.0, size=(n, k))


class MMSBInfer(EngineBase):
    """Host driver for batch / rpair / rnode / stratified modes."""

    dual_heldout_splits = True   # src/mmsbinfer.cc:206-328

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, network, rng)
        n, k = self.n, self.k

        if cfg.model_load and cfg.gamma_location:
            from svinet_tpu.io.writers import load_model
            g0, l0 = load_model(cfg.gamma_location, n, k, cfg.t)
        else:
            g0 = init_gamma_random(self.rng, n, k, cfg.deterministic)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        self.gamma = jnp.asarray(g0, jnp.float32)
        self.lam = jnp.asarray(l0, jnp.float32)
        self.alpha = jnp.float32(cfg.alpha)
        self.eta = jnp.asarray(np.tile([cfg.eta0, cfg.eta1], (k, 1)),
                               jnp.float32)
        self.log_eps = float(np.log(cfg.epsilon))

        self._family = 0
        # -nonuniform needs -inf (reference dispatch: opt_nonuniform only
        # runs under `if (_env.infthresh)`, src/mmsbinfer.cc:543-548)
        self._nonuniform = bool(cfg.nonuniform and cfg.infthresh > 0)
        self._lambda_start_iter = 0
        self._delaylearn_reported = False
        self._block = min(cfg.edge_block, 2048)

        # -mesh N: minibatch pairs sharded across a device mesh,
        # gamma/lambda replicated, sufficient statistics psum'd — the sharded
        # equivalent of the reference's pthread map-reduce, which lived
        # exactly here in MMSBInfer (src/mmsbinfer.cc:2400-2550)
        self._mesh = None
        if cfg.mesh_devices > 1:
            import jax
            from svinet_tpu.parallel.mesh import (
                make_mesh, device_put_replicated)
            nd = cfg.mesh_devices
            if nd > len(jax.devices()):
                raise SystemExit(f"-mesh {nd} but only "
                                 f"{len(jax.devices())} devices visible")
            self._mesh = make_mesh(nd)
            self._nd = nd
            self._mesh_fns = {}
            (self.gamma, self.lam, self.alpha, self.eta,
             self._log_eps_d, self._tail_eps) = device_put_replicated(
                self._mesh, self.gamma, self.lam, self.alpha, self.eta,
                jnp.float32(self.log_eps), jnp.float32(cfg.epsilon))
            cfg.plog("mesh devices", nd)
        # trace files keep pre-resume history like the other report files
        _m = "a" if cfg.resume else "w"
        self._lf = open(cfg.file_str("logl.txt"), _m) if cfg.logl else None
        self._mf = open(cfg.file_str("modularity.txt"), _m)
        self._elbo_cache = None
        self._resume_if_requested()

    def _state_dict(self):
        d = super()._state_dict()
        # the lambda Robbins-Monro clock and the stratified family phase
        # ARE schedule state (base.py's checkpoint doctrine): without
        # them a resume resets rhot to (tau0+1)^-kappa — a near-full-size
        # lambda step on a converged state — and restarts the
        # link/nonlink alternation at 0
        d["lambda_clock"] = [int(self._lambda_start_iter),
                            int(self._delaylearn_reported),
                            int(self._family)]
        return d

    def _restore_state(self, state) -> None:
        super()._restore_state(state)
        lc = state.get("lambda_clock")
        if lc is not None:
            lc = [int(x) for x in np.asarray(lc)]
            self._lambda_start_iter = lc[0]
            self._delaylearn_reported = bool(lc[1])
            self._family = lc[2]
        if self._mesh is not None:
            # restored arrays must go back to the mesh-replicated layout
            # the sharded step fns expect
            from svinet_tpu.parallel.mesh import device_put_replicated
            self.gamma, self.lam = device_put_replicated(
                self._mesh, self.gamma, self.lam)

    def _tail_put(self, arr):
        if self._mesh is not None:
            from svinet_tpu.parallel.mesh import device_put_replicated
            out, = device_put_replicated(self._mesh, arr)
            return out
        return jnp.asarray(arr)

    # ------------------------------------------------------------------
    def _y_of(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        # Network.y owns the canonical sorted-key lookup (and its
        # drop_singles rebuild); do not duplicate the key array here
        return self.network.y(lo, hi).astype(np.int32)

    def _edge_ok(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return self.network.edge_ok_mask(lo, hi)

    def _sample_rpair(self, s: int, family: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """s uniform random valid pairs, with replacement
        (reference: get_random_edge, src/mmsbinfer.hh:719-748)."""
        out = np.zeros((0, 2), np.int64)
        ys = np.zeros(0, np.int32)
        while len(out) < s:
            m = max(64, 2 * (s - len(out)))
            if family == 1:
                tl = self.network.training_links
                sel = self.rng.integers(0, len(tl), size=m)
                lo = tl[sel, 0].astype(np.int64)
                hi = tl[sel, 1].astype(np.int64)
                ok = np.ones(m, bool)
            else:
                a = self.rng.integers(0, self.n, size=m)
                b = self.rng.integers(0, self.n, size=m)
                lo, hi = np.minimum(a, b), np.maximum(a, b)
                ok = lo != hi
                ok &= self._edge_ok(lo, hi)
            lo, hi = lo[ok], hi[ok]
            y = self._y_of(lo, hi)
            if family is not None:
                keep = y == family
                lo, hi, y = lo[keep], hi[keep], y[keep]
            take = min(s - len(out), len(lo))
            out = np.concatenate([out, np.stack([lo[:take], hi[:take]], 1)])
            ys = np.concatenate([ys, y[:take]])
        return out.astype(np.int32), ys

    def _sample_rnode(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A random node's n-1 valid pairs
        (reference: get_randomnode_edges, src/mmsbinfer.cc:1866-1876)."""
        r = int(self.rng.integers(0, self.n))
        other = np.concatenate([np.arange(r), np.arange(r + 1, self.n)])
        lo = np.minimum(r, other).astype(np.int64)
        hi = np.maximum(r, other).astype(np.int64)
        ok = self._edge_ok(lo, hi)
        lo, hi = lo[ok], hi[ok]
        y = self._y_of(lo, hi)
        w = np.ones(len(lo), np.float32)
        ss = self.cfg.subsample_scale
        if ss > 1:
            zeros = np.nonzero(y == 0)[0]
            drop = zeros[np.arange(len(zeros)) % ss != 0]
            w[drop] = 0.0
            w[zeros[np.arange(len(zeros)) % ss == 0]] = float(ss)
        return np.stack([lo, hi], 1).astype(np.int32), y, w

    # ------------------------------------------------------------------
    def _pad_to(self, m: int) -> int:
        """Pad a minibatch of m pairs to a whole number of edge blocks —
        and, under -mesh, to nd equal per-shard block multiples."""
        b = self._block
        pt = max(b, ((m + b - 1) // b) * b)
        if self._mesh is not None:
            per = max(b, ((pt + self._nd - 1) // self._nd + b - 1)
                      // b * b)
            pt = per * self._nd
        return pt

    def _prepare_minibatch(self, it: int):
        """Sample one minibatch + its schedule scalars; advances the host
        sampling state (family alternation, delaylearn bookkeeping)."""
        cfg = self.cfg
        n = self.n
        if cfg.randomnode:
            pairs, y, w = self._sample_rnode()
            scale = n / 2.0
            gscale = lscale = scale
            pad_to = self._pad_to(n)
        else:
            s = cfg.s
            fam = self._family if cfg.stratified else None
            pairs, y = self._sample_rpair(s, fam)
            w = np.ones(len(pairs), np.float32)
            scale = float(self.network.total_pairs)
            if cfg.stratified:
                scale *= (cfg.ones_prob if self._family == 1
                          else cfg.zeros_prob)
            gscale = lscale = scale / len(pairs)
            pad_to = self._pad_to(s)
        if self._nonuniform:
            # device computes the rnode scale 3n/(2 n_processed); sign
            # flags the mode (see svi_step): > 0 rnode, <= 0 host scale
            gscale = lscale = (1.0 if cfg.randomnode else -gscale)

        pp = np.zeros((pad_to, 2), np.int32)
        yy = np.zeros(pad_to, np.int32)
        ww = np.zeros(pad_to, np.float32)
        pp[:len(pairs)] = pairs
        yy[:len(pairs)] = y
        ww[:len(pairs)] = w

        noderhot = (cfg.nodetau0 + it / 100.0) ** (-cfg.nodekappa)
        do_lambda = 0.0
        rhot = 0.0
        if not cfg.nolambda and (
                not cfg.delaylearn or
                it * cfg.s > self.network.total_pairs):
            if not self._delaylearn_reported:
                self._lambda_start_iter = it
                cfg.plog("learning lambda since (iter)", it)
                self._delaylearn_reported = True
            rhot = (cfg.tau0 + (it - self._lambda_start_iter + 1)) ** (
                -cfg.kappa)
            do_lambda = 1.0

        if cfg.stratified:
            self._family = 0 if self._family else 1
        return (pp, yy, ww, gscale, lscale, noderhot, rhot, do_lambda,
                pad_to)

    def _step_minibatches(self, count: int) -> None:
        """Run `count` SVI steps with ONE device call: minibatches are
        sampled host-side (reference rng semantics preserved) and the
        per-step updates scan on device. Under -mesh the pair axis is
        sharded and the sufficient statistics psum'd (the reference's
        pthread map-reduce, src/mmsbinfer.cc:2400-2550)."""
        cfg = self.cfg
        batches = [self._prepare_minibatch(self.iteration + b)
                   for b in range(count)]
        pad_to = batches[0][-1]
        self._tail_res = None
        tail = self._tail_device_sets()
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from svinet_tpu.parallel.mesh import (
                global_put, make_sharded_svi_multi_step)
            shard = NamedSharding(self._mesh, P(None, "edges"))
            rep = NamedSharding(self._mesh, P())
            st = lambda i, dt, sp: global_put(
                np.stack([b[i] for b in batches]).astype(dt), sp)
            nbs = pad_to // self._nd // self._block
            if nbs not in self._mesh_fns:
                self._mesh_fns[nbs] = make_sharded_svi_multi_step(
                    self._mesh, nbs, cfg.online_iterations,
                    cfg.meanchangethresh, float(cfg.infthresh),
                    nonuniform=self._nonuniform)
            mesh_tail = None
            if tail is not None:
                tp, ty, tw, tnb, _ = tail
                mesh_tail = (tp, ty, tw, tnb, self._tail_eps)
            out = self._mesh_fns[nbs](
                self.gamma, self.lam, st(0, np.int32, shard),
                st(1, np.int32, shard), st(2, np.float32, shard),
                self.alpha, self.eta, st(3, np.float32, rep),
                st(4, np.float32, rep), st(5, np.float32, rep),
                st(6, np.float32, rep), st(7, np.float32, rep),
                self._log_eps_d, count, tail=mesh_tail)
            if mesh_tail is not None:
                self.gamma, self.lam, sums = out
                self._stash_tail(sums)
            else:
                self.gamma, self.lam = out
            return
        stack = lambda i, dt: jnp.asarray(
            np.stack([b[i] for b in batches]).astype(dt))
        if tail is not None:
            tp, ty, tw, tnb, _ = tail
            self.gamma, self.lam, sums = svi_multi_step_ho(
                self.gamma, self.lam, stack(0, np.int32),
                stack(1, np.int32), stack(2, np.float32), self.alpha,
                self.eta, stack(3, np.float32), stack(4, np.float32),
                stack(5, np.float32), stack(6, np.float32),
                stack(7, np.float32), jnp.float32(self.log_eps),
                tp, ty, tw, jnp.float32(cfg.epsilon),
                num_blocks=pad_to // self._block,
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh,
                infthresh=float(cfg.infthresh),
                nonuniform=self._nonuniform, tail_blocks=tnb)
            self._stash_tail(sums)
            return
        self.gamma, self.lam = svi_multi_step(
            self.gamma, self.lam, stack(0, np.int32), stack(1, np.int32),
            stack(2, np.float32), self.alpha, self.eta,
            stack(3, np.float32), stack(4, np.float32),
            stack(5, np.float32), stack(6, np.float32),
            stack(7, np.float32), jnp.float32(self.log_eps),
            num_blocks=pad_to // self._block,
            max_iters=cfg.online_iterations, thresh=cfg.meanchangethresh,
            infthresh=float(cfg.infthresh), nonuniform=self._nonuniform)

    def _step_minibatch(self) -> None:
        self._step_minibatches(1)

    def report(self) -> bool:
        stop = super().report()
        from svinet_tpu.evals.modularity import modularity
        eg, el = self._eval_arrays()
        q, assor = modularity(eg, *self._community_edges(),
                              jnp.asarray(self.network.training_deg,
                                          jnp.float32))
        self._mf.write(f"{self.iteration}\t{self.duration()}\t"
                       f"{float(q):.5f}\t{float(assor):.5f}\n")
        self._mf.flush()
        if self._lf is not None:
            from svinet_tpu.evals.elbo import approx_elbo
            pairs_d, y_d, w_d, nb = self._elbo_pairs()
            s = approx_elbo(eg, el, pairs_d, y_d, w_d,
                            jnp.float32(self.cfg.alpha), self.eta,
                            jnp.float32(self.log_eps), num_blocks=nb,
                            max_iters=self.cfg.online_iterations,
                            thresh=self.cfg.meanchangethresh)
            self._lf.write(f"{self.iteration}\t{self.duration()}\t"
                           f"{float(s):.5f}\n")
            self._lf.flush()
        return stop

    def _elbo_pairs(self):
        if self._elbo_cache is None:
            pairs, y = self._all_training_pairs()
            pp, mask = pad_edges(pairs, self._block)
            yy = np.zeros(len(pp), np.int32)
            yy[: len(y)] = y
            self._elbo_cache = (jnp.asarray(pp), jnp.asarray(yy),
                                jnp.asarray(mask), len(pp) // self._block)
        return self._elbo_cache

    def infer(self) -> None:
        cfg = self.cfg
        r = max(cfg.reportfreq, 1)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            # fuse every step up to the next report boundary into one
            # device call (reports fire when iteration becomes a multiple
            # of r after stepping)
            todo = r - (self.iteration % r)
            if cfg.max_iterations:
                todo = min(todo, cfg.max_iterations - self.iteration + 1)
            self._step_minibatches(todo)
            self.iteration += todo
            if self.iteration % r == 0:
                if self.report():
                    self.do_on_stop()
                    return

    # ------------------------------------------------------------------
    def _all_training_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """All p<q pairs minus heldout (reference: src/mmsbinfer.cc:852-864).
        Host-enumerated once; practical for batch-mode-sized graphs."""
        n = self.n
        iu = np.triu_indices(n, k=1)
        lo = iu[0].astype(np.int64)
        hi = iu[1].astype(np.int64)
        ok = self._edge_ok(lo, hi)
        lo, hi = lo[ok], hi[ok]
        return (np.stack([lo, hi], 1).astype(np.int32), self._y_of(lo, hi))

    def batch_infer(self) -> None:
        cfg = self.cfg
        pairs, y = self._all_training_pairs()
        pt = self._pad_to(len(pairs))
        pp = np.zeros((pt, 2), np.int32)
        yy = np.zeros(pt, np.int32)
        mask = np.zeros(pt, np.float32)
        pp[:len(pairs)] = pairs
        yy[:len(y)] = y
        mask[:len(pairs)] = 1.0
        tail = self._tail_device_sets()
        if self._mesh is not None:
            # all-pairs set sharded across the mesh; one psum per pass
            from jax.sharding import NamedSharding, PartitionSpec as P
            from svinet_tpu.parallel.mesh import (
                global_put, make_sharded_batch_step)
            shard = NamedSharding(self._mesh, P("edges"))
            pairs_d = global_put(pp, shard)
            y_d = global_put(yy, shard)
            w_d = global_put(mask, shard)
            step = make_sharded_batch_step(
                self._mesh, pt // self._nd // self._block,
                cfg.online_iterations, cfg.meanchangethresh)
            from svinet_tpu.parallel.mesh import device_put_replicated
            do_lambda, = device_put_replicated(
                self._mesh, jnp.float32(0.0 if cfg.nolambda else 1.0))
            mesh_tail = (None if tail is None else
                         (tail[0], tail[1], tail[2], tail[3],
                          self._tail_eps))
            sharded_step = lambda g, l, t: step(
                g, l, pairs_d, y_d, w_d, self.alpha, self.eta,
                do_lambda, self._log_eps_d,
                tail=(mesh_tail if t else None))
        else:
            pairs_d = jnp.asarray(pp)
            y_d = jnp.asarray(yy)
            w_d = jnp.asarray(mask)
            nb = pt // self._block
            do_lambda = jnp.float32(0.0 if cfg.nolambda else 1.0)

            def sharded_step(g, l, t):
                if t and tail is not None:
                    tp, ty, tw, tnb, _ = tail
                    return batch_step_ho(
                        g, l, pairs_d, y_d, w_d, self.alpha, self.eta,
                        do_lambda, jnp.float32(self.log_eps), tp, ty, tw,
                        jnp.float32(cfg.epsilon), num_blocks=nb,
                        max_iters=cfg.online_iterations,
                        thresh=cfg.meanchangethresh, tail_blocks=tnb)
                return batch_step(
                    g, l, pairs_d, y_d, w_d, self.alpha, self.eta,
                    do_lambda, jnp.float32(self.log_eps), num_blocks=nb,
                    max_iters=cfg.online_iterations,
                    thresh=cfg.meanchangethresh)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            self._tail_res = None
            # the eval tail rides only the report-boundary pass
            at_report = (self.iteration + 1) % cfg.reportfreq == 0
            out = sharded_step(self.gamma, self.lam,
                               at_report and tail is not None)
            if at_report and tail is not None:
                self.gamma, self.lam, sums = out
                self._stash_tail(sums)
            else:
                self.gamma, self.lam = out
            self.iteration += 1
            if self.iteration % cfg.reportfreq == 0:
                if self.report():
                    self.do_on_stop()
                    return
